"""Task scheduler (§7.2): pull-based, fine-grained, work-stealing.

Basic heuristic: static compile-time task generation (one operator instance
per vault-group partition), push-based assignment by a runtime component
(which preempts a PIM thread), tasks usable only inside the owning group.

Optimized heuristic: 1000-tuple segments -> many fine tasks; per-vault local
task queues; PIM threads PULL their next task; an idle thread steals from
sibling vaults in its own group first (the dictionary is replicated in its
vault — only the column partition is remote) and then from remote groups
(every access remote).

This module is a deterministic discrete-event simulator of that thread pool
(the paper's Fig. 9 study). Durations come from the hardware model
(hwmodel.py), priced on the paper's HMC parameters; nothing here runs on
the GPU.
"""

from __future__ import annotations

import dataclasses
import heapq

from repro_torch.core.hwmodel import HardwareParams
from repro_torch.core.placement import Placement

SEGMENT_ROWS = 1000  # paper: fixed-size 1000-tuple segments


@dataclasses.dataclass
class Task:
    task_id: int
    query_id: int
    group: int            # owning vault group (where the segment lives)
    vault: int            # owning vault within the system
    seconds_local: float  # duration if run by a thread co-located with the data


@dataclasses.dataclass
class SchedResult:
    makespan: float
    busy: list[float]          # per-worker busy seconds
    stolen_group: int          # steals from sibling vaults (same group)
    stolen_remote: int         # steals from remote groups
    runtime_overhead: float

    @property
    def utilization(self) -> float:
        if self.makespan <= 0:
            return 1.0
        return sum(self.busy) / (len(self.busy) * self.makespan)


def make_tasks(
    query_rows: list[tuple[int, int, float]],
    placement: Placement,
    hw: HardwareParams,
    bytes_per_row: float,
    fine_grained: bool = True,
    cycles_per_row: float = 4.0,
) -> list[Task]:
    """Generate tasks for queries.

    query_rows: list of (query_id, col_id, n_rows) scans.
    Coarse mode: one task per (query, PIM thread of the owning group).
    Fine mode:   one task per 1000-row segment.
    Duration of a segment executed locally: roofline of segment bytes over
    one vault's bandwidth share and segment cycles over one PIM core.
    """
    tasks: list[Task] = []
    tid = 0
    threads_per_group = placement.vaults_per_group * hw.pim_cores_per_vault
    for (qid, col, n_rows) in query_rows:
        g = placement.column_group(col)
        vaults = list(placement.column_vaults(col))
        seg = SEGMENT_ROWS if fine_grained else max(1, int(n_rows) // threads_per_group)
        n_segs = max(1, (int(n_rows) + seg - 1) // seg)
        for s in range(n_segs):
            rows = min(seg, int(n_rows) - s * seg)
            t_mem = rows * bytes_per_row / hw.vault_bw
            t_cpu = rows * cycles_per_row / (hw.pim_freq * hw.pim_ipc)
            vault = int(vaults[s % len(vaults)])  # partition striped over the group
            tasks.append(Task(tid, qid, g, vault, max(t_mem, t_cpu)))
            tid += 1
    return tasks


def simulate(
    tasks: list[Task],
    placement: Placement,
    hw: HardwareParams,
    policy: str = "pull_steal",
    group_steal_penalty: float = 1.15,   # column partition remote, dict local
    remote_steal_penalty: float = 2.0,   # everything remote (§7.2 last note)
    runtime_core_fraction: float = 1.0,  # push runtime fully consumes one thread
) -> SchedResult:
    """Discrete-event simulation of the PIM thread pool.

    policy: "static_push" (basic heuristic) | "pull" | "pull_steal" (optimized).
    """
    n_vaults = placement.n_vaults
    cpv = hw.pim_cores_per_vault
    vpg = placement.vaults_per_group
    n_workers = n_vaults * cpv
    queues: list[list[Task]] = [[] for _ in range(n_vaults)]
    for t in tasks:
        queues[t.vault % n_vaults].append(t)
    for q in queues:
        q.reverse()  # pop() yields FIFO order

    busy = [0.0] * n_workers
    stolen_group = stolen_remote = 0
    overhead = 0.0

    def group_of_vault(v: int) -> int:
        return v // vpg

    if policy == "static_push":
        # Runtime monitor occupies one PIM thread globally; each vault's
        # tasks are assigned round-robin to that vault's remaining threads;
        # no stealing. Coarse tasks + static mapping -> imbalance.
        finish = [0.0] * n_workers
        for v in range(n_vaults):
            workers = [v * cpv + i for i in range(cpv)]
            if v == 0:
                workers = workers[1:] or workers  # thread 0 runs the runtime
            for i, t in enumerate(reversed(queues[v])):
                w = workers[i % len(workers)]
                finish[w] += t.seconds_local
                busy[w] += t.seconds_local
        overhead = sum(t.seconds_local for t in tasks) * 0.02  # queue mgmt
        return SchedResult(max(finish) + overhead if finish else 0.0, busy,
                           0, 0, overhead)

    # Pull-based event loop.
    heap = [(0.0, w) for w in range(n_workers)]
    heapq.heapify(heap)
    makespan = 0.0
    while heap:
        now, w = heapq.heappop(heap)
        v = w // cpv
        g = group_of_vault(v)
        task, penalty = None, 1.0
        if queues[v]:
            task = queues[v].pop()
        elif policy == "pull_steal":
            # 1) sibling vaults in own group (dictionary is local to us)
            sibs = [x for x in range(g * vpg, min((g + 1) * vpg, n_vaults)) if x != v]
            sibs.sort(key=lambda x: -len(queues[x]))
            for d in sibs:
                if queues[d]:
                    task = queues[d].pop()
                    penalty = group_steal_penalty
                    stolen_group += 1
                    break
            # 2) remote groups
            if task is None:
                donors = sorted(range(n_vaults), key=lambda x: -len(queues[x]))
                for d in donors:
                    if queues[d]:
                        task = queues[d].pop()
                        penalty = remote_steal_penalty
                        stolen_remote += 1
                        break
        if task is None:
            makespan = max(makespan, now)
            continue
        dur = task.seconds_local * penalty
        busy[w] += dur
        heapq.heappush(heap, (now + dur, w))
    return SchedResult(makespan, busy, stolen_group, stolen_remote, overhead)
