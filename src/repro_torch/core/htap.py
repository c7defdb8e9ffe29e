"""Batch runners over the session API (§4, §9.1).

Six systems, matching Fig. 6, plus the two normalization baselines - each
is a `SystemSpec` preset (core/session.py):

  SI-SS      single instance (NSM), software snapshotting
  SI-MVCC    single instance (NSM), MVCC version chains
  MI+SW      multiple instance, Polynesia's software optimizations, CPU only
  MI+SW+HB   MI+SW with a hypothetical 8x off-chip bandwidth (256 GB/s)
  PIM-Only   MI+SW run entirely on general-purpose PIM cores
  Polynesia  islands + PIM accelerators + placement + scheduler (full system)
  Ideal-Txn  transactions alone (no analytics, zero-cost propagation)
  Ana-Only   analytics alone on the multicore CPU

`run(system, table, stream, queries)` splits the pre-generated workload
into uniform rounds (core/workload.py) and drives an incremental
`HTAPSession`; `run_mixed_traffic` serves an open arrival schedule
(`workload.mixed_traffic_schedule`) through the same session surface. Each
run executes the workload *functionally* (every system computes real query
answers) while emitting cost events priced by the analytic hardware model
(hwmodel.py).

Timing models (``timing=`` on every spec; None means "phase"):
  "phase"     whole-run phase buckets per island (hwmodel.HardwareModel.time)
  "timeline"  round-by-round discrete-event replay (core/timeline.py): every
              stage of a round is a tagged node in a dependency graph, so
              propagation/snapshot units overlap the query cores and the
              commit-to-visibility freshness metric becomes measurable.
              ``async_propagation=True`` (timeline only) additionally stops
              the txn island from stalling on update application.
Answers are identical across timing models, backends and island counts -
only the pricing changes.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.hwmodel import CostLog, HardwareModel, HardwareParams
from repro_torch.core.session import (ALL_PRESETS, BASELINE_PRESETS,  # noqa: F401
                                      HTAPSession, PIM_TXN_CYCLE_FACTOR,
                                      PRESETS, SystemSpec, resolve_spec)
from repro_torch.core.timeline import query_latencies, simulate_timeline
from repro_torch.core.workload import (arrival_batches, slice_stream,
                                       split_queries, split_stream)


@dataclasses.dataclass
class RunResult:
    name: str
    n_txn: int
    n_ana: int
    txn_seconds: float
    ana_seconds: float
    energy_joules: float
    results: list[int]            # analytical query answers (for equality tests)
    stats: dict = dataclasses.field(default_factory=dict)
    # Commit-to-visibility lag {"mean": s, "max": s, "n_batches": k}; only
    # measurable under timing="timeline" (None under the phase model).
    freshness_seconds: dict | None = None

    @property
    def txn_throughput(self) -> float:
        return self.n_txn / self.txn_seconds if self.txn_seconds > 0 else float("inf")

    @property
    def ana_throughput(self) -> float:
        return self.n_ana / self.ana_seconds if self.ana_seconds > 0 else float("inf")


def _price(name: str, cost: CostLog, hw: HardwareParams, timing: str,
           n_txn: int, n_ana: int, results: list, stats: dict | None = None,
           async_propagation: bool = False,
           concurrent_islands: bool = True) -> RunResult:
    """Price the cost log under the selected timing model -> RunResult.

    "phase": per-island phase-bucket sums. "timeline": discrete-event
    replay. Timeline txn seconds are the txn lane's *completion time*
    (finish of its last node) - round-boundary stalls are exactly the
    throughput loss async propagation removes. Timeline ana seconds stay
    *busy-based* like the phase model (waiting for a snapshot is not query
    work); the end-to-end picture lives in ``stats["timeline"]`` (makespan,
    per-lane finish/busy/utilization), per-query latency percentiles in
    ``stats["latency"]``, and freshness is reported on the result.
    """
    model = HardwareModel(hw)
    stats = dict(stats or {})
    if timing == "timeline":
        tl = simulate_timeline(cost, model,
                               async_propagation=async_propagation,
                               concurrent_islands=concurrent_islands)
        stats["timeline"] = {
            "makespan": tl.makespan,
            "utilization": tl.utilization,
            "lane_busy": tl.lane_busy,
            "lane_finish": tl.lane_finish,
            "async": async_propagation,
        }
        lats = query_latencies(tl)
        if lats:
            # per-query tail latency (snapshot-pin start -> group finish),
            # sampled per query (fused groups weight by their size)
            arr = np.asarray(lats)
            stats["latency"] = {
                "p50": float(np.percentile(arr, 50)),
                "p99": float(np.percentile(arr, 99)),
                "mean": float(arr.mean()),
                "max": float(arr.max()),
                "n_queries": int(arr.size),
            }
        return RunResult(name, n_txn, n_ana,
                         tl.lane_finish.get("txn", 0.0),
                         tl.lane_busy.get("ana", 0.0),
                         model.energy(cost), results, stats=stats,
                         freshness_seconds=tl.freshness)
    t = model.time(cost, concurrent_islands=concurrent_islands)
    # the concurrent fixed-function bucket (ship/apply/snapshot on the
    # analytical island) - exposed so the timeline's makespan can be
    # compared against the full serial phase sum (txn + ana + accel)
    stats["accel_seconds"] = t["accel"]
    return RunResult(name, n_txn, n_ana, t["txn"], t["ana"],
                     model.energy(cost), results, stats=stats)


def run_spec(spec: SystemSpec, table, stream=None, queries=None,
             n_rounds: int = 8, device=None, devices=None) -> RunResult:
    """Run a pre-generated workload through ``spec``'s system.

    Splits the stream/queries into ``n_rounds`` uniform rounds and drives
    an `HTAPSession` on `device` (None = the GPU), its mesh islands on
    `devices` (see `HTAPSession`). The normalization
    baselines ignore the side they don't model (Ideal-Txn takes the whole
    stream in one round; Ana-Only answers each query individually over the
    initial table).
    """
    session = HTAPSession(spec, table, device=device, devices=devices)
    if spec.kind == "ideal_txn":
        session.execute(stream)
        return session.finish()
    if spec.kind == "ana_only":
        for q in list(queries or []):
            session.query(q)
        return session.finish()
    queries = list(queries or [])
    for r, (txn_chunk, q_chunk) in enumerate(
            zip(split_stream(stream, n_rounds),
                split_queries(queries, n_rounds))):
        if r:
            session.advance_round()
        session.execute(txn_chunk)
        session.query_batch(q_chunk)
    return session.finish()


def run(system: str | SystemSpec, table, stream=None, queries=None,
        n_rounds: int = 8, device=None, devices=None,
        **overrides) -> RunResult:
    """Run a preset (by name) or an explicit spec over a batch workload.

    ``overrides`` refine the preset, e.g. ``run("Polynesia", t, s, q,
    backend="torch", n_shards=4)`` (four analytical islands on one device)
    or ``run("Polynesia", t, s, q, backend="hopper@4/mesh",
    devices=["cuda:0", "cuda:1", "cuda:2", "cuda:3"])`` (one per card), or
    ``run("Polynesia", t, s, q, timing="timeline", async_propagation=True)``.
    """
    return run_spec(resolve_spec(system, **overrides), table, stream,
                    queries, n_rounds=n_rounds, device=device,
                    devices=devices)


def run_mixed_traffic(spec: SystemSpec, table, stream, arrivals,
                      device=None, devices=None) -> RunResult:
    """Serve an *open* arrival schedule through ``spec``'s system.

    ``arrivals`` is a `core.workload.mixed_traffic_schedule` result:
    analytical queries from interleaved clients landing at arbitrary
    positions inside the commit stream. The txn stream executes in
    contiguous chunks up to each arrival's position, the arrival batch is
    answered over exactly the data visible there, and every visibility
    point closes a round (the boundary where synchronous propagation may
    stall the next chunk). The session lives on `device` (None = the GPU),
    its mesh islands on `devices` (see `HTAPSession`).
    """
    batches = arrival_batches(arrivals)
    if batches and batches[-1][0] > len(stream):
        # a schedule built for a different n_txn would silently clamp and
        # answer queries over less data than their position promises
        raise ValueError(
            f"arrival position {batches[-1][0]} beyond the stream's "
            f"{len(stream)} commits (schedule built with a different "
            "n_txn?)")
    session = HTAPSession(spec, table, device=device, devices=devices)
    cursor = 0
    for i, (pos, batch) in enumerate(batches):
        if i:
            session.advance_round()
        session.execute(slice_stream(stream, cursor, pos))
        cursor = pos
        session.query_batch([a.query for a in batch])
    if cursor < len(stream):
        if batches:
            session.advance_round()
        session.execute(slice_stream(stream, cursor, len(stream)))
    return session.finish()
