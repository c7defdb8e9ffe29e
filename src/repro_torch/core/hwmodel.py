"""Analytic hardware cost/energy model (paper §8 methodology, gem5 replaced).

The engines execute *functionally* (on the host and on the GPU); what the
paper measured with gem5+DRAMSim2 is priced by an analytic model instead. The
model's parameter sets describe the paper's HMC-like system (Table 1) and
its high-bandwidth variant; nothing here is priced for the card the port
runs on. All throughput comparisons are *ratios* between systems under the
same model, which is the hardware-portable part of the paper's claims.

Model structure
---------------
Engines emit `CostEvent`s (bytes moved per memory level + cycles per compute
resource, tagged with island + phase). For a phase, execution time is the
roofline max of its resource terms; phases serialize unless marked
concurrent. Cross-island interference on shared resources (the off-chip
channel and, for single-instance systems, the CPU cores) is modeled with a
proportional-share contention factor — the mechanism the paper blames for
the 31.3% isolation loss and the snapshotting/MVCC drops (§3.1).

Energy follows the paper's methodology (sum of CPU core, cache, DRAM and
interconnect energy) with per-byte/per-cycle coefficients from public
HMC/CACTI-class numbers; coefficients are estimates and documented here, and
only *relative* energy is reported.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
from collections import defaultdict

GB = 1e9


@dataclasses.dataclass(frozen=True)
class HardwareParams:
    name: str
    # --- memory system (bytes/s) ---
    offchip_bw: float          # CPU <-> memory channel (shared by both islands)
    vault_bw: float            # one vault's slice of internal bandwidth
    n_vaults: int              # per stack
    n_stacks: int = 1
    # Analytical islands (§4, Fig. 5): Polynesia scales analytics out by
    # replicating the analytical island — each gets its own memory stack,
    # PIM cores and fixed-function units, and owns one DSM shard (the
    # ShardedBackend). Island-count scales the ana-side PIM-core rate,
    # copy engines and internal bandwidth (row-partitioned work); the
    # dictionary-stage units (sorter/merge/hash) perform *replicated* work
    # on the shared dictionary, and the shared off-chip channel does NOT
    # multiply — neither gets faster with more islands.
    n_ana_islands: int = 1
    vault_group: int = 4       # Strategy-3 group size (paper §7.1)
    remote_vault_bw_frac: float = 0.5   # vault-to-vault interconnect efficiency
    # --- compute ---
    cpu_cores: int = 4
    cpu_freq: float = 3.0e9
    cpu_ipc: float = 4.0       # effective ops/cycle for OoO 8-wide with stalls
    pim_cores_per_vault: int = 4
    pim_freq: float = 1.4e9
    pim_ipc: float = 1.0       # in-order 2-wide, memory-bound in practice
    pim_txn_threads: int = 4   # latency-class txn threads when OLTP runs on PIM
    # --- fixed-function accelerators (per vault) ---
    sorter_rate: float = 2.8e9   # values/s  (1024-value bitonic @ ~1.4GHz pipelined)
    merge_rate: float = 1.4e9    # entries/s (comparator tree, 1 entry/cycle)
    hash_rate: float = 0.7e9     # lookups/s (4 probe units, ~2 cycles/lookup avg)
    copy_bw_frac: float = 1.0    # copy unit runs at full vault bandwidth
    # Per-launch setup of a fixed-function scan (operator dispatch + LOB/
    # descriptor writes). Charged once per fused query group — and once
    # regardless of island count, because the sharded snapshot plane
    # batches every island into the same launch — so the model reflects
    # the amortization that query batching and shard batching actually buy.
    launch_overhead_s: float = 1e-8
    # --- energy coefficients (J) ---
    e_offchip_byte: float = 60e-12   # off-chip DRAM access incl. channel
    e_internal_byte: float = 8e-12   # TSV/vault-local access
    e_cache_byte: float = 1.2e-12
    e_cpu_cycle: float = 300e-12     # per active core-cycle (OoO, incl. L1/L2)
    e_pim_cycle: float = 25e-12      # Cortex-A7-class in-order core-cycle
    e_accel_cycle: float = 5e-12

    @property
    def internal_bw(self) -> float:
        return self.vault_bw * self.n_vaults * self.n_stacks

    @property
    def cpu_rate(self) -> float:
        return self.cpu_cores * self.cpu_freq * self.cpu_ipc

    @property
    def pim_rate_total(self) -> float:
        return (self.pim_cores_per_vault * self.n_vaults * self.n_stacks
                * self.pim_freq * self.pim_ipc)


# Paper Table 1: 4 GB cube, 16 vaults, 256 GB/s internal, 32 GB/s off-chip.
HMC_PARAMS = HardwareParams(
    name="hmc",
    offchip_bw=32 * GB,
    vault_bw=16 * GB,     # 256 GB/s / 16 vaults
    n_vaults=16,
)

# MI+SW+HB baseline: hypothetical 8x off-chip bandwidth (256 GB/s) CPU system.
HB_PARAMS = dataclasses.replace(HMC_PARAMS, name="hmc_hb", offchip_bw=256 * GB)

@dataclasses.dataclass
class CostEvent:
    """One priced operation. bytes_* are totals; cycles on the named resource."""

    phase: str                  # e.g. "txn", "ana", "ship", "apply", "snapshot"
    island: str                 # "txn" | "ana"
    resource: str               # "cpu" | "pim" | "sorter" | "merge" | "hash" | "copy"
    bytes_offchip: float = 0.0  # crosses the shared CPU<->memory channel
    bytes_local: float = 0.0    # vault-local (PIM side) traffic
    bytes_remote: float = 0.0   # vault-to-vault traffic
    cycles: float = 0.0         # compute cycles on `resource`
    items: float = 0.0          # accelerator work items (values/entries/lookups)
    node: str = ""              # timeline node (TimelineTag) this event belongs to


@dataclasses.dataclass
class TimelineTag:
    """One node of the round-by-round event graph (core/timeline.py).

    Runners open a tag around each stage of a round (txn execution, a ship
    batch, a per-column apply, a snapshot, a query group); every CostEvent
    emitted while the tag is active carries its node id. ``deps`` are hard
    dependencies (data cannot exist earlier); ``sync_deps`` are honored only
    when the txn island stalls on update application (synchronous
    propagation) and are dropped by the async timeline. ``meta`` carries
    emission-site annotations (update counts, commit-id spans) used for the
    commit-to-visibility freshness metric.
    """

    node: str
    kind: str                     # "txn" | "ship" | "apply" | "snapshot" | "ana"
    round: int = -1
    seq: int = -1                 # emission order (assigned by the CostLog)
    deps: tuple[str, ...] = ()
    sync_deps: tuple[str, ...] = ()
    meta: dict = dataclasses.field(default_factory=dict)


class CostLog:
    """Accumulates cost events; merged per (phase, island, resource).

    Also records the dependency-ordered timeline tags (`tagged`) that let
    core/timeline.py replay the log as a discrete-event schedule instead of
    whole-run phase buckets. Tagging is always on and purely additive: the
    phase-bucket pricing (`HardwareModel.time`) ignores it entirely.
    """

    def __init__(self):
        self.events: list[CostEvent] = []
        self.tags: dict[str, TimelineTag] = {}
        self._active_tag: TimelineTag | None = None
        self._seq = itertools.count()

    @contextlib.contextmanager
    def tagged(self, node: str, kind: str, round: int = -1,
               deps: tuple[str, ...] = (), sync_deps: tuple[str, ...] = (),
               **meta):
        """Open a timeline node: events added inside belong to it."""
        if node in self.tags:
            raise ValueError(f"duplicate timeline node {node!r}")
        tag = TimelineTag(node=node, kind=kind, round=round,
                          seq=next(self._seq), deps=tuple(deps),
                          sync_deps=tuple(sync_deps), meta=dict(meta))
        self.tags[node] = tag
        prev, self._active_tag = self._active_tag, tag
        try:
            yield tag
        finally:
            self._active_tag = prev

    def annotate(self, **meta) -> None:
        """Attach metadata to the active timeline node (no-op untagged) —
        how emission sites (shipping, application, consistency) report
        update counts and commit-id spans without knowing about rounds."""
        if self._active_tag is not None:
            self._active_tag.meta.update(meta)

    def annotate_add(self, **meta) -> None:
        """Accumulate numeric metadata on the active timeline node (for
        emission sites that fire several times per node, e.g. one snapshot
        per pinned column)."""
        if self._active_tag is not None:
            m = self._active_tag.meta
            for k, v in meta.items():
                m[k] = m.get(k, 0) + v

    def add(self, **kw) -> None:
        ev = CostEvent(**kw)
        if self._active_tag is not None and not ev.node:
            ev.node = self._active_tag.node
        self.events.append(ev)

    def extend(self, other: "CostLog") -> None:
        self.events.extend(other.events)
        for node, tag in other.tags.items():
            if node in self.tags:
                raise ValueError(f"duplicate timeline node {node!r} in merge")
            self.tags[node] = dataclasses.replace(tag, seq=next(self._seq))

    def totals(self) -> dict:
        t = defaultdict(float)
        for e in self.events:
            t[("bytes_offchip", e.island)] += e.bytes_offchip
            t[("bytes_local", e.island)] += e.bytes_local
            t[("bytes_remote", e.island)] += e.bytes_remote
            t[("cycles", e.island, e.resource)] += e.cycles
            t[("items", e.island, e.resource)] += e.items
        return dict(t)


@dataclasses.dataclass
class PhaseTime:
    phase: str
    seconds: float
    bound: str   # which roofline term dominated


class HardwareModel:
    """Prices CostLogs into time & energy under a HardwareParams."""

    def __init__(self, params: HardwareParams):
        self.p = params

    # ---- per-resource service rates ------------------------------------
    def _resource_rate(self, resource: str) -> float:
        p = self.p
        nv = p.n_vaults * p.n_stacks
        return {
            "cpu": p.cpu_rate,
            "pim": p.pim_rate_total,
            "pim_txn": p.pim_txn_threads * p.pim_freq * p.pim_ipc,
            "sorter": p.sorter_rate * nv,
            "merge": p.merge_rate * nv,
            "hash": p.hash_rate * nv,
            "copy": p.copy_bw_frac * p.internal_bw,  # bytes/s (copy-unit engines)
            "launch": 1.0 / p.launch_overhead_s,     # kernel launches/s
        }[resource]

    def phase_time(self, events: list[CostEvent], offchip_share: float = 1.0,
                   cpu_share: float = 1.0) -> PhaseTime:
        """Roofline time of one phase.

        offchip_share/cpu_share in (0,1]: fraction of the shared resource
        this phase's island receives under contention.
        """
        p = self.p
        by_res = defaultdict(float)
        bytes_off = 0.0
        # Analytical islands replicate the in-memory hardware: ana-island
        # phases see island-scaled PIM-core/copy rates and internal
        # bandwidth for row-PARTITIONED traffic (each island touches only
        # its DSM shard). Dictionary-stage traffic (sorter/merge/hash
        # events) is REPLICATED — every island moves the same shared
        # dictionary locally — so those bytes do not shrink per island.
        # The CPU and the shared off-chip channel never multiply.
        local_part = local_repl = remote_part = remote_repl = 0.0
        items_copy = 0.0
        phase = events[0].phase if events else "?"
        island = events[0].island if events else "?"
        islands = p.n_ana_islands if island == "ana" else 1
        for e in events:
            bytes_off += e.bytes_offchip
            if e.resource in ("sorter", "merge", "hash", "launch"):
                # item-counted units; "launch" is per-launch setup, charged
                # once per fused group and NOT scaled by islands — the
                # vmapped shard batch is one launch however many islands
                # share it
                local_repl += e.bytes_local
                remote_repl += e.bytes_remote
                by_res[e.resource] += e.items
            else:
                local_part += e.bytes_local
                remote_part += e.bytes_remote
                if e.resource == "copy":
                    items_copy += e.bytes_local + e.bytes_remote
                else:
                    by_res[e.resource] += e.cycles
        terms = {
            "offchip": bytes_off / (p.offchip_bw * offchip_share),
            "local": (local_part / islands + local_repl) / p.internal_bw,
            "remote": (remote_part / islands + remote_repl)
            / (p.internal_bw * p.remote_vault_bw_frac),
        }
        if items_copy:
            # copy-unit engines run at copy_bw_frac of vault bandwidth; at
            # frac=1.0 the generic local/remote terms dominate, below 1.0
            # the unit itself becomes the snapshot/ship bound
            terms["copy"] = items_copy / (self._resource_rate("copy")
                                          * islands)
        for res, amount in by_res.items():
            share = cpu_share if res == "cpu" else 1.0
            # Only the PIM query cores partition their work across island
            # shards. The dictionary-stage units (sorter/merge/hash) do
            # *replicated* work — every island sorts/merges the same
            # replicated dictionary, and the final-log merge runs once —
            # so more islands do not shorten those terms.
            scale = islands if res == "pim" else 1.0
            terms[res] = amount / (self._resource_rate(res) * share * scale)
        bound = max(terms, key=terms.get)
        return PhaseTime(phase=phase, seconds=max(terms.values()), bound=bound)

    def offchip_shares(self, log: CostLog,
                       concurrent_islands: bool = True) -> dict:
        """Proportional off-chip channel share per island under contention.

        If the islands' combined demand rate (uncontended bytes/s) exceeds
        the channel, each island receives its proportional share. Shared by
        the phase-bucket pricing (`time`) and the timeline simulator
        (core/timeline.py), so both price an event against the same
        contended channel.
        """
        p = self.p
        phases = defaultdict(list)
        for e in log.events:
            phases[(e.phase, e.island)].append(e)
        island_bytes = defaultdict(float)
        island_time0 = defaultdict(float)
        for (ph, isl), evs in phases.items():
            t = self.phase_time(evs)
            island_time0[isl] += t.seconds
            island_bytes[isl] += sum(e.bytes_offchip for e in evs)
        shares = {"txn": 1.0, "ana": 1.0}
        if concurrent_islands:
            demand = {
                isl: (island_bytes[isl] / island_time0[isl]) if island_time0[isl] > 0 else 0.0
                for isl in island_time0
            }
            total = sum(demand.values())
            if total > p.offchip_bw:
                for isl in demand:
                    shares[isl] = max(demand[isl] / total, 1e-6)
        return shares

    def node_seconds(self, events: list[CostEvent], shares: dict) -> float:
        """Roofline time of one timeline node's events.

        A node may mix islands (e.g. a ship batch's in-memory units plus the
        txn island exposing its logs once over the channel); the island
        groups run concurrently, so the node takes the slowest group.
        """
        by_island = defaultdict(list)
        for e in events:
            by_island[e.island].append(e)
        return max((self.phase_time(evs, offchip_share=shares.get(isl, 1.0))
                    .seconds for isl, evs in by_island.items()), default=0.0)

    def time(self, log: CostLog, concurrent_islands: bool = True) -> dict:
        """Total modeled time with cross-island contention.

        Returns {"txn": s, "ana": s, "phases": [...], "contention": f}.
        Contention: both islands' off-chip demands share the channel
        proportionally; single-instance systems also share CPU cores.
        """
        phases = defaultdict(list)
        for e in log.events:
            phases[(e.phase, e.island)].append(e)
        shares = self.offchip_shares(log, concurrent_islands)

        out_phases: list[PhaseTime] = []
        island_time = defaultdict(float)
        accel_time = 0.0
        for (ph, isl), evs in sorted(phases.items()):
            t = self.phase_time(evs, offchip_share=shares.get(isl, 1.0))
            out_phases.append(PhaseTime(f"{isl}:{ph}", t.seconds, t.bound))
            # Fixed-function units (ship/apply/snapshot on the analytical
            # island) run CONCURRENTLY with the PIM query cores — that is
            # the paper's performance-isolation design (§5/§6 hardware).
            # They bound data freshness, not query throughput.
            if isl == "ana" and ph != "ana":
                accel_time += t.seconds
            else:
                island_time[isl] += t.seconds
        return {
            "txn": island_time.get("txn", 0.0),
            "ana": island_time.get("ana", 0.0),
            "accel": accel_time,
            "phases": out_phases,
            "offchip_share": dict(shares),
        }

    def energy(self, log: CostLog) -> float:
        p = self.p
        e = 0.0
        for ev in log.events:
            e += ev.bytes_offchip * p.e_offchip_byte
            e += (ev.bytes_local + ev.bytes_remote) * p.e_internal_byte
            e += ev.bytes_offchip * p.e_cache_byte  # CPU-side cache traffic
            if ev.resource == "cpu":
                e += ev.cycles * p.e_cpu_cycle
            elif ev.resource == "pim":
                e += ev.cycles * p.e_pim_cycle
            else:
                e += max(ev.cycles, ev.items) * p.e_accel_cycle
        return e
