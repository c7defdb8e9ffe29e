"""Session-based HTAP API: `SystemSpec` presets + incremental `HTAPSession`.

Polynesia's contract (§4-§6) is an *open* system - transactions stream into
the txn island while update propagation, consistency and analytics proceed
concurrently. This module is that contract as an API:

* `SystemSpec` - one frozen config object naming a system composition
  (placement flags, hardware parameters, execution backend, timing model).
  The eight named presets reproduce the paper's six systems and two
  normalization baselines:

      SystemSpec.polynesia()   SystemSpec.pim_only()
      SystemSpec.mi_sw()       SystemSpec.si_ss()
      SystemSpec.mi_sw_hb()    SystemSpec.si_mvcc()
      SystemSpec.ideal_txn()   SystemSpec.ana_only()

* `HTAPSession` - the long-lived incremental surface over one spec:

      session = HTAPSession(SystemSpec.polynesia(), table)   # on the GPU
      session.execute(txn_chunk)        # any contiguous commit-order chunk
      answers = session.query_batch(qs) # fused same-column-set groups
      a = session.query(q)              # single query
      session.advance_round()           # explicit round boundary
      result = session.finish()         # -> htap.RunResult

The transactional island (row store, per-thread update logs) is the host;
the analytical island's DSM replica and its snapshots live on `device`.
Several analytical islands (``n_shards=N`` or ``backend="hopper@N"``) are
stacked on that one device: each owns a row-wise shard of every pinned
column (a stacked view, made once per pinned version), updates apply to
the column the islands share and swap in one step, and every query group
scans all islands in one launch. On the mesh placement
(``backend="hopper@N/mesh"`` or ``placement="mesh"``, island devices from
``devices=``, default ``cuda:0 .. cuda:N-1``) island *s* lives on its own
device: each island applies its own rows there, the swap installs the
complete shard set as the next round's resident view, and a query group
is one scan launch per device over its islands with the partials added on
island 0's device, which also holds the replica. Answers depend only on the
*visibility points* (which updates executed before each query), so any
sub-chunking of the txn stream between two query batches, the island
count and the placement are answer-neutral.

``delta_store=True`` (MI family) switches Phase 2 of update propagation
from the eager column rebuild to the delta store: batches append to
per-column sorted overlays, query groups fold the overlays in as exact
corrections, and a background compaction folds an overlay into its column
every ``delta_capacity`` appended entries.

The single-instance baselines (SI-SS, SI-MVCC) keep the whole table in
one host row store and answer queries over it in numpy: they build no
replica on the device and launch no kernel. ``timing="timeline"`` prices
the session's tagged cost log as a round-by-round event schedule
(core/timeline.py), which also reports freshness and per-query latency;
``async_propagation=True`` (timeline only) stops the txn island from
stalling on update application.

The MI family's lifecycle is elastic (core/elastic.py): `resize_islands`
repartitions the analytical islands at a round boundary (count and
placement; the backlog flushes through the old plane, live overlays are
compacted, the views swap all or none, a mesh target's shards are placed
on its devices at once), `checkpoint` writes the whole session - columns,
overlays, the pending ship backlog, the cost log - into the atomic
checkpoint layout (repro_torch.checkpoint), and `restore` rebuilds it on a
device, optionally onto another spec, to continue bit for bit. A session's
``crash_after_ships`` limit makes its next ship batch raise
`elastic.SessionCrash`; `elastic.run_with_recovery` replays from the last
checkpoint.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from repro_torch.core import elastic, engine
from repro_torch.core.application import (apply_updates, apply_updates_delta,
                                          apply_updates_naive,
                                          apply_updates_shards,
                                          compaction_entries, delta_eligible,
                                          precompute_apply_stages)
from repro_torch.core.backend import ExecutionBackend, get_backend
from repro_torch.core.consistency import ConsistencyManager
from repro_torch.core.dsm import ColumnDelta, DSMReplica, empty_delta
from repro_torch.core.hwmodel import (CostLog, HardwareParams, HB_PARAMS,
                                      HMC_PARAMS)
from repro_torch.core.mvcc import MVCCStore
from repro_torch.core.nsm import RowStore
from repro_torch.core.placement import hybrid
from repro_torch.core.schema import UpdateStream
from repro_torch.core.shipping import ship_updates, FINAL_LOG_CAPACITY
from repro_torch.core.snapshot import SnapshotStore
from repro_torch.core.timeline import resolve_timing
from repro_torch.distributed import (clear_island_mesh, current_island_mesh,
                                     install_island_mesh)
from repro_torch.kernels.common import kernel_launch_counts

# PIM-Only calibration: OLTP on in-order PIM cores pays extra cycles (no OoO
# ILP for pointer-heavy txn code) even though more threads are available.
PIM_TXN_CYCLE_FACTOR = 1.4

# Delta-store compaction trigger: raw overlay entries appended to a column
# before a background compaction folds the overlay into the base (§5.3's
# capacity-triggered maintenance; the overlay stays small enough that the
# query-time corrections stay cheap).
DELTA_CAPACITY_DEFAULT = 4096


def _resolve_delta(spec: "SystemSpec") -> tuple[bool, int]:
    """(enabled, capacity) of a spec: ``delta_store=None`` means off and
    ``delta_capacity=None`` the default (no environment variable is read:
    a run's configuration is in its arguments). Only the MI family has a
    replica to overlay; an explicit ``delta_store=True`` on another kind
    raises in ``SystemSpec.__post_init__``."""
    if spec.kind != "multi_instance":
        return False, DELTA_CAPACITY_DEFAULT
    cap = spec.delta_capacity
    return bool(spec.delta_store), int(
        DELTA_CAPACITY_DEFAULT if cap is None else cap)


class SessionClosedError(RuntimeError):
    """The session was closed (`finish()` or `abort()`): no more traffic.

    Raised by every post-close surface - ``execute``, ``query``,
    ``query_batch``, ``advance_round``, ``flush_updates``, a second
    ``finish()``, ``checkpoint`` and ``resize_islands``. Subclasses
    RuntimeError so existing guards keep working.
    """


# System compositions a spec can name. "multi_instance" covers the MI
# family (MI+SW / MI+SW+HB / PIM-Only / Polynesia - the placement flags
# select which); the others are the single-instance and normalization
# baselines, each with its own storage engine and round semantics.
KINDS = ("multi_instance", "si_ss", "si_mvcc", "ideal_txn", "ana_only")


@dataclasses.dataclass(frozen=True)
class SystemSpec:
    """A complete, immutable HTAP system configuration.

    Every run is `(spec, workload)`. Presets return ready specs; keyword
    overrides refine them, e.g. ``SystemSpec.polynesia(backend="torch")``.
    ``backend=None`` means ``"hopper"``; ``n_shards=None`` the backend
    spec's island count (``"hopper@4"``), else one island;
    ``timing=None`` means ``"phase"``; ``timing="timeline"`` replays the
    cost log as an event schedule, and ``async_propagation=True`` (which
    needs it) drops the txn island's round-boundary stalls on update
    application. ``delta_store`` (MI family only)
    switches Phase 2 to the delta-store overlays, compacted every
    ``delta_capacity`` appended entries (None: `DELTA_CAPACITY_DEFAULT`);
    answers are the eager path's. ``placement="mesh"`` (or a
    ``"name@N/mesh"`` backend) lays island *s* on its own device (the
    session's ``devices``). ``zero_cost_snapshot`` / ``zero_cost_mvcc``
    are the SI baselines' normalization switches (Fig. 1 / Fig. 8): the
    same run, with snapshot creation or version-chain traversal free.
    """

    name: str
    kind: str
    hw: HardwareParams = HMC_PARAMS
    # -- placement flags (multi_instance family) --------------------------
    propagation_on_pim: bool = False
    analytics_on_pim: bool = False
    txn_on_pim: bool = False
    optimized_application: bool = True
    # -- ablation / normalization switches --------------------------------
    shipping_only: bool = False          # zero-cost application (Fig. 2)
    zero_cost_propagation: bool = False  # Fig. 2/7 "Ideal" baseline
    zero_cost_snapshot: bool = False     # SI-SS normalization (Fig. 1/8)
    zero_cost_mvcc: bool = False         # SI-MVCC normalization (Fig. 1/8)
    # -- execution substrate ----------------------------------------------
    backend: str | ExecutionBackend | None = None
    n_shards: int | None = None
    placement: str | None = None
    timing: str | None = None
    async_propagation: bool = False
    # -- delta-store update plane -----------------------------------------
    delta_store: bool | None = None
    delta_capacity: int | None = None

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown system kind {self.kind!r}; "
                             f"have {KINDS}")
        if self.n_shards is not None and int(self.n_shards) < 1:
            raise ValueError(f"n_shards must be >= 1, got {self.n_shards}")
        if self.placement not in (None, "stacked", "mesh"):
            raise ValueError(f"bad placement {self.placement!r}")
        if self.delta_store and self.kind != "multi_instance":
            raise ValueError(
                f"delta_store is a multiple-instance mechanism (there is "
                f"no DSM replica to overlay); kind {self.kind!r} cannot "
                f"enable it")
        if self.delta_capacity is not None and self.delta_capacity <= 0:
            raise ValueError("delta_capacity must be a positive entry count")
        resolve_timing(self.timing)

    def replace(self, **overrides) -> "SystemSpec":
        """A copy with fields overridden (specs are frozen)."""
        return dataclasses.replace(self, **overrides)

    # -- the named presets -------------------------------------------------
    @classmethod
    def polynesia(cls, **kw) -> "SystemSpec":
        """Full system: islands + in-memory accelerators (§4-§7)."""
        return cls(name="Polynesia", kind="multi_instance",
                   propagation_on_pim=True, analytics_on_pim=True
                   ).replace(**kw)

    @classmethod
    def mi_sw(cls, **kw) -> "SystemSpec":
        """Multiple instance, Polynesia's software optimizations, CPU only."""
        return cls(name="MI+SW", kind="multi_instance").replace(**kw)

    @classmethod
    def mi_sw_hb(cls, **kw) -> "SystemSpec":
        """MI+SW on a hypothetical 8x off-chip bandwidth system."""
        return cls(name="MI+SW+HB", kind="multi_instance",
                   hw=HB_PARAMS).replace(**kw)

    @classmethod
    def pim_only(cls, **kw) -> "SystemSpec":
        """Everything on general-purpose PIM cores (txn islands included)."""
        return cls(name="PIM-Only", kind="multi_instance",
                   propagation_on_pim=True, analytics_on_pim=True,
                   txn_on_pim=True).replace(**kw)

    @classmethod
    def si_ss(cls, **kw) -> "SystemSpec":
        """Single instance (NSM), software full-copy snapshots."""
        return cls(name="SI-SS", kind="si_ss").replace(**kw)

    @classmethod
    def si_mvcc(cls, **kw) -> "SystemSpec":
        """Single instance (NSM), MVCC version chains."""
        return cls(name="SI-MVCC", kind="si_mvcc").replace(**kw)

    @classmethod
    def ideal_txn(cls, **kw) -> "SystemSpec":
        """Transactions alone - the txn normalization baseline."""
        return cls(name="Ideal-Txn", kind="ideal_txn").replace(**kw)

    @classmethod
    def ana_only(cls, **kw) -> "SystemSpec":
        """Analytics alone on the multicore CPU over a DSM replica."""
        return cls(name="Ana-Only", kind="ana_only").replace(**kw)


# Preset registry: name -> factory (accepting overrides). The paper's six
# systems first, then the two normalization baselines.
PRESETS: dict[str, Callable[..., SystemSpec]] = {
    "SI-SS": SystemSpec.si_ss,
    "SI-MVCC": SystemSpec.si_mvcc,
    "MI+SW": SystemSpec.mi_sw,
    "MI+SW+HB": SystemSpec.mi_sw_hb,
    "PIM-Only": SystemSpec.pim_only,
    "Polynesia": SystemSpec.polynesia,
}
BASELINE_PRESETS: dict[str, Callable[..., SystemSpec]] = {
    "Ideal-Txn": SystemSpec.ideal_txn,
    "Ana-Only": SystemSpec.ana_only,
}
ALL_PRESETS: dict[str, Callable[..., SystemSpec]] = {**PRESETS,
                                                    **BASELINE_PRESETS}


def resolve_spec(system: str | SystemSpec, **overrides) -> SystemSpec:
    """Preset name or spec -> spec, with keyword overrides applied."""
    if isinstance(system, SystemSpec):
        return system.replace(**overrides) if overrides else system
    factory = ALL_PRESETS.get(system)
    if factory is None:
        raise KeyError(f"unknown system preset {system!r}; "
                       f"have {sorted(ALL_PRESETS)}")
    return factory(**overrides)


def _resolve_islands(backend, n_shards, placement, hw: HardwareParams,
                     device=None, devices=None):
    """Resolve the execution backend (a ShardedBackend when `n_shards` or a
    ``"name@N"`` spec asks for several islands, a MeshBackend on the mesh
    placement) and scale the hardware model to the island count - each
    analytical island brings its own in-memory hardware (§4), so
    `hw.n_ana_islands` follows the shard count unless the caller already
    set it."""
    be = get_backend(backend, device=device, n_shards=n_shards,
                     placement=placement, devices=devices)
    islands = be.n_shards
    if islands > 1 and hw.n_ana_islands == 1:
        hw = dataclasses.replace(hw, n_ana_islands=islands)
    return be, hw


def _cid_span(chunk: UpdateStream) -> tuple[int, int]:
    """(first, last) commit id of a chunk (-1, -1 when empty)."""
    if not len(chunk):
        return -1, -1
    return int(chunk.commit_id[0]), int(chunk.commit_id[-1])


class HTAPSession:
    """One long-lived HTAP system instance accepting incremental traffic.

    The session owns the storage engines of its spec's system kind plus one
    `CostLog`; `finish()` prices the log under the spec's timing model into
    an `htap.RunResult`. Drive it with any interleaving of

    * ``execute(chunk)`` - a contiguous, commit-ordered slice of the
      update stream (chunks must arrive in commit order; empty chunks are
      legal and open a zero-cost txn node),
    * ``query(q)`` / ``query_batch(queries)`` - analytical queries over
      everything executed so far (a batch runs same-column-set queries as
      fused groups, sharing pinned snapshots),
    * ``advance_round()`` - an explicit round boundary: the point where
      synchronous propagation may stall the next round's transactions and
      where SI-MVCC queries refresh their snapshot timestamp.

    Visibility semantics per kind: the MI family applies every pending
    update before answering a batch (end-of-round freshness), SI-SS
    memcpy-snapshots the row store at the batch, SI-MVCC answers at the
    current round's *start* timestamp (concurrent-query staleness, §3.1),
    Ana-Only reads the initial table.

    ``device`` is where the analytical island lives: ``None`` means the
    GPU and raises when CUDA is not available; it never falls back to the
    CPU by itself. On the mesh placement ``devices`` lists the islands'
    devices, island 0's holding the replica (None: the installed island
    devices, else ``cuda:0 .. cuda:N-1``; a list may repeat a device). The
    session installs them as the process's island devices until it
    closes.
    """

    def __init__(self, spec: SystemSpec, table: np.ndarray, device=None,
                 devices=None):
        self.spec = spec
        self.timing = resolve_timing(spec.timing)
        if spec.async_propagation and self.timing != "timeline":
            raise ValueError(
                "async_propagation requires timing='timeline' (the "
                "phase-bucket model has no round boundaries to overlap)")
        self.cost = CostLog()
        self.round = 0
        self.results: list[int] = []
        self.n_txn = 0
        self.n_ana = 0
        self._finished = False
        self._prev_txn: str | None = None   # last txn node (dependency chain)
        self._txn_i = 0                      # txn sub-chunks this round
        self._ana_i = 0                      # per-round query/group counter
        self._snap_i = 0                     # per-round SI-SS snapshot nodes
        self._launches_at_start = kernel_launch_counts()
        kind = spec.kind
        if kind in ("multi_instance", "ana_only"):
            self.be, self.hw = _resolve_islands(spec.backend, spec.n_shards,
                                                spec.placement, spec.hw,
                                                device, devices)
        else:
            # single-instance kinds: resolve once for validation (their
            # scans are host numpy) and pass the resolved object to every
            # query, never re-resolving the spec
            self.be = get_backend(spec.backend, device=device,
                                  n_shards=spec.n_shards,
                                  placement=spec.placement, devices=devices)
            self.hw = spec.hw
        self.device = self.be.device
        self.islands = self.be.n_shards
        self.mesh = self.be.placement == "mesh"
        self._prev_mesh = None
        if self.mesh:
            # the islands' devices become the process's, so ad-hoc
            # get_backend("...@N/mesh") calls land on them; closing the
            # session restores what was installed before
            self._prev_mesh = current_island_mesh()
            install_island_mesh(self.be.devices)
        if kind == "multi_instance":
            self.store = RowStore(table)
            self.replica = DSMReplica.from_table(table, device=self.device)
            self.cons = ConsistencyManager(self.replica, self.cost,
                                           on_pim=spec.analytics_on_pim,
                                           backend=self.be)
            self.placement = hybrid(self.hw.n_vaults * self.hw.n_stacks)
            self.applications = 0
            self._ship_i = 0                       # global ship-batch counter
            self._vis_node: dict[int, str] = {}    # col -> last Phase-2 node
            self._round_prop: list[str] = []       # this round's apply nodes
            self._prev_round_prop: tuple[str, ...] = ()
            self.delta_enabled, self.delta_capacity = _resolve_delta(spec)
            self._deltas: dict[int, ColumnDelta] = {}  # col -> live overlay
            self.delta_appends = 0
            self.compactions = 0
            # elastic lifecycle (core/elastic.py): the resize trail, and
            # the fault-injection limit (None: off; a caller sets it)
            self.resizes: list[dict] = []
            self.crash_after_ships: int | None = None
        elif kind == "si_ss":
            # one host row store, snapshotted whole: no replica on the device
            self.store = RowStore(table)
            self.snap = SnapshotStore(table)
        elif kind == "si_mvcc":
            self.store = MVCCStore(table)
            self._round_ts: int | None = None      # round-start commit id - 1
            self._last_cid = -1                    # newest executed commit id
        elif kind == "ideal_txn":
            self.store = RowStore(table)
        elif kind == "ana_only":
            self._q_i = 0   # global query counter (rounds don't reset it)
            self.replica = DSMReplica.from_table(table, device=self.device)
            view = self.replica.columns
            if self.islands > 1 or self.mesh:
                # shard the read-only replica ONCE: the islands' resident
                # shards for the whole session (no update invalidates them)
                view = {c: self.be.shard_view(col)
                        for c, col in self.replica.columns.items()}
            self._view = view

    # -- lifecycle ---------------------------------------------------------
    def _check_open(self) -> None:
        if self._finished:
            raise SessionClosedError(
                "HTAPSession is finished; start a new session for more "
                "traffic")

    def advance_round(self) -> None:
        """Close the current round and open the next.

        For the MI family this is where synchronous propagation bites: the
        next round's first txn chunk carries ``sync_deps`` on this round's
        Phase-2 applies (dropped under async propagation; the phase model
        ignores them). For SI-MVCC the next round's queries snapshot at the
        next chunk's start timestamp.
        """
        self._check_open()
        self.round += 1
        self._txn_i = 0
        self._ana_i = 0
        self._snap_i = 0
        if self.spec.kind == "multi_instance":
            self._prev_round_prop = tuple(self._round_prop)
            self._round_prop = []
        elif self.spec.kind == "si_mvcc":
            self._round_ts = None

    def _release_mesh(self) -> None:
        """Restore the island devices installed before this session."""
        if not self.mesh:
            return
        if self._prev_mesh is not None:
            install_island_mesh(self._prev_mesh)
        else:
            clear_island_mesh()

    def finish(self) -> "htap.RunResult":  # noqa: F821 (circular import)
        """Price the accumulated cost log -> RunResult (closes the session)."""
        self._check_open()
        self._finished = True
        self._release_mesh()
        from repro_torch.core import htap
        spec = self.spec
        stats: dict = {}
        concurrent = spec.kind not in ("ideal_txn", "ana_only")
        if spec.kind == "multi_instance":
            stats = {"applications": self.applications,
                     "snapshots": self.cons.snapshots_created,
                     "shared": self.cons.snapshots_shared,
                     "islands": self.islands,
                     "placement": self.be.placement,
                     "sharded_views": self.cons.views_built,
                     "views_shared": self.cons.views_shared,
                     "views_resident": self.cons.views_resident}
            if self.delta_enabled:
                stats["delta_appends"] = self.delta_appends
                stats["compactions"] = self.compactions
                stats["delta_live_entries"] = sum(
                    d.n_overlay for d in self._deltas.values())
            if self.resizes:
                stats["resizes"] = [dict(r) for r in self.resizes]
        elif spec.kind == "si_ss":
            stats = {"snapshots": self.snap.snapshots_taken}
        elif spec.kind == "si_mvcc":
            stats = {"versions": self.store.n_versions}
        # CUDA kernel launches per kernel over this session's lifetime
        # (empty on the CPU, where the wrappers run their plain versions)
        now = kernel_launch_counts()
        stats["kernel_launches"] = {
            k: v - self._launches_at_start.get(k, 0) for k, v in now.items()
            if v - self._launches_at_start.get(k, 0)}
        return htap._price(spec.name, self.cost, self.hw, self.timing,
                           self.n_txn, self.n_ana, self.results, stats=stats,
                           async_propagation=spec.async_propagation,
                           concurrent_islands=concurrent)

    def abort(self) -> None:
        """Close the session without pricing (no RunResult). Idempotent; a
        later `finish()` raises `SessionClosedError`."""
        if not self._finished:
            self._release_mesh()
        self._finished = True

    # -- elastic lifecycle (core/elastic.py) -------------------------------
    def resize_islands(self, n_islands: int, placement: str | None = None,
                       devices=None) -> str | None:
        """Online resharding: repartition the analytical islands to
        ``n_islands`` at this round boundary (MI family only; mesh islands
        on ``devices``). Answer-neutral; the rebalance is priced as a
        ``reshard`` node on the fixed-function lane. See
        `core.elastic.resize_islands`."""
        return elastic.resize_islands(self, n_islands, placement=placement,
                                      devices=devices)

    def checkpoint(self, ckpt_dir: str, step: int | None = None) -> int:
        """Serialize the full session state into ``ckpt_dir`` through the
        atomic-commit checkpoint layout. See
        `core.elastic.checkpoint_session`."""
        return elastic.checkpoint_session(self, ckpt_dir, step=step)

    @classmethod
    def restore(cls, ckpt_dir: str, spec: SystemSpec | None = None,
                step: int | None = None, device=None,
                devices=None) -> "HTAPSession":
        """Rebuild a session from the last committed checkpoint on
        ``device`` (None: the GPU), optionally onto a *different* spec
        (backend / island count / placement - the elastic-restart path).
        See `core.elastic.restore_session`."""
        return elastic.restore_session(ckpt_dir, spec=spec, step=step,
                                       device=device, devices=devices)

    # -- transactional surface ---------------------------------------------
    def execute(self, chunk: UpdateStream) -> None:
        """Execute a contiguous commit-ordered chunk of transactions.

        Opens one txn timeline node per call (chained after the previous
        one; the round's first chunk also waits on the previous round's
        propagation under synchronous timing). On the MI family,
        capacity-triggered update shipping runs here: whenever the pending
        updates reach the final log's capacity, a ship batch leaves for
        the analytical island.
        """
        self._check_open()
        kind = self.spec.kind
        if kind == "ana_only":
            raise ValueError("Ana-Only has no transactional island; "
                             "this spec only accepts queries")
        node = (f"r{self.round}:txn" if self._txn_i == 0
                else f"r{self.round}:txn.{self._txn_i}")
        self._txn_i += 1
        lo, hi = _cid_span(chunk)
        deps = (self._prev_txn,) if self._prev_txn else ()
        if kind == "multi_instance":
            sync_deps = self._prev_round_prop if self._txn_i == 1 else ()
            with self.cost.tagged(node, "txn", round=self.round, deps=deps,
                                  sync_deps=sync_deps, n=len(chunk),
                                  cid_lo=lo, cid_hi=hi):
                self._execute_mi(chunk)
        else:
            with self.cost.tagged(node, "txn", round=self.round, deps=deps,
                                  n=len(chunk), cid_lo=lo, cid_hi=hi):
                self.store.execute(chunk, self.cost)
        self._prev_txn = node
        self.n_txn += len(chunk)
        if kind == "si_ss":
            self.snap.data = self.store.data   # single instance: same storage
            if chunk.writes_mask().any():
                self.snap.mark_dirty()
        elif kind == "si_mvcc":
            if self._round_ts is None and len(chunk):
                # queries this round snapshot at the round's start (§3.1):
                # every version the round commits must be hopped over
                self._round_ts = int(chunk.commit_id[0]) - 1
            if len(chunk):
                self._last_cid = int(chunk.commit_id[-1])
        elif kind == "multi_instance":
            # §5: ship when the final log's hardware capacity is reached
            while self.store.pending_updates >= FINAL_LOG_CAPACITY:
                self._ship_once()

    def _execute_mi(self, chunk: UpdateStream) -> None:
        if self.spec.txn_on_pim:
            self.store.execute(chunk)  # functional only; price on PIM:
            n = len(chunk)
            self.cost.add(phase="txn", island="txn", resource="pim_txn",
                          cycles=n * RowStore.CYCLES_PER_TXN
                          * PIM_TXN_CYCLE_FACTOR,
                          bytes_local=n * self.store.n_cols * 4
                          * RowStore.MISS_FRACTION)
        else:
            self.store.execute(chunk, self.cost)

    # -- update propagation (§5, MI family) --------------------------------
    def _ship_once(self) -> None:
        """One ship batch: drain -> merge/locate/ship -> per-column apply.

        The final log is a hardware buffer (§5.1's merge unit): when
        propagation runs on the in-memory units, each batch is at most one
        final log's worth. The software baseline has no such structure and
        ships its whole backlog at once.
        """
        spec = self.spec
        # fault injection (crash_after_ships): the "process" dies before
        # this batch leaves - executed-but-unshipped updates survive only
        # in the row store + logs, which is exactly the state a checkpoint
        # captures and crash recovery replays
        elastic.maybe_crash(self)
        logs = self.store.drain_logs(
            limit=FINAL_LOG_CAPACITY if spec.propagation_on_pim else None)
        ship_node = f"r{self.round}:ship{self._ship_i}"
        self._ship_i += 1
        # in sync timing the batch waits for the txn execution that filled
        # it; async releases it at its last update's commit time
        sync_deps = (self._prev_txn,) if self._prev_txn else ()
        with self.cost.tagged(ship_node, "ship", round=self.round,
                              sync_deps=sync_deps, islands=self.islands):
            buffers = ship_updates(logs, self.store.n_cols, self.cost,
                                   on_pim=spec.propagation_on_pim,
                                   backend=self.be,
                                   price=not spec.zero_cost_propagation)
        # The whole batch's dictionary stages ride one fused dispatch (cost
        # events stay per column below - tags are structural, and the cost
        # model is analytic, not measured). The delta plane skips it:
        # eligible batches never touch the dictionary, and the rare
        # fallback stages its own.
        staged = (precompute_apply_stages(self.replica.columns, buffers,
                                          backend=self.be)
                  if spec.optimized_application and len(buffers) > 1
                  and not self.delta_enabled else {})
        app_cost = (None if (spec.shipping_only
                             or spec.zero_cost_propagation)
                    else self.cost)
        for col_id, entries in buffers.items():
            if self.delta_enabled:
                self._apply_column_delta(col_id, entries, ship_node,
                                         app_cost)
                continue
            apply_node = f"{ship_node}:c{col_id}"
            self._apply_column_eager(col_id, entries, apply_node,
                                     app_cost, staged.get(col_id),
                                     deps=(ship_node,))
            self._vis_node[col_id] = apply_node
            self._round_prop.append(apply_node)
            self.applications += 1

    def _apply_column_eager(self, col_id: int, entries: np.ndarray,
                            node: str, app_cost, staged_col, deps,
                            kind: str = "apply",
                            phase: str = "apply") -> None:
        """One column's batch through the standard two-stage apply (Phase-2
        swap via the consistency manager). Also the compaction executor:
        kind/phase "compact" reuses the same machinery, so the folded base
        is what eager application would have built."""
        spec = self.spec
        old = self.replica.columns[col_id]
        with self.cost.tagged(node, kind, round=self.round, deps=deps,
                              col=col_id, islands=self.islands):
            if spec.optimized_application and self.mesh:
                # each island applies its own rows on its device; the
                # round becomes visible only as a complete shard set
                self.cons.on_update_shards(col_id, apply_updates_shards(
                    old, entries, app_cost,
                    on_pim=spec.propagation_on_pim, backend=self.be,
                    staged=staged_col, phase=phase))
            elif spec.optimized_application:
                self.cons.on_update(col_id, apply_updates(
                    old, entries, app_cost,
                    on_pim=spec.propagation_on_pim, backend=self.be,
                    staged=staged_col, phase=phase))
            else:
                # the naive software baseline rebuilds a whole column
                self.cons.on_update(col_id, apply_updates_naive(
                    old, entries, app_cost, phase=phase))

    def _apply_column_delta(self, col_id: int, entries: np.ndarray,
                            ship_node: str, app_cost) -> None:
        """Delta-plane Phase 2: append the batch to the column's overlay.

        The append is O(batch + overlay) - the base column is untouched -
        so the apply node the next round's transactions wait for is cheap.
        When the overlay's raw entry count reaches the capacity, a
        background compaction node (kind "compact") folds it into the base
        through the standard apply and resets the overlay. A batch with
        inserts (or rows past the base) changes the column's length, which
        the overlay does not model: the overlay is compacted first (commit
        order), then the batch is applied eagerly.
        """
        old = self.replica.columns[col_id]
        delta = self._deltas.get(col_id)
        if delta is None or delta.n_base != old.n_rows:
            delta = empty_delta(old)
        apply_node = f"{ship_node}:c{col_id}"
        if not delta_eligible(entries, old.n_rows):
            deps = (ship_node,)
            if delta.n_overlay:
                comp = self._compact_column(col_id, delta, deps=deps,
                                            ship_node=ship_node)
                deps = (ship_node, comp)
            self._apply_column_eager(col_id, entries, apply_node, app_cost,
                                     None, deps=deps)
            self._deltas[col_id] = empty_delta(self.replica.columns[col_id])
        else:
            with self.cost.tagged(apply_node, "apply", round=self.round,
                                  deps=(ship_node,), col=col_id,
                                  islands=self.islands):
                delta = apply_updates_delta(
                    old, delta, entries, app_cost,
                    on_pim=self.spec.propagation_on_pim, backend=self.be)
            self._deltas[col_id] = delta
            self.delta_appends += 1
        self._vis_node[col_id] = apply_node
        self._round_prop.append(apply_node)
        self.applications += 1
        delta = self._deltas[col_id]
        if delta.n_entries >= self.delta_capacity and delta.n_overlay:
            self._compact_column(col_id, delta, deps=(apply_node,),
                                 ship_node=ship_node)

    def _compact_column(self, col_id: int, delta: ColumnDelta, deps,
                        ship_node: str) -> str:
        """Fold a column's overlay into its base (background compaction).

        Synthesizes the overlay's write/delete entries (commit-id ordered)
        and runs them through the standard apply, so the compacted base
        goes through the usual Phase-2 swap. The node is not added to
        ``_round_prop``: compaction overlaps analytics instead of stalling
        the next round's transactions. Queries still wait for it
        (``_vis_node``) - they read the compacted base.
        """
        spec = self.spec
        app_cost = (None if (spec.shipping_only
                             or spec.zero_cost_propagation)
                    else self.cost)
        node = f"{ship_node}:compact{col_id}"
        self._apply_column_eager(col_id, compaction_entries(delta, col_id),
                                 node, app_cost, None, deps=deps,
                                 kind="compact", phase="compact")
        self._deltas[col_id] = empty_delta(self.replica.columns[col_id])
        self._vis_node[col_id] = node
        self.compactions += 1
        return node

    def flush_updates(self) -> None:
        """Ship and apply the entire pending update backlog now.

        `query_batch` pulls this implicitly (queries must see everything
        executed before them); it is public for callers that want
        propagation *without* analytics. MI family only.
        """
        self._check_open()
        if self.spec.kind != "multi_instance":
            raise ValueError(
                f"flush_updates is a multiple-instance mechanism; "
                f"{self.spec.name!r} is kind {self.spec.kind!r}")
        while self.store.pending_updates:
            self._ship_once()

    # -- analytical surface ------------------------------------------------
    def query(self, q: engine.Query) -> int:
        """Answer one analytical query over the currently visible data."""
        return self.query_batch([q])[0]

    def query_batch(self, queries: list[engine.Query]) -> list[int]:
        """Answer a batch of analytical queries (fused same-column groups).

        An empty batch is a no-op (it does not flush pending updates). On
        the MI family a non-empty batch first drains the remaining update
        backlog - queries see everything executed before them - then runs
        each same-column-set group as one fused multi-query scan over a
        shared pinned snapshot.
        """
        self._check_open()
        queries = list(queries)
        if not queries:
            return []
        kind = self.spec.kind
        if kind == "ideal_txn":
            raise ValueError("Ideal-Txn has no analytical island; "
                             "this spec only accepts transactions")
        answers = {
            "multi_instance": self._query_batch_mi,
            "si_ss": self._query_batch_si_ss,
            "si_mvcc": self._query_batch_si_mvcc,
            "ana_only": self._query_batch_ana_only,
        }[kind](queries)
        self.results.extend(answers)
        self.n_ana += len(queries)
        return answers

    def _query_batch_mi(self, queries) -> list[int]:
        # flush the whole backlog first: a query batch is the §5 trigger
        # that makes every committed update visible (end-of-round contract)
        self.flush_updates()
        batch_results: dict[int, int] = {}
        for group in engine.group_queries(queries):
            g = self._ana_i
            self._ana_i += 1
            cols = group[0].columns
            snap_node = f"r{self.round}:snap{g}"
            snap_deps = tuple(dict.fromkeys(
                self._vis_node[c] for c in cols if c in self._vis_node))
            with self.cost.tagged(snap_node, "snapshot", round=self.round,
                                  deps=snap_deps, islands=self.islands):
                handles, view = self.cons.pin_scan_group(
                    [q.columns for q in group])
            with self.cost.tagged(f"r{self.round}:ana{g}", "ana",
                                  round=self.round, deps=(snap_node,),
                                  islands=self.islands, n=len(group)):
                # delta plane: scans fold each column's live overlay into
                # the pinned base (appends never dirty the snapshot chain,
                # so the pinned base holds the overlay's base rows)
                group_answers = engine.run_query_group_dsm(
                    view, group, self.cost, self.placement,
                    on_pim=self.spec.analytics_on_pim, backend=self.be,
                    deltas=self._deltas if self.delta_enabled else None,
                    base_cols=(self.replica.columns
                               if self.delta_enabled else None))
            for q, a in zip(group, group_answers):
                batch_results[id(q)] = a
            for h in handles:
                self.cons.end_query(h)
        return [batch_results[id(q)] for q in queries]

    def _query_batch_si_ss(self, queries) -> list[int]:
        # the memcpy burns txn-island CPU -> the snapshot node lands in
        # the txn lane, which is exactly the Fig. 1-right stall
        snap_node = (f"r{self.round}:snap" if self._snap_i == 0
                     else f"r{self.round}:snap.{self._snap_i}")
        self._snap_i += 1
        deps = (self._prev_txn,) if self._prev_txn else ()
        with self.cost.tagged(snap_node, "snapshot", round=self.round,
                              deps=deps):
            view = self.snap.take_snapshot_if_needed(
                None if self.spec.zero_cost_snapshot else self.cost)
        answers = []
        for q in queries:
            i = self._ana_i
            self._ana_i += 1
            with self.cost.tagged(f"r{self.round}:ana{i}", "ana",
                                  round=self.round, deps=(snap_node,)):
                answers.append(engine.run_query_nsm(view, q, self.cost,
                                                    backend=self.be))
        return answers

    def _query_batch_si_mvcc(self, queries) -> list[int]:
        # analytics run CONCURRENTLY with this round's transactions: the
        # snapshot timestamp is the round start, so every version committed
        # during the round is "newer" and must be hopped over (§3.1). On
        # the timeline the query nodes therefore depend only on the
        # previous round's txn nodes.
        # a round with no transactions (yet) snapshots at "now": everything
        # committed in earlier rounds is visible, nothing is hopped over
        ts = self._round_ts if self._round_ts is not None else self._last_cid
        hops = not self.spec.zero_cost_mvcc
        deps = ()
        if self.round:
            prev = self._mvcc_prev_round_txn
            if prev is not None:
                deps = (prev,)
        answers = []
        for q in queries:
            i = self._ana_i
            self._ana_i += 1
            with self.cost.tagged(f"r{self.round}:ana{i}", "ana",
                                  round=self.round, deps=deps):
                store = self.store
                fvals, avals, *jvals = [
                    store.read_column_at(c, ts, self.cost, hops)
                    for c in q.columns]
                answers.append(engine.answer_from_values(
                    fvals, avals, jvals[0] if jvals else None, q))
                # scan cycles beyond chain traversal (already priced in
                # read_column_at)
                self.cost.add(phase="ana", island="ana", resource="cpu",
                              cycles=store.base.shape[0]
                              * engine.CPU_CYCLES_PER_ROW)
        return answers

    @property
    def _mvcc_prev_round_txn(self) -> str | None:
        # the last txn node of any PREVIOUS round (queries run concurrently
        # with the current round's transactions, so they never wait on
        # them): when this round already executed chunks, that is the
        # dependency of the round's first chunk; otherwise the chain tail.
        if self._txn_i:
            tag = self.cost.tags[f"r{self.round}:txn"]
            return tag.deps[0] if tag.deps else None
        return self._prev_txn

    def _query_batch_ana_only(self, queries) -> list[int]:
        answers = []
        for q in queries:
            # globally numbered: q{i} node names must stay unique across
            # rounds (advance_round resets only the per-round counters)
            i = self._q_i
            self._q_i += 1
            with self.cost.tagged(f"q{i}:ana", "ana", round=self.round):
                answers.append(engine.run_query_dsm(self._view, q, self.cost,
                                                    on_pim=False,
                                                    backend=self.be))
        return answers
