"""Polynesia's consistency mechanism (§6): column-grain snapshot chains.

Key ideas reproduced exactly:
  * snapshot chains are per *column*, not per tuple (unlike MVCC),
  * lazy (late-materialization) snapshotting: updates only mark a column
    dirty; a snapshot is created when an analytical query arrives AND the
    column is dirty AND no current snapshot exists (snapshot sharing),
  * analytics read the chain head frozen at query start - no chain
    traversal, no timestamp comparisons,
  * GC: when a query finishes, snapshots with no readers are deleted
    (except the chain head),
  * updates always go straight to the main replica via the two-phase
    update application (Phase 2 = atomic pointer swap, here a functional
    replacement), so freshness never waits on readers.

The copy unit (multiple fetch/writeback engines + hash-indexed tracking
buffer) is priced as vault-local bandwidth (`resource="copy"`); the kernel
analog is kernels/snapshot_copy. Snapshots are device tensors. The sharded
snapshot plane (`ShardedView`, `on_update_shards`, `rebind_backend`) comes
with the stacked islands (ROADMAP.md queue 1).
"""

from __future__ import annotations

import dataclasses
import itertools

from repro_torch.core.backend import get_backend
from repro_torch.core.dsm import DSMReplica, EncodedColumn
from repro_torch.core.hwmodel import CostLog
from repro_torch.core.schema import VALUE_BYTES


@dataclasses.dataclass
class _Version:
    version_id: int
    column: EncodedColumn
    readers: int = 0


class SnapshotChain:
    """Chain of column versions; head = most recent snapshot."""

    def __init__(self, col_id: int):
        self.col_id = col_id
        self.versions: list[_Version] = []
        self.dirty = True  # no snapshot exists yet

    @property
    def head(self) -> _Version | None:
        return self.versions[-1] if self.versions else None

    def gc(self) -> int:
        """Drop versions with no readers, keeping the chain head. Returns #freed.

        Ordering: the head survives unconditionally (it is the share target
        for the next query), every older version survives only while
        pinned, and the kept versions are re-sorted by version id so the
        chain stays oldest-to-newest - `head` must remain the most recent
        snapshot regardless of the order readers finished in.
        """
        keep = self.versions[-1:]
        freed = 0
        for v in self.versions[:-1]:
            if v.readers > 0:
                keep.append(v)
            else:
                freed += 1
        keep.sort(key=lambda v: v.version_id)
        self.versions = keep
        return freed


class ConsistencyManager:
    """Snapshot-isolation for analytics over a DSMReplica (§6)."""

    def __init__(self, replica: DSMReplica, cost: CostLog | None = None,
                 on_pim: bool = True, backend=None):
        self.replica = replica
        self.cost = cost
        self.on_pim = on_pim
        self.backend = get_backend(backend)
        self.chains = {c: SnapshotChain(c) for c in replica.columns}
        self._version_ids = itertools.count()
        self._handles: dict[int, dict[int, _Version]] = {}
        self._handle_ids = itertools.count()
        self.snapshots_created = 0
        self.snapshots_shared = 0

    # -- transactional side ----------------------------------------------
    def on_update(self, col_id: int, new_col: EncodedColumn) -> None:
        """Phase-2 pointer swap: install the new column, mark dirty.

        Snapshots still pinned by in-flight queries stay valid - that is
        snapshot isolation - until their readers finish and GC drops the
        version."""
        self.replica.columns[col_id] = new_col
        self.chains[col_id].dirty = True

    # -- analytical side ---------------------------------------------------
    def _snapshot(self, col_id: int) -> _Version:
        col = self.replica.columns[col_id]
        # Copy-unit snapshot on the execution backend: the TorchBackend
        # aliases (installed columns are never written in place, so
        # aliasing IS a consistent snapshot), the HopperBackend streams the
        # codes through the kernels/snapshot_copy copy unit, carrying
        # chunks that are clean relative to the previous chain head. Either
        # way the copy the hardware would do is priced below and the chain
        # is bumped.
        head = self.chains[col_id].head
        snap = self.backend.snapshot_column(
            col, prev=head.column if head is not None else None)
        v = _Version(version_id=next(self._version_ids), column=snap)
        self.chains[col_id].versions.append(v)
        self.chains[col_id].dirty = False
        self.snapshots_created += 1
        if self.cost is not None:
            nbytes = col.encoded_bytes + col.dict_size * VALUE_BYTES
            # timeline metadata: snapshot volume on this node (one call per
            # pinned dirty column, hence the accumulating annotate)
            self.cost.annotate_add(n_snapshots=1, snapshot_bytes=2 * nbytes)
            if self.on_pim:
                self.cost.add(phase="snapshot", island="ana", resource="copy",
                              bytes_local=2 * nbytes)
            else:
                self.cost.add(phase="snapshot", island="txn", resource="cpu",
                              cycles=nbytes * 0.5, bytes_offchip=2 * nbytes)
        return v

    def begin_query(self, col_ids: list[int]) -> int:
        """Pin a consistent snapshot of the given columns; returns a handle."""
        pinned: dict[int, _Version] = {}
        for c in col_ids:
            chain = self.chains[c]
            if chain.dirty or chain.head is None:
                v = self._snapshot(c)
            else:
                v = chain.head
                self.snapshots_shared += 1
            v.readers += 1
            pinned[c] = v
        h = next(self._handle_ids)
        self._handles[h] = pinned
        return h

    def read(self, handle: int, col_id: int) -> EncodedColumn:
        """Read the pinned version - O(1), no chain traversal (vs MVCC)."""
        return self._handles[handle][col_id].column

    def read_scan(self, handle: int, col_id: int) -> EncodedColumn:
        """Pinned read for the scan plane. On a single-replica backend it
        is `read` (the plain pinned column)."""
        return self._handles[handle][col_id].column

    def pin_scan_group(self, col_sets: list[list[int]]
                       ) -> tuple[list[int], dict]:
        """Pin one snapshot handle per query of a fused same-column-set
        group and return the group's shared scan view.

        Every query still pins its own handle (reader counts drive GC
        exactly as with per-query `begin_query` calls), but because no
        update lands between the pins, all handles resolve to the same
        snapshot versions. Returns ``(handles, {col_id: column})``; callers
        must `end_query` every handle when the group finishes.
        """
        handles = [self.begin_query(cols) for cols in col_sets]
        view = {c: self.read_scan(handles[0], c) for c in col_sets[0]}
        return handles, view

    def end_query(self, handle: int) -> None:
        pinned = self._handles.pop(handle)
        for c, v in pinned.items():
            v.readers -= 1
            self.chains[c].gc()

    # -- stats -------------------------------------------------------------
    def chain_lengths(self) -> dict[int, int]:
        return {c: len(ch.versions) for c, ch in self.chains.items()}
