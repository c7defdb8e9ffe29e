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
analog is kernels/snapshot_copy. Snapshots are device tensors.

With several analytical islands the scan plane reads `ShardedView`s: each
pinned version is sharded once, at its first pinned scan read, and shared
by every later group pinning it; a Phase-2 swap or GC invalidates unpinned
views. Islands stacked on one device share one installed column, so the
swap is the one-island pointer swap and all islands see the new round at
once. Islands on their own devices (the mesh placement) apply per island:
`on_update_shards` swaps in the complete shard set or nothing, installs
the shards, already on their islands' devices, as the next pinned read's
`MeshView` (Phase-2 residency), and keeps their concatenation on the
replica's device as the column.
"""

from __future__ import annotations

import dataclasses
import itertools

from repro_torch.core.backend import get_backend
from repro_torch.core.dsm import (DSMReplica, EncodedColumn, MeshView,
                                  ShardedView, check_shard_set,
                                  concat_columns)
from repro_torch.core.hwmodel import CostLog
from repro_torch.core.schema import VALUE_BYTES


@dataclasses.dataclass
class _Version:
    version_id: int
    column: EncodedColumn
    readers: int = 0
    # the islands' resident shards of this version, made at the first
    # pinned scan read (`read_scan`) and shared by every later group
    # pinning it; invalidated when the version is garbage-collected or
    # swapped out unpinned
    view: ShardedView | MeshView | None = None

    def drop_view(self, reason: str) -> None:
        if self.view is not None:
            self.view.invalidate(reason)
            self.view = None


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
                v.drop_view(f"snapshot {v.version_id} of column "
                            f"{self.col_id} was garbage-collected")
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
        self.views_built = 0
        self.views_shared = 0
        self.views_resident = 0
        # Phase-2 residency (mesh placement): the freshly applied per-island
        # shards, installed on their islands' devices by `on_update_shards`
        # and adopted by the next pinned `read_scan`, so mesh islands keep
        # their shards resident across rounds instead of re-sharding the
        # concatenated column. One pending view per column; superseded by
        # the next swap.
        self._resident: dict[int, MeshView] = {}

    # -- transactional side ----------------------------------------------
    def on_update(self, col_id: int, new_col: EncodedColumn) -> None:
        """Phase-2 pointer swap: install the new column, mark dirty.

        The swap invalidates every *unpinned* ShardedView of this column's
        snapshots (using one afterwards is a hard StaleShardedViewError).
        Snapshots and views still pinned by in-flight queries stay valid -
        that is snapshot isolation - until their readers finish and GC
        drops the version."""
        self.replica.columns[col_id] = new_col
        self.chains[col_id].dirty = True
        self._resident.pop(col_id, None)  # superseded before adoption
        for v in self.chains[col_id].versions:
            if v.readers == 0:
                v.drop_view(f"column {col_id} was swapped out by a Phase-2 "
                            f"update (now at version {new_col.version})")

    def on_update_shards(self, col_id: int,
                         shard_cols: list[EncodedColumn]) -> None:
        """Phase-2 pointer swap for the mesh's per-island apply, all or none.

        A round's apply produces one shard column per island; queries must
        never see some islands at the new round and others at the old. So
        the complete set is checked first - one shard per island, one
        dictionary and version, sizes of the row partition - before
        anything is installed: on a failure the replica is untouched. Then
        the shards' concatenation, on the replica's device, is swapped in
        as the column, and the shards themselves, already on their islands'
        devices, become the view the next pinned read adopts.
        """
        expected = self.backend.n_shards
        if len(shard_cols) != expected:
            raise ValueError(
                f"partial shard set for column {col_id}: got "
                f"{len(shard_cols)} shards, backend has {expected} islands")
        check_shard_set(shard_cols)          # rejects mixed-round shards
        self.on_update(col_id, concat_columns(
            shard_cols, device=self.replica.columns[col_id].device))
        place = getattr(self.backend, "place_shards", None)
        if place is not None:
            self._resident[col_id] = place(shard_cols)

    def rebind_backend(self, backend) -> None:
        """Re-point the snapshot plane at a resized backend (elastic
        resharding, core/elastic.py) - all or none, like the Phase-2 swap.

        Every *unpinned* view of every chain is invalidated in one pass (a
        view partitioned for the old islands must never serve another scan
        - using one is a hard StaleShardedViewError, never a silently
        mis-sharded read), pending residency installs are dropped, and the
        new backend takes over snapshot, shard and placement duties. The
        replica columns and the snapshot chains themselves are untouched:
        the next pinned `read_scan` shards the pinned version under the new
        partition. Refuses to run with pinned queries in flight - a resize
        happens between query batches, where `_handles` is empty.
        """
        if self._handles:
            raise RuntimeError(
                f"cannot rebind the consistency backend with "
                f"{len(self._handles)} pinned query handle(s) in flight; "
                "finish the query batch first")
        new_be = get_backend(backend)
        old_n, new_n = self.backend.n_shards, new_be.n_shards
        for chain in self.chains.values():
            for v in chain.versions:
                v.drop_view(
                    f"column {chain.col_id}'s analytical islands were "
                    f"resized ({old_n} -> {new_n} shards); re-pin to scan "
                    "the new partition")
        self._resident.clear()
        self.backend = new_be

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

    def read_scan(self, handle: int, col_id: int):
        """Pinned read for the scan plane: shard at pin, once per round.

        On an island backend this returns the pinned version's resident
        view (`ShardedView`, or `MeshView` on the mesh placement, even with
        one island), made at its first access and reused by every later
        group pinning the same version. On the mesh a view installed by the
        Phase-2 swap of the pinned version is adopted instead of made
        (counted in ``views_resident``). On a single-replica backend it is
        `read` (the plain pinned column).
        """
        v = self._handles[handle][col_id]
        if self.backend.n_shards <= 1 and self.backend.placement != "mesh":
            return v.column
        if v.view is None or v.view.stale:
            resident = self._resident.pop(col_id, None)
            if (resident is not None and not resident.stale
                    and resident.version == v.column.version):
                # the islands' devices already hold these shards
                resident.snapshot_id = v.version_id
                v.view = resident
                self.views_resident += 1
            else:
                v.view = self.backend.shard_view(v.column,
                                                 snapshot_id=v.version_id)
                self.views_built += 1
        else:
            self.views_shared += 1
        return v.view

    def pin_scan_group(self, col_sets: list[list[int]]
                       ) -> tuple[list[int], dict]:
        """Pin one snapshot handle per query of a fused same-column-set
        group and return the group's shared scan view (`read_scan`).

        Every query still pins its own handle (reader counts drive GC
        exactly as with per-query `begin_query` calls), but because no
        update lands between the pins, all handles resolve to the same
        snapshot versions. Returns ``(handles, {col_id: column or
        ShardedView})``; callers must `end_query` every handle when the
        group finishes.
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
