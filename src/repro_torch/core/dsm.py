"""DSM (column-store) replica with order-preserving dictionary encoding (§5.2, §7.1).

Each column is stored as fixed-width integer codes plus a sorted dictionary
(real value -> code is order-preserving: code order == value order). Range
predicates on values therefore become range predicates on codes without
decoding - the optimization that makes DSM scans fast and update application
hard, which is exactly the tension the paper's update-application unit
resolves.

The replica lives on the analytical island's device: ``codes``, ``valid``
and ``dictionary`` are tensors on ``device`` (the GPU unless a caller asks
for the CPU). A small host copy of a dictionary is made on demand for the
control steps that binary-search it (``host_dictionary``). Tensors of a
column are never written in place once the column is installed: update
application builds new tensors and swaps the column (Phase 2), so a snapshot
may alias them.

Several analytical islands each own a row-wise shard of every column
(`shard_bounds`); a pinned column is sharded once per round into a stacked
`ShardedView` that all islands scan in one launch on one device, or, on the
mesh placement, into a `MeshView` whose island *s* is a flat tensor on its
own device (island device lists: ``repro_torch.distributed``).

The delta store's per-column overlay (`ColumnDelta`) is host numpy, as in
the reference: it is built from the host's ship batches, holds at most a
few thousand rows (the compaction capacity bounds it), and its algebra -
searchsorted, lexsort, last-writer-wins - is small, ordered host work. A
query group reads it through a device copy made once per overlay version
(`ColumnDelta.on`), beside the base rows gathered on the device.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.core.schema import VALUE_BYTES
from repro_torch.distributed.sharding import place_shard_arrays
from repro_torch.kernels.common import resolve_device


@dataclasses.dataclass
class EncodedColumn:
    """Dictionary-encoded column.

    codes:      (n,) int32 - index into `dictionary`
    dictionary: (k,) int32 - sorted distinct values (order-preserving)
    valid:      (n,) bool  - row validity (deletes mark rows invalid)
    version:    int        - bumped by every update application (Phase-2 swap)
    """

    codes: torch.Tensor
    dictionary: torch.Tensor
    valid: torch.Tensor
    version: int = 0
    # host copy of `dictionary` for searchsorted control steps (lazy)
    _host_dict: np.ndarray | None = dataclasses.field(
        default=None, repr=False, compare=False)

    @property
    def device(self) -> torch.device:
        return self.codes.device

    def host_dictionary(self) -> np.ndarray:
        """The dictionary as host numpy (one device-to-host copy, cached;
        callers must treat it as read-only)."""
        if self._host_dict is None:
            self._host_dict = self.dictionary.cpu().numpy()
        return self._host_dict

    # -- properties priced by the cost model ------------------------------
    @property
    def n_rows(self) -> int:
        return int(self.codes.shape[0])

    @property
    def dict_size(self) -> int:
        return int(self.dictionary.shape[0])

    @property
    def bit_width(self) -> int:
        """Fixed-length code width the paper's compression would use."""
        return max(1, math.ceil(math.log2(max(self.dict_size, 2))))

    @property
    def encoded_bytes(self) -> float:
        return self.n_rows * self.bit_width / 8.0

    @property
    def raw_bytes(self) -> float:
        return self.n_rows * VALUE_BYTES


def column_from_numpy(codes, dictionary, valid, version: int = 0,
                      device=None) -> EncodedColumn:
    """Carry one column's state (host arrays, e.g. taken with `np.asarray`
    from another implementation's column) onto `device`."""
    dev = resolve_device(device)
    host_dict = np.ascontiguousarray(np.asarray(dictionary), dtype=np.int32)
    return EncodedColumn(
        codes=torch.from_numpy(np.ascontiguousarray(
            np.asarray(codes), dtype=np.int32)).to(dev),
        dictionary=torch.from_numpy(host_dict).to(dev),
        valid=torch.from_numpy(np.ascontiguousarray(
            np.asarray(valid), dtype=bool)).to(dev),
        version=int(version), _host_dict=host_dict)


def column_to_numpy(col: EncodedColumn):
    """(codes, dictionary, valid, version) as host numpy."""
    return (col.codes.cpu().numpy(), col.dictionary.cpu().numpy(),
            col.valid.cpu().numpy(), col.version)


def encode_column(values: np.ndarray, device=None) -> EncodedColumn:
    """Build the sorted dictionary and encode (order-preserving).

    The unique/inverse pass runs on the host (set-up, once per column);
    the encoded column then lives on `device`."""
    values = np.asarray(values)
    dictionary, codes = np.unique(values, return_inverse=True)
    return column_from_numpy(codes.reshape(-1), dictionary,
                             np.ones(values.shape[0], dtype=bool), 0, device)


def decode_column(col: EncodedColumn) -> torch.Tensor:
    """Decode codes back to real values (gather through the dictionary)."""
    return col.dictionary[col.codes.long()]


def value_range_to_code_range(col: EncodedColumn, lo: int, hi: int):
    """Map a value-range predicate to a code-range predicate (no decode).

    Returns (code_lo, code_hi) such that  lo <= value <= hi  <=>
    code_lo <= code < code_hi. This is the order-preserving-dictionary
    fast path used by the analytical engine's scans.
    """
    dictionary = col.host_dictionary()
    code_lo = int(np.searchsorted(dictionary, lo, side="left"))
    code_hi = int(np.searchsorted(dictionary, hi, side="right"))
    return code_lo, code_hi


@dataclasses.dataclass
class DSMReplica:
    """The analytical island's replica: one EncodedColumn per table column."""

    columns: dict[int, EncodedColumn]

    @classmethod
    def from_table(cls, table: np.ndarray, device=None) -> "DSMReplica":
        dev = resolve_device(device)
        return cls(columns={j: encode_column(table[:, j], dev)
                            for j in range(table.shape[1])})

    def to_table(self) -> np.ndarray:
        cols = [decode_column(self.columns[j]).cpu().numpy()
                for j in sorted(self.columns)]
        return np.stack(cols, axis=1)

    @property
    def n_rows(self) -> int:
        return next(iter(self.columns.values())).n_rows

    @property
    def n_cols(self) -> int:
        return len(self.columns)

    @property
    def encoded_bytes(self) -> float:
        return sum(c.encoded_bytes for c in self.columns.values())


def replica_from_numpy(columns: dict, device=None) -> DSMReplica:
    """``{col_id: (codes, dictionary, valid, version)}`` of host arrays ->
    a replica on `device` (see `column_from_numpy`)."""
    dev = resolve_device(device)
    return DSMReplica(columns={
        int(c): column_from_numpy(codes, dictionary, valid, version, dev)
        for c, (codes, dictionary, valid, version) in columns.items()})


# ---------------------------------------------------------------------------
# Delta store: sorted per-column overlay of not-yet-compacted updates
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ColumnDelta:
    """Sorted row-keyed overlay of updates not yet folded into the base.

    The delta-store update plane appends shipped updates here instead of
    rebuilding the column (no dictionary merge, no re-encode); scans fold
    base + overlay as an exact correction and a background compaction
    folds the overlay into the base column once `n_entries` reaches the
    capacity. One entry per touched row (last-writer-wins within and across
    batches):

    rows:      (d,) int64 sorted unique row ids, all < n_base
    values:    (d,) int32 the row's current raw value - the last written
               value, or the value carried over for delete-only rows
               (deletes keep the row's value, as the eager path keeps a
               deleted row's code)
    valid:     (d,) bool  row validity after the overlayed ops
    cids:      (d,) int64 latest commit id touching the row (compaction
               replays entries in this order)
    n_base:    base-column row count the overlay is relative to
    n_entries: RAW appended entry count since the last compaction - the
               capacity trigger (overlay rows dedupe, work done doesn't)
    """

    rows: np.ndarray
    values: np.ndarray
    valid: np.ndarray
    cids: np.ndarray
    n_base: int
    n_entries: int = 0
    # the overlay's copies on devices, made once each by `on`
    _on: dict = dataclasses.field(default_factory=dict, repr=False,
                                  compare=False)

    @property
    def n_overlay(self) -> int:
        return int(self.rows.shape[0])

    def on(self, device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(rows int64, values int32, valid bool) as tensors on `device`
        (copied once per overlay; an append makes a new overlay)."""
        dev = torch.device(device)
        if dev not in self._on:
            self._on[dev] = tuple(
                torch.from_numpy(np.ascontiguousarray(a, dtype=t)).to(dev)
                for a, t in ((self.rows, np.int64), (self.values, np.int32),
                             (self.valid, bool)))
        return self._on[dev]


def empty_delta(col: EncodedColumn) -> ColumnDelta:
    """Fresh (empty) overlay relative to `col`'s current row count."""
    return ColumnDelta(rows=np.empty(0, dtype=np.int64),
                       values=np.empty(0, dtype=np.int32),
                       valid=np.empty(0, dtype=bool),
                       cids=np.empty(0, dtype=np.int64),
                       n_base=col.n_rows, n_entries=0)


# ---------------------------------------------------------------------------
# Row-wise sharding (§4's multiple analytical islands, one DSM shard each)
# ---------------------------------------------------------------------------

def shard_bounds(n_rows: int, n_shards: int) -> list[int]:
    """Contiguous row partition boundaries: shard s owns [b[s], b[s+1]).

    The split produces at most two distinct shard sizes, differing by one
    row, so the stacked layout pads at most one slot per shard.
    """
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    return [n_rows * s // n_shards for s in range(n_shards + 1)]


def shard_column(col: EncodedColumn, n_shards: int) -> list[EncodedColumn]:
    """Partition a column row-wise into `n_shards` island-local shards.

    Every shard shares the (replicated) dictionary tensor, so codes remain
    comparable across shards and `concat_columns` is an exact inverse. The
    shards' codes and validity are views of the column's tensors; a shard
    may be empty when n_shards > n_rows.
    """
    bounds = shard_bounds(col.n_rows, n_shards)
    return [EncodedColumn(codes=col.codes[lo:hi], dictionary=col.dictionary,
                          valid=col.valid[lo:hi], version=col.version,
                          _host_dict=col._host_dict)
            for lo, hi in zip(bounds, bounds[1:])]


def _check_same_round(shards) -> None:
    """Shards of one column must carry one version and one dictionary:
    mixing shards of different update rounds would decode rows through
    the wrong dictionary."""
    head = shards[0]
    for s in shards[1:]:
        if s.version != head.version:
            raise ValueError(
                f"shard version mismatch: {s.version} != {head.version}")
        if s.dictionary is not head.dictionary and not (
                s.dictionary.shape == head.dictionary.shape
                and torch.equal(s.dictionary,
                                head.dictionary.to(s.dictionary.device))):
            raise ValueError("shard dictionary mismatch (different rounds?)")


def check_shard_set(shards: list[EncodedColumn]) -> list[int]:
    """Validate a complete per-island shard set of one column - one round
    (version and dictionary), sizes of the `shard_bounds` partition - and
    return its bounds. Touches no device state, so a caller can check a
    set before installing any of it."""
    if not shards:
        raise ValueError("a shard set needs at least one shard")
    _check_same_round(shards)
    sizes = [c.n_rows for c in shards]
    bounds = shard_bounds(sum(sizes), len(shards))
    if [hi - lo for lo, hi in zip(bounds, bounds[1:])] != sizes:
        raise ValueError(
            f"shard sizes {sizes} do not match the shard_bounds partition "
            f"of {sum(sizes)} rows over {len(shards)} islands")
    return bounds


def concat_columns(shards: list[EncodedColumn], device=None) -> EncodedColumn:
    """Reassemble shard columns (inverse of `shard_column`) on `device`
    (None: the first shard's); rejects shards of different rounds (version
    or dictionary mismatch). Shards may lie on different devices (mesh
    islands): each is copied to `device` once."""
    if not shards:
        raise ValueError("concat_columns needs at least one shard")
    _check_same_round(shards)
    head = shards[0]
    dev = head.codes.device if device is None else torch.device(device)
    if len(shards) == 1:
        return EncodedColumn(codes=head.codes.to(dev),
                             dictionary=head.dictionary.to(dev),
                             valid=head.valid.to(dev), version=head.version,
                             _host_dict=head._host_dict)
    return EncodedColumn(codes=torch.cat([s.codes.to(dev) for s in shards]),
                         dictionary=head.dictionary.to(dev),
                         valid=torch.cat([s.valid.to(dev) for s in shards]),
                         version=head.version, _host_dict=head._host_dict)


class StaleShardedViewError(RuntimeError):
    """A ShardedView was used after its source column was swapped out.

    The sharded snapshot plane materializes each pinned column's shards
    once per query round; a Phase-2 pointer swap (or snapshot-chain GC)
    invalidates any unpinned view built from the superseded column.
    Staleness is a hard error, never a silently refreshed cache.
    """


class _IslandView:
    """What the islands' two resident layouts share (`ShardedView`,
    `MeshView`): the row partition ``bounds``, the pinned provenance
    (``version``, ``snapshot_id``), staleness, and the properties the cost
    model prices, which are the column's."""

    @property
    def n_shards(self) -> int:
        return len(self.bounds) - 1

    @property
    def n_rows(self) -> int:
        return self.bounds[-1]

    @property
    def sizes(self) -> tuple[int, ...]:
        return tuple(hi - lo for lo, hi in zip(self.bounds, self.bounds[1:]))

    @property
    def dict_size(self) -> int:
        return int(self.dictionary.shape[0])

    @property
    def bit_width(self) -> int:
        return max(1, math.ceil(math.log2(max(self.dict_size, 2))))

    @property
    def encoded_bytes(self) -> float:
        return self.n_rows * self.bit_width / 8.0

    def host_dictionary(self) -> np.ndarray:
        """The dictionary as host numpy (cached; read-only)."""
        if self._host_dict is None:
            self._host_dict = self.dictionary.cpu().numpy()
        return self._host_dict

    @property
    def stale(self) -> bool:
        return self.stale_reason is not None

    def invalidate(self, reason: str) -> None:
        self.stale_reason = reason

    def require_fresh(self) -> None:
        if self.stale_reason is not None:
            raise StaleShardedViewError(
                f"sharded view of column version {self.version} "
                f"(snapshot {self.snapshot_id}) is stale: "
                f"{self.stale_reason}")


@dataclasses.dataclass
class ShardedView(_IslandView):
    """Materialized island-resident shards of one pinned column.

    The column's rows are partitioned by `shard_bounds` and stacked into
    ``(n_shards, width)`` device tensors, so every island is scanned by ONE
    launch over the leading shard axis. Padded slots (at most one per
    shorter shard) carry ``codes=0, valid=False``: the scan identity.

    ``version`` is the source column's update round and ``snapshot_id``
    the consistency snapshot it was pinned from (-1 for ad-hoc views).
    Every reader calls `require_fresh`, so a swapped-out view is a hard
    `StaleShardedViewError`.
    """

    codes: torch.Tensor        # (n_shards, width) int32, padded slots = 0
    valid: torch.Tensor        # (n_shards, width) bool, padded slots = False
    dictionary: torch.Tensor   # replicated across islands
    bounds: tuple[int, ...]    # row partition, len n_shards + 1
    version: int
    snapshot_id: int = -1
    stale_reason: str | None = None
    # join build side, made by `dict_counts` and dying with the view
    _dict_counts: torch.Tensor | None = dataclasses.field(
        default=None, repr=False, compare=False)
    _host_dict: np.ndarray | None = dataclasses.field(
        default=None, repr=False, compare=False)

    @property
    def device(self) -> torch.device:
        return self.codes.device

    @property
    def width(self) -> int:
        return int(self.codes.shape[1])

    def dict_counts(self) -> torch.Tensor:
        """Per-dictionary-value occurrence counts of the view's valid rows,
        across all islands (int64, on the view's device).

        This is a hash join's build side: it depends only on the pinned
        data, so it is computed once per view and reused by every join
        group probing it. Callers must treat it as read-only.
        """
        self.require_fresh()
        if self._dict_counts is None:
            self._dict_counts = torch.bincount(
                self.codes[self.valid].long(),
                minlength=self.dict_size).to(torch.int64)
        return self._dict_counts

    def shard(self, s: int) -> EncodedColumn:
        """One island's resident shard as an (unpadded) EncodedColumn."""
        self.require_fresh()
        size = self.bounds[s + 1] - self.bounds[s]
        return EncodedColumn(codes=self.codes[s, :size],
                             dictionary=self.dictionary,
                             valid=self.valid[s, :size],
                             version=self.version, _host_dict=self._host_dict)

    def to_column(self) -> EncodedColumn:
        """Reassemble the full column (row-order inverse of the shard)."""
        return concat_columns([self.shard(s) for s in range(self.n_shards)])


def replicate(t: torch.Tensor, devices) -> tuple[torch.Tensor, ...]:
    """`t` on each of `devices`, one copy per distinct device (none for
    `t`'s own): the mesh's replicated tensors."""
    copies: dict = {}
    return tuple(copies.setdefault(d, t.to(d)) for d in devices)


@dataclasses.dataclass
class MeshView(_IslandView):
    """One pinned column's island shards on the mesh placement: island *s*
    holds its rows as flat ``(width_s,)`` tensors on its own device
    (``codes[s].device``), unpadded. The dictionary lives on island 0's
    device (the replica's); `island_dicts` replicates it to every island
    once per view, and the join's build side (`dict_counts`, reduced across
    islands) likewise (`island_rcounts`), so a query copies neither.

    Provenance, staleness (`StaleShardedViewError`) and the cost model's
    properties are those of `ShardedView`.
    """

    codes: tuple[torch.Tensor, ...]   # per island (width_s,) int32
    valid: tuple[torch.Tensor, ...]   # per island (width_s,) bool
    dictionary: torch.Tensor          # on island 0's device
    bounds: tuple[int, ...]           # row partition, len n_shards + 1
    version: int
    snapshot_id: int = -1
    stale_reason: str | None = None
    _dict_counts: torch.Tensor | None = dataclasses.field(
        default=None, repr=False, compare=False)
    _host_dict: np.ndarray | None = dataclasses.field(
        default=None, repr=False, compare=False)
    _island_dicts: tuple | None = dataclasses.field(
        default=None, repr=False, compare=False)
    _island_rcounts: tuple | None = dataclasses.field(
        default=None, repr=False, compare=False)

    @property
    def device(self) -> torch.device:
        return self.dictionary.device

    @property
    def devices(self) -> tuple[torch.device, ...]:
        return tuple(c.device for c in self.codes)

    def island_dicts(self) -> tuple[torch.Tensor, ...]:
        """The replicated dictionary, one tensor per island on its device
        (made once per view; read-only)."""
        self.require_fresh()
        if self._island_dicts is None:
            self._island_dicts = replicate(self.dictionary, self.devices)
        return self._island_dicts

    def dict_counts(self) -> torch.Tensor:
        """The join's build side: occurrence counts of the view's valid
        rows per dictionary value, each island's histogram made on its own
        device and summed on island 0's, in island order (int64, exact;
        once per view; read-only)."""
        self.require_fresh()
        if self._dict_counts is None:
            total = torch.zeros(self.dict_size, dtype=torch.int64,
                                device=self.device)
            for c, v in zip(self.codes, self.valid):
                total += torch.bincount(c[v].long(), minlength=self.dict_size
                                        ).to(self.device)
            self._dict_counts = total
        return self._dict_counts

    def island_rcounts(self) -> tuple[torch.Tensor, ...]:
        """`dict_counts` as int32 (counts never exceed the row count), one
        copy per island device (made once per view; read-only)."""
        self.require_fresh()
        if self._island_rcounts is None:
            self._island_rcounts = replicate(
                self.dict_counts().to(torch.int32), self.devices)
        return self._island_rcounts

    def shard(self, s: int) -> EncodedColumn:
        """One island's resident shard as an EncodedColumn: codes and
        validity on the island's device, the shared dictionary tensor on
        island 0's."""
        self.require_fresh()
        return EncodedColumn(codes=self.codes[s], dictionary=self.dictionary,
                             valid=self.valid[s], version=self.version,
                             _host_dict=self._host_dict)

    def to_column(self) -> EncodedColumn:
        """Reassemble the full column on island 0's device."""
        return concat_columns([self.shard(s) for s in range(self.n_shards)],
                              device=self.device)


def stack_rows(parts: list[torch.Tensor], width: int) -> torch.Tensor:
    """Stack 1-D tensors of at most `width` entries into a (len(parts),
    width) tensor, zero (False) padded - one copy per part, none per row."""
    head = parts[0]
    out = torch.zeros((len(parts), width), dtype=head.dtype,
                      device=head.device)
    for s, p in enumerate(parts):
        out[s, :p.shape[0]] = p
    return out


def shard_rows(flat: torch.Tensor, bounds) -> torch.Tensor:
    """A column's rows laid out by `bounds` as (n_shards, width), padded
    with zeros. Equal shards are a view of `flat` (installed columns are
    never written in place, so the view may alias it)."""
    n_shards = len(bounds) - 1
    sizes = [hi - lo for lo, hi in zip(bounds, bounds[1:])]
    width = max(sizes, default=0)
    if all(s == width for s in sizes):
        return flat.reshape(n_shards, width)
    return stack_rows([flat[lo:hi] for lo, hi in zip(bounds, bounds[1:])],
                      width)


def make_sharded_view(col: EncodedColumn, n_shards: int,
                      snapshot_id: int = -1) -> ShardedView:
    """Shard `col` ONCE into a resident ShardedView (the pin-time copy).

    This is the only place the snapshot plane moves rows: operators after
    this consume the stacked tensors directly, so a query round shards each
    pinned column exactly once.
    """
    bounds = shard_bounds(col.n_rows, n_shards)
    return ShardedView(codes=shard_rows(col.codes, bounds),
                       valid=shard_rows(col.valid, bounds),
                       dictionary=col.dictionary, bounds=tuple(bounds),
                       version=col.version, snapshot_id=snapshot_id,
                       _host_dict=col._host_dict)


def stack_shard_columns(shard_cols: list[EncodedColumn],
                        snapshot_id: int = -1, devices=None):
    """Adopt per-island shard columns as a resident view directly (no
    concat and re-split): the Phase-2 residency install of the mesh
    placement (`core.backend.MeshBackend.place_shards`). Shards must line
    up with `shard_bounds` and share one dictionary and version
    (`check_shard_set`).

    With `devices` (one per island) island *s*'s shard is laid on
    ``devices[s]`` as a `MeshView`; without, the shards are stacked on one
    device into a `ShardedView`."""
    bounds = check_shard_set(shard_cols)
    head = shard_cols[0]
    if devices is not None:
        codes, valid = place_shard_arrays(devices,
                                          [c.codes for c in shard_cols],
                                          [c.valid for c in shard_cols])
        return MeshView(codes=codes, valid=valid, dictionary=head.dictionary,
                        bounds=tuple(bounds), version=head.version,
                        snapshot_id=snapshot_id, _host_dict=head._host_dict)
    width = max(c.n_rows for c in shard_cols)
    return ShardedView(codes=stack_rows([c.codes for c in shard_cols], width),
                       valid=stack_rows([c.valid for c in shard_cols], width),
                       dictionary=head.dictionary, bounds=tuple(bounds),
                       version=head.version, snapshot_id=snapshot_id,
                       _host_dict=head._host_dict)

