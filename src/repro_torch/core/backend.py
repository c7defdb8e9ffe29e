"""Execution backends: plain PyTorch reference vs hand-written Hopper kernels.

Polynesia's speedups come from specialized in-memory hardware; this port
models those units as CUDA kernels. The hot path (engine, shipping, update
application, consistency) is written against the small operator surface
below, so the same code runs either on

* ``TorchBackend`` (``"torch"``) - plain PyTorch ops, the functional
  reference the kernels are held against, or
* ``HopperBackend`` (``"hopper"``) - dispatching each operator to its
  hardware-analog kernel, or
* ``ShardedBackend`` (``"hopper@N"``, ``"torch@N"`` or ``n_shards=N``) -
  N analytical islands, each owning a row-wise shard of every column,
  stacked on one device: every island's scan rides one launch of the inner
  backend over the leading shard axis, and the exact per-island partials
  reduce with `reduce_partials`, or
* ``MeshBackend`` (``"hopper@N/mesh"``, ``placement="mesh"``) - the same N
  islands, island *s* resident on its own device ``devices[s]``
  (``get_backend(..., devices=[...])``, default ``cuda:0 .. cuda:N-1``;
  a list may repeat a device): a scan group is one launch per device over
  its islands, the exact int64 partials added on island 0's:

    ==========================  =================================
    operator                    kernel
    ==========================  =================================
    filter + aggregate          kernels/dict_ops.scan_filter_agg
                                (+ _batch for fused multi-query,
                                _sharded for all islands at once,
                                _mesh for one launch per device)
    filter + aggregate + join   kernels/hash_probe.scan_filter_agg_join
                                (+ _sharded, _mesh)
    delta-store corrections     folded into the scans' launches:
                                kernels/dict_ops.scan_filter_agg_group
                                (+ _sharded, _mesh); kernels/hash_probe.
                                scan_filter_agg_join_group (+ _sharded,
                                _mesh); alone: kernels/dict_ops.
                                scan_values_agg, scan_values_delta
    hash join / value encode    kernels/hash_probe.build_table/probe
                                (+ probe_sharded)
    update-log / dict merge     kernels/merge_runs
    update-dictionary sort      kernels/bitonic_sort
    sort + merge, per batch     kernels/dict_ops.apply_pipeline_batch
    snapshot copy               kernels/snapshot_copy
    ==========================  =================================

Every backend must produce *bit-identical* results: the integer query
answers, merged logs, dictionaries and snapshots are asserted equal across
backends in the tests. A backend is bound to one device at construction
(``get_backend(spec, device)``; a mesh backend's is island 0's);
``device=None`` means the GPU and raises when there is none. Columns and
dictionaries are tensors on that device; update logs are host numpy
records (the transactional island is the host).
"""

from __future__ import annotations

import abc
import contextlib
import dataclasses
import sys
from typing import Callable, Iterable, Sequence

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.core.dsm import (DictCache, EncodedColumn, MeshView,
                                  ShardedView, make_sharded_view, replicate,
                                  shard_column, shard_rows,
                                  stack_shard_columns)
from repro_torch.core.nsm import UPDATE_DTYPE
from repro_torch.distributed import island_mesh
from repro_torch.kernels.bitonic_sort import sort_1024, sort_rows
from repro_torch.kernels.common import (I32_MAX, from_host, resolve_device,
                                        width_bucket)
from repro_torch.kernels.dict_ops import (apply_pipeline_batch,
                                          scan_filter_agg,
                                          scan_filter_agg_batch,
                                          scan_filter_agg_group,
                                          scan_filter_agg_group_mesh,
                                          scan_filter_agg_group_sharded,
                                          scan_filter_agg_mesh,
                                          scan_filter_agg_sharded,
                                          scan_values_agg, scan_values_agg_ref,
                                          scan_values_delta)
from repro_torch.kernels.hash_probe import (EMPTY_KEY, build_table, probe,
                                            probe_sharded,
                                            scan_filter_agg_join,
                                            scan_filter_agg_join_group,
                                            scan_filter_agg_join_group_mesh,
                                            scan_filter_agg_join_group_sharded,
                                            scan_filter_agg_join_mesh,
                                            scan_filter_agg_join_sharded)
from repro_torch.kernels.merge_runs import merge_sorted_pairs, merge_sorted_runs
from repro_torch.kernels.snapshot_copy import snapshot_copy

SNAPSHOT_BLOCK = 8192  # copy-unit chunk size (kernels/snapshot_copy default)

# Every kernel entry point this module dispatches to, by the module-global
# name used at the call site. `counting_kernel_calls` (and the tests'
# monkeypatch wrappers) wrap exactly these names - keep it next to the
# imports so adding a kernel here keeps the count honest.
KERNEL_ENTRY_POINTS = ("scan_filter_agg", "scan_filter_agg_batch",
                       "scan_filter_agg_group",
                       "scan_filter_agg_group_sharded",
                       "scan_filter_agg_group_mesh",
                       "scan_filter_agg_sharded", "scan_filter_agg_mesh",
                       "scan_filter_agg_join",
                       "scan_filter_agg_join_group",
                       "scan_filter_agg_join_group_sharded",
                       "scan_filter_agg_join_group_mesh",
                       "scan_filter_agg_join_sharded",
                       "scan_filter_agg_join_mesh", "probe",
                       "probe_sharded", "build_table", "merge_sorted_runs",
                       "merge_sorted_pairs", "sort_1024", "sort_rows",
                       "snapshot_copy", "scan_values_agg",
                       "scan_values_delta", "apply_pipeline_batch")


@contextlib.contextmanager
def counting_kernel_calls():
    """Count kernel dispatches per entry point while the context is open.

    Yields a dict {entry_point_name: calls}; the wrappers are removed on
    exit. This counts calls of the public wrappers (on any device); the
    launches of the CUDA kernels themselves are counted by
    `kernels.common.kernel_launch_counts`.
    """
    module = sys.modules[__name__]
    counts: dict[str, int] = {}
    saved = {name: getattr(module, name) for name in KERNEL_ENTRY_POINTS}

    def wrap(name, real):
        def inner(*args, **kwargs):
            counts[name] = counts.get(name, 0) + 1
            return real(*args, **kwargs)
        return inner

    for name, real in saved.items():
        setattr(module, name, wrap(name, real))
    try:
        yield counts
    finally:
        for name, real in saved.items():
            setattr(module, name, real)


def _dedup_sorted(s: torch.Tensor) -> torch.Tensor:
    """Distinct values of an ascending 1-D tensor (first of each run)."""
    if s.shape[0] == 0:
        return s
    keep = torch.ones(s.shape[0], dtype=torch.bool, device=s.device)
    keep[1:] = s[1:] != s[:-1]
    return s[keep]


def _dedup_sorted_rows(rows: torch.Tensor, lens: Sequence[int]
                       ) -> list[torch.Tensor]:
    """`_dedup_sorted` of ``rows[r, :lens[r]]`` for every row of a
    (rows, width) tensor of ascending rows, with one mask and one
    device-to-host copy of the counts for the whole batch. Each result owns
    its memory."""
    n_rows, width = rows.shape
    real = (torch.arange(width, device=rows.device)[None, :]
            < torch.tensor(list(lens), device=rows.device)[:, None])
    keep = real.clone()
    keep[:, 1:] &= rows[:, 1:] != rows[:, :-1]
    counts = keep.sum(dim=1).tolist()
    return [t.clone() for t in torch.split(rows[keep], counts)]


def _fits_int32(values) -> bool:
    if len(values) == 0:
        return True
    if isinstance(values, torch.Tensor):
        if values.dtype in (torch.int8, torch.int16, torch.int32,
                            torch.uint8):
            return True
        return bool(values.min() >= -2**31) and bool(values.max() <= I32_MAX)
    # dtype short-circuit: any integer dtype of <= 32 bits fits by
    # construction - skips the min/max scans on the hot ship path
    if values.dtype.kind in "iu" and values.dtype.itemsize <= (
            4 if values.dtype.kind == "i" else 2):
        return True
    info = np.iinfo(np.int32)
    return bool(values.min() >= info.min and values.max() <= info.max)


def _dtype_of(values) -> torch.dtype:
    """The torch dtype of a tensor or of host numpy values."""
    if isinstance(values, torch.Tensor):
        return values.dtype
    return torch.from_numpy(np.empty(0, dtype=np.asarray(values).dtype)).dtype


class ExecutionBackend(abc.ABC):
    """Operator surface the HTAP hot path is written against.

    Columns and dictionaries are tensors on `self.device`; update values
    may arrive as host numpy (they come out of the host's update logs) and
    are moved once. All results must be exact - equality across backends is
    part of the contract, not a tolerance.
    """

    name: str = "?"
    placement: str = "stacked"
    n_shards: int = 1

    def __init__(self, device=None):
        self.device = resolve_device(device)

    def to_device(self, values, dtype: torch.dtype | None = None
                  ) -> torch.Tensor:
        """Host numpy or a tensor -> a tensor on this backend's device."""
        if isinstance(values, torch.Tensor):
            t = values
        else:
            t = from_host(values)
        t = t.to(self.device)
        return t if dtype is None else t.to(dtype)

    # -- analytical engine (§7) -------------------------------------------
    def code_range(self, col: EncodedColumn, lo: int, hi: int) -> tuple[int, int]:
        """Value range -> code range through the order-preserving dictionary."""
        d = col.host_dictionary()
        return (int(np.searchsorted(d, lo, side="left")),
                int(np.searchsorted(d, hi, side="right")))

    @abc.abstractmethod
    def filter_mask(self, col: EncodedColumn, lo: int, hi: int) -> torch.Tensor:
        """Boolean row mask for lo <= value <= hi (dictionary pushdown)."""

    @abc.abstractmethod
    def filter_agg(self, fcol: EncodedColumn, acol: EncodedColumn,
                   lo: int, hi: int) -> tuple[int, int]:
        """(sum of acol values, selected-row count) over the filter range."""

    @abc.abstractmethod
    def filter_agg_batch(self, fcol: EncodedColumn, acol: EncodedColumn,
                         bounds: Sequence[tuple[int, int]]
                         ) -> list[tuple[int, int]]:
        """Fused multi-query scan: one pass answering all (lo, hi) bounds."""

    def filter_agg_mask(self, fcol: EncodedColumn, acol: EncodedColumn,
                        lo: int, hi: int) -> tuple[int, int, torch.Tensor]:
        """filter_agg plus the row mask (needed by join queries). Backends
        that fuse the aggregate (so the mask is not a by-product) get it
        from one extra filter_mask pass."""
        s, c = self.filter_agg(fcol, acol, lo, hi)
        return s, c, self.filter_mask(fcol, lo, hi)

    @abc.abstractmethod
    def hash_join_count(self, left: EncodedColumn, right: EncodedColumn,
                        left_mask: torch.Tensor | None = None) -> int:
        """|left JOIN right on value| via dictionary-level matching."""

    def filter_agg_join_batch(self, fcol: EncodedColumn, acol: EncodedColumn,
                              jcol: EncodedColumn,
                              bounds: Sequence[tuple[int, int]],
                              rcount: torch.Tensor | None = None
                              ) -> list[tuple[int, int, int]]:
        """Fused join-query group: for every (lo, hi) predicate return the
        exact ``(sum, count, self_join_count)`` triple, where the join count
        is ``|jcol JOIN jcol|`` restricted to the predicate's row mask.

        ``rcount`` overrides the build-side per-code occurrence histogram.
        The identity
        ``hash_join_count(j, j, mask) == sum(rcount[jcodes[mask & jvalid]])``
        makes the override exact.

        This default is the per-query path (mask-producing scan +
        dictionary-level join), kept as the reference; the accelerator
        backend overrides it with ONE fused device call per group."""
        out = []
        rc = None if rcount is None else rcount.to(torch.int64)
        for lo, hi in bounds:
            s, c, mask = self.filter_agg_mask(fcol, acol, lo, hi)
            if rc is None:
                j = self.hash_join_count(jcol, jcol, left_mask=mask)
            else:
                keep = mask & jcol.valid
                j = int(rc[jcol.codes[keep].long()].sum())
            out.append((s, c, j))
        return out

    # -- the delta store's corrections ----------------------------------------
    def filter_agg_values_batch(self, fvals, avals, valid,
                                bounds: Sequence[tuple[int, int]]
                                ) -> list[tuple[int, int]]:
        """Fused multi-query scan over RAW (decoded) rows - the delta-store
        correction pass. bounds are INCLUSIVE value ranges (the overlay
        carries values, so there is no dictionary to push predicates into);
        returns exact [(sum, count), ...]. This default is the plain
        version; HopperBackend launches the raw-value scan kernel."""
        return scan_values_agg_ref(self.to_device(fvals),
                                   self.to_device(avals),
                                   self.to_device(valid), bounds)

    def filter_agg_values_delta(self, corr, bounds: Sequence[tuple[int, int]]
                                ) -> list[tuple[int, int]]:
        """Effective-minus-base correction of one overlay stack: per bound,
        the exact (d_sum, d_count) a delta overlay adds to the base scan.
        ``corr`` is a (6, nr) int32 tensor of [fv_eff, av_eff, valid_eff,
        fv_base, av_base, valid_base] rows (engine._corr_stack); None is no
        overlay. This default is two raw-value scans subtracted;
        HopperBackend runs both in ONE launch (scan_values_delta)."""
        if corr is None:
            return [(0, 0)] * len(bounds)
        eff = self.filter_agg_values_batch(corr[0], corr[1], corr[2], bounds)
        base = self.filter_agg_values_batch(corr[3], corr[4], corr[5], bounds)
        return [(e[0] - b[0], e[1] - b[1]) for e, b in zip(eff, base)]

    def filter_agg_delta_batch(self, fcol: EncodedColumn, acol: EncodedColumn,
                               bounds: Sequence[tuple[int, int]], corr
                               ) -> list[tuple[int, int]]:
        """Fused multi-query scan over the pinned base WITH the overlay
        correction folded in: ``filter_agg_batch`` answers plus the
        ``corr`` stack's per-bound deltas. This default composes the two
        operators; HopperBackend runs the base scan and the correction as
        ONE launch (scan_filter_agg_group)."""
        fused = self.filter_agg_batch(fcol, acol, bounds)
        if corr is None:
            return fused
        deltas = self.filter_agg_values_delta(corr, bounds)
        return [(s + ds, c + dc)
                for (s, c), (ds, dc) in zip(fused, deltas)]

    def filter_agg_join_delta_batch(self, fcol: EncodedColumn,
                                    acol: EncodedColumn, jcol: EncodedColumn,
                                    bounds: Sequence[tuple[int, int]],
                                    rcount, corr_a, corr_j
                                    ) -> list[tuple[int, int, int]]:
        """Delta-merged join group: ``filter_agg_join_batch`` with the
        EFFECTIVE build-side histogram override plus the aggregate
        (``corr_a``) and weighted probe-row (``corr_j``) corrections -
        ``corr_j``'s value lanes carry effective join-histogram weights and
        only its sum delta applies (to the join term). Either stack may be
        None. HopperBackend overrides with ONE launch
        (scan_filter_agg_join_group)."""
        fused = self.filter_agg_join_batch(fcol, acol, jcol, bounds,
                                           rcount=rcount)
        if corr_a is not None:
            da = self.filter_agg_values_delta(corr_a, bounds)
            fused = [(s + ds, c + dc, j)
                     for (s, c, j), (ds, dc) in zip(fused, da)]
        if corr_j is not None:
            dj = self.filter_agg_values_delta(corr_j, bounds)
            fused = [(s, c, j + djs)
                     for (s, c, j), (djs, _) in zip(fused, dj)]
        return fused

    def scan_view(self, fview: ShardedView, aview: ShardedView,
                  code_bounds: Sequence[tuple[int, int]]
                  ) -> list[list[tuple[int, int]]]:
        """Every island's fused multi-predicate scan over resident shards:
        exact per-island partials ``[[(sum, count)] * Q] * n_shards``.

        This default is the serial per-shard reference - a loop over the
        unpadded shard slices - kept as the oracle the batched kernel must
        match; HopperBackend overrides it with ONE launch over the leading
        shard axis.
        """
        fview.require_fresh()
        aview.require_fresh()
        adict = aview.dictionary.to(torch.int64)
        out = []
        for s, size in enumerate(fview.sizes):
            fc, va = fview.codes[s, :size], fview.valid[s, :size]
            ac = aview.codes[s, :size]
            res = []
            for code_lo, code_hi in code_bounds:
                mask = (fc >= code_lo) & (fc < code_hi) & va
                counts = torch.bincount(ac[mask].long(),
                                        minlength=aview.dict_size)
                res.append((int((counts * adict).sum()), int(mask.sum())))
            out.append(res)
        return out

    def scan_view_join(self, fview: ShardedView, aview: ShardedView,
                       jview: ShardedView,
                       code_bounds: Sequence[tuple[int, int]],
                       rcount: torch.Tensor | None = None
                       ) -> list[list[tuple[int, int, int]]]:
        """Every island's fused join-group scan over resident shards.

        Like `scan_view`, plus each island's partial self-join count: its
        resident probe-side rows against the GLOBAL build-side histogram
        (``jview.dict_counts()``, over all islands, or the ``rcount``
        override), so the cross-island reduction is a plain exact sum. This
        default is the serial per-shard reference; HopperBackend overrides
        it with ONE launch.
        """
        fview.require_fresh()
        aview.require_fresh()
        jview.require_fresh()
        adict = aview.dictionary.to(torch.int64)
        rc = (jview.dict_counts() if rcount is None else rcount
              ).to(torch.int64)
        out = []
        for s, size in enumerate(fview.sizes):
            fc, va = fview.codes[s, :size], fview.valid[s, :size]
            ac = aview.codes[s, :size]
            jc, jv = jview.codes[s, :size], jview.valid[s, :size]
            res = []
            for code_lo, code_hi in code_bounds:
                mask = (fc >= code_lo) & (fc < code_hi) & va
                counts = torch.bincount(ac[mask].long(),
                                        minlength=aview.dict_size)
                keep = mask & jv
                res.append((int((counts * adict).sum()), int(mask.sum()),
                            int(rc[jc[keep].long()].sum())))
            out.append(res)
        return out

    def encode_values_shards(self, encoder: Callable[..., torch.Tensor],
                             values_list: Sequence) -> list[torch.Tensor]:
        """Encode every island's pending update values through one shared
        value->code map. Reference: one encoder call per island; the
        accelerator backend probes all islands in one launch when the
        encoder is a hash table. The mesh's per-island apply
        (`application.apply_updates_shards`) calls it with the staged
        encoder, a binary search, so it never reaches the probe there."""
        return [encoder(v) for v in values_list]

    # -- update propagation (§5) ------------------------------------------
    @abc.abstractmethod
    def merge_update_logs(self, logs: Iterable[np.ndarray]) -> np.ndarray:
        """K-way merge of commit-ordered per-thread logs into the final log
        (host records in, host records out)."""

    @abc.abstractmethod
    def sort_unique(self, values) -> torch.Tensor:
        """Sort + dedupe pending update values -> update dictionary."""

    @abc.abstractmethod
    def merge_dictionaries(self, old_dict: torch.Tensor,
                           update_dict: torch.Tensor) -> torch.Tensor:
        """Linear merge of two sorted dictionaries -> sorted-unique union."""

    @abc.abstractmethod
    def make_encoder(self, dictionary: torch.Tensor
                     ) -> Callable[..., torch.Tensor]:
        """value -> code lookup for values present in `dictionary`."""

    def sort_unique_batch(self, values_list: Sequence) -> list[torch.Tensor]:
        """`sort_unique` over several pending-update value sets (one per
        column of a ship batch). Reference: one sort per set; the
        accelerator backend rides every set as a row of ONE sorter
        dispatch. Results are elementwise identical either way."""
        return [self.sort_unique(v) for v in values_list]

    def merge_dictionaries_batch(self, pairs: Sequence[tuple]
                                 ) -> list[torch.Tensor]:
        """`merge_dictionaries` over several (old, update) dictionary
        pairs. Reference: one merge per pair; the accelerator backend
        merges every pair as a row of ONE merge dispatch. Results are
        elementwise identical either way."""
        return [self.merge_dictionaries(o, u) for o, u in pairs]

    def staged_encoder(self, new_dict: torch.Tensor
                       ) -> Callable[..., torch.Tensor]:
        """value -> code map for a ship batch's STAGED writes. Every staged
        write value is a pending update value, so it is in update_dict, a
        subset of new_dict by construction - a vectorized binary search
        over the merged dictionary is exact (`make_encoder` stays the
        general-purpose encoder)."""
        def encode(values):
            v = self.to_device(values, new_dict.dtype)
            return torch.searchsorted(new_dict, v).to(torch.int64)
        return encode

    def _stage_entry(self, update_dict, new_dict, old):
        """(update_dict, new_dict, encode, old_to_new) for one column: both
        dictionaries are sorted and every old value survives the merge, so
        each old entry's new code is its merged position."""
        return (update_dict, new_dict, self.staged_encoder(new_dict),
                torch.searchsorted(new_dict, old.to(new_dict.dtype)
                                   ).to(torch.int64))

    def apply_stages_batch(self, per_column: Sequence[tuple]) -> list[tuple]:
        """Stages 1-2 of the optimized update application for every column
        of a ship batch: per (old_dict, write_vals) pair, sort+dedupe the
        pending values into the update dictionary, linear-merge the sorted
        dictionaries, and derive the staged encoder + positional old->new
        code map. Returns [(update_dict, new_dict, encode, old_to_new)] in
        order.

        This default rides the batched sorter/merge dispatches;
        HopperBackend overrides it with ONE fused launch (sort + merge) per
        ship batch."""
        olds = [self.to_device(o) for o, _ in per_column]
        upd: list = [None] * len(per_column)
        nonempty = [i for i, (_, wv) in enumerate(per_column) if len(wv)]
        for i, u in zip(nonempty, self.sort_unique_batch(
                [per_column[i][1] for i in nonempty])):
            upd[i] = u
        for i in range(len(per_column)):
            if upd[i] is None:
                upd[i] = torch.empty(0, dtype=torch.int32, device=self.device)
        new_dicts = self.merge_dictionaries_batch(list(zip(olds, upd)))
        return [self._stage_entry(u, nd, old)
                for u, nd, old in zip(upd, new_dicts, olds)]

    # -- consistency (§6) --------------------------------------------------
    @abc.abstractmethod
    def snapshot_column(self, col: EncodedColumn,
                        prev: EncodedColumn | None = None) -> EncodedColumn:
        """Copy-unit snapshot of `col`; `prev` is the chain head, from which
        clean chunks may be carried instead of re-read."""


def _side_counts(col: EncodedColumn, mask: torch.Tensor | None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """One join side's per-dictionary-value occurrence counts."""
    keep = col.valid
    if mask is not None:
        keep = mask & keep
    codes = col.codes[keep].long()
    return col.dictionary, torch.bincount(codes, minlength=col.dict_size)


def merge_update_logs_host(logs: Iterable[np.ndarray]) -> np.ndarray:
    """The reference k-way log merge: a stable sort of the concatenation
    by commit id, on the host where the logs live."""
    logs = [l for l in logs if len(l)]
    if not logs:
        return np.empty(0, dtype=UPDATE_DTYPE)
    cat = np.concatenate(logs)
    order = np.argsort(cat["commit_id"], kind="stable")
    return cat[order]


class TorchBackend(ExecutionBackend):
    """The hot path in plain PyTorch ops - the port's functional reference."""

    name = "torch"

    def filter_mask(self, col, lo, hi):
        code_lo, code_hi = self.code_range(col, lo, hi)
        return (col.codes >= code_lo) & (col.codes < code_hi) & col.valid

    def aggregate_sum(self, col, mask):
        """Histogram-of-codes aggregate: one sequential pass, no random access."""
        counts = torch.bincount(col.codes[mask].long(),
                                minlength=col.dict_size)
        return int((counts * col.dictionary.to(torch.int64)).sum())

    def filter_agg(self, fcol, acol, lo, hi):
        mask = self.filter_mask(fcol, lo, hi)
        return self.aggregate_sum(acol, mask), int(mask.sum())

    def filter_agg_mask(self, fcol, acol, lo, hi):
        # one scan: the mask is the aggregate's by-product
        mask = self.filter_mask(fcol, lo, hi)
        return self.aggregate_sum(acol, mask), int(mask.sum()), mask

    def filter_agg_batch(self, fcol, acol, bounds):
        return [self.filter_agg(fcol, acol, lo, hi) for lo, hi in bounds]

    def _join_match(self, lv, rv, lcount, rcount, right=None):
        """Match pre-grouped dictionary counts (the join's build+probe):
        both dictionaries are sorted and distinct, so each left value has
        at most one partner, found by binary search. `right` is the column
        or view that owns `rv` (the hash unit caches its table there)."""
        if lv.shape[0] == 0 or rv.shape[0] == 0:
            return 0
        pos = torch.searchsorted(rv, lv).clamp_(max=rv.shape[0] - 1)
        hit = rv[pos] == lv
        return int((lcount[hit] * rcount[pos[hit]]).sum())

    def hash_join_count(self, left, right, left_mask=None):
        lv, lcount = _side_counts(left, left_mask)
        rv, rcount = _side_counts(right, None)
        return self._join_match(lv, rv, lcount, rcount, right)

    def merge_update_logs(self, logs):
        return merge_update_logs_host(logs)

    def sort_unique(self, values):
        return torch.unique(self.to_device(values))

    def merge_dictionaries(self, old_dict, update_dict):
        old = self.to_device(old_dict)
        cat = torch.cat([old, self.to_device(update_dict, old.dtype)])
        return torch.unique(cat)

    def make_encoder(self, dictionary):
        d = self.to_device(dictionary)
        return lambda values: torch.searchsorted(
            d, self.to_device(values, d.dtype))

    def snapshot_column(self, col, prev=None):
        # Installed columns are never written in place (dsm.py), so
        # aliasing IS a consistent snapshot. The hardware copy is priced by
        # the caller regardless.
        return EncodedColumn(codes=col.codes, dictionary=col.dictionary,
                             valid=col.valid, version=col.version,
                             _dict_cache=col._dict_cache)


class HopperBackend(TorchBackend):
    """Dispatches the hot path to the hand-written CUDA kernels.

    Inherits the plain glue (bincounts, grouping, masks) - the paper's
    fixed-function units do the data-plane work while small control-plane
    steps stay plain. Where a fused kernel's precondition can't hold (a
    value colliding with the int32.max sentinel pad, an empty side) the
    column takes the unfused kernels (sort unit, then the 64-bit merge
    unit), and an empty side needs no kernel at all; every such path keeps
    results identical. Values beyond int32
    (which no session produces: update values and dictionaries are int32)
    are refused on the GPU rather than handed to a library sort. On CPU
    tensors each kernel wrapper runs its plain version, which is how the
    tests drive this class.

    Lone join queries (`hash_join_count`) go through the hash unit: a
    bucket table over the right dictionary, built once per dictionary and
    cached with it (`EncodedColumn.probe_table`), and one probe launch per
    query. Query groups never reach it - their join is the fused scan
    below. `make_encoder` / `encode_values_shards` probe the same kind of
    table; no path of the port reaches that probe (ship batches encode
    through `staged_encoder`, which has no table - also in the mesh's
    per-island apply), they stay for parity with the reference.
    """

    name = "hopper"

    # -- analytical engine -------------------------------------------------
    def filter_agg(self, fcol, acol, lo, hi):
        code_lo, code_hi = self.code_range(fcol, lo, hi)
        s, c = scan_filter_agg(fcol.codes, acol.codes, fcol.valid,
                               acol.dictionary, code_lo, code_hi, exact=True)
        return int(s), int(c)

    def filter_agg_mask(self, fcol, acol, lo, hi):
        # the fused kernel does not materialize the mask; produce it with
        # one extra pass (explicit override - inheriting would pick up
        # TorchBackend's all-torch scan and bypass the kernel entirely)
        s, c = self.filter_agg(fcol, acol, lo, hi)
        return s, c, self.filter_mask(fcol, lo, hi)

    def filter_agg_batch(self, fcol, acol, bounds):
        if len(bounds) == 1:
            [(lo, hi)] = bounds
            return [self.filter_agg(fcol, acol, lo, hi)]
        code_bounds = [self.code_range(fcol, lo, hi) for lo, hi in bounds]
        return scan_filter_agg_batch(fcol.codes, acol.codes, fcol.valid,
                                     acol.dictionary, code_bounds)

    def filter_agg_join_batch(self, fcol, acol, jcol, bounds, rcount=None):
        # the whole join group in ONE fused device call: the self-join is a
        # second exact scan lane with the build side's occurrence histogram
        # as the dictionary (counts <= n_rows keep it int32-exact); plain
        # code contributes only the build-side bincount, once per group.
        code_bounds = [self.code_range(fcol, lo, hi) for lo, hi in bounds]
        if rcount is None:
            rcount = torch.bincount(jcol.codes[jcol.valid].long(),
                                    minlength=jcol.dict_size)
        rcount = rcount.to(torch.int32)
        return scan_filter_agg_join(fcol.codes, acol.codes, jcol.codes,
                                    fcol.valid, jcol.valid, acol.dictionary,
                                    rcount, code_bounds)

    def scan_view(self, fview, aview, code_bounds):
        # every island in ONE launch over the leading shard axis; padded
        # slots carry valid=0, the exact scan identity
        fview.require_fresh()
        aview.require_fresh()
        return scan_filter_agg_sharded(fview.codes, aview.codes, fview.valid,
                                       aview.dictionary, code_bounds)

    def scan_view_join(self, fview, aview, jview, code_bounds, rcount=None):
        # every island's join group in the same single launch; the build
        # side is the view's cached global histogram, so the per-island
        # partial join counts sum exactly across shards
        fview.require_fresh()
        aview.require_fresh()
        jview.require_fresh()
        rc = (jview.dict_counts() if rcount is None else rcount
              ).to(torch.int32)
        return scan_filter_agg_join_sharded(
            fview.codes, aview.codes, jview.codes, fview.valid, jview.valid,
            aview.dictionary, rc, code_bounds)

    def filter_agg_values_batch(self, fvals, avals, valid, bounds):
        # the raw-value scan: one launch over the flat overlay rows
        return scan_values_agg(self.to_device(fvals), self.to_device(avals),
                               self.to_device(valid), bounds)

    def filter_agg_values_delta(self, corr, bounds):
        # effective and base correction scans in ONE launch
        return scan_values_delta(corr, bounds)

    def filter_agg_delta_batch(self, fcol, acol, bounds, corr):
        # the whole delta-merged group - base multi-predicate scan plus the
        # overlay correction - as ONE launch
        if corr is None:
            return self.filter_agg_batch(fcol, acol, bounds)
        code_bounds = [self.code_range(fcol, lo, hi) for lo, hi in bounds]
        return scan_filter_agg_group(fcol.codes, acol.codes, fcol.valid,
                                     acol.dictionary, code_bounds, corr,
                                     bounds)

    def filter_agg_join_delta_batch(self, fcol, acol, jcol, bounds, rcount,
                                    corr_a, corr_j):
        # delta-merged join group in ONE launch: aggregate + join scans and
        # both corrections
        if corr_a is None and corr_j is None:
            return self.filter_agg_join_batch(fcol, acol, jcol, bounds,
                                              rcount=rcount)
        code_bounds = [self.code_range(fcol, lo, hi) for lo, hi in bounds]
        if rcount is None:
            rcount = torch.bincount(jcol.codes[jcol.valid].long(),
                                    minlength=jcol.dict_size)
        return scan_filter_agg_join_group(
            fcol.codes, acol.codes, jcol.codes, fcol.valid, jcol.valid,
            acol.dictionary, rcount.to(torch.int32), code_bounds, corr_a,
            corr_j, bounds)

    def _join_match(self, lv, rv, lcount, rcount, right=None):
        # hash unit: probe each left dictionary value against the bucket
        # table of the right dictionary - built once per dictionary and
        # cached with it (`right.probe_table()`), a new table only without
        # an owner - and weigh the hits by the pre-grouped occurrence
        # counts. The sum stays on the device until the one exact int64
        # read. An empty side, or EMPTY_KEY (the free-slot key) in the
        # right dictionary, keeps the binary search; a left value equal to
        # EMPTY_KEY would hit the free slots, and has no partner.
        if lv.shape[0] == 0 or rv.shape[0] == 0:
            return super()._join_match(lv, rv, lcount, rcount)
        table = (right.probe_table() if right is not None
                 else DictCache(rv.cpu().numpy()).probe_table(rv))
        if table is None:
            return super()._join_match(lv, rv, lcount, rcount)
        ri = probe(table, lv.to(torch.int32), default=-1)
        hit = (ri >= 0) & (lv != EMPTY_KEY)
        matched = torch.where(hit, rcount[ri.clamp(min=0).long()], 0)
        return int((lcount * matched).sum())

    def make_encoder(self, dictionary):
        """value -> code through a bucket table of `dictionary` (one probe
        launch per call; no caller in the port, see the class docstring).
        A dictionary the table cannot hold (empty, beyond
        int32, holding EMPTY_KEY) keeps the binary search, as do values
        beyond int32; a value missing from the dictionary encodes to -1."""
        d = (dictionary.cpu().numpy() if isinstance(dictionary, torch.Tensor)
             else np.asarray(dictionary))
        fallback = super().make_encoder(dictionary)
        if len(d) == 0 or not _fits_int32(d) or (d == EMPTY_KEY).any():
            return fallback
        table = build_table(d, np.arange(len(d), dtype=np.int32))

        def encode(values):
            if len(values) == 0:
                return torch.empty(0, dtype=torch.int64, device=self.device)
            if not _fits_int32(values):
                return fallback(values)
            codes = probe(table, self.to_device(values, torch.int32))
            return codes.to(torch.int64)

        encode._table = table  # lets encode_values_shards batch the probes
        return encode

    def encode_values_shards(self, encoder, values_list):
        table = getattr(encoder, "_table", None)
        if table is None or not all(_fits_int32(v) for v in values_list):
            return super().encode_values_shards(encoder, values_list)
        # one probe launch covers every island's update-value encodes
        codes = probe_sharded(table, [self.to_device(v, torch.int32)
                                      for v in values_list])
        return [c.to(torch.int64) for c in codes]

    # -- update propagation ------------------------------------------------
    def merge_update_logs(self, logs):
        logs = [l for l in logs if len(l)]
        if not logs:
            return np.empty(0, dtype=UPDATE_DTYPE)
        cat = np.concatenate(logs)
        if len(logs) == 1:
            return cat
        # the commit ids cross to the device once, the merged source
        # indices come back once; payloads are gathered on the host
        _, src = merge_sorted_runs([l["commit_id"] for l in logs],
                                   device=self.device)
        return cat[src.cpu().numpy()]

    def _sort_unit_input(self, values) -> torch.Tensor:
        """The values as the sort unit takes them. The unit sorts int32: on
        the GPU wider values are refused (no other sorter stands in for the
        kernel); on the CPU the unit's plain version sorts any integers."""
        v = self.to_device(values)
        if _fits_int32(values):
            return v.to(torch.int32)
        if v.device.type == "cuda":
            raise ValueError(
                "the sort unit takes int32 values; a value beyond int32 "
                "cannot be sorted on the GPU")
        return v

    def sort_unique(self, values):
        v = self.to_device(values)
        if len(values) == 0:
            return v
        unit = self._sort_unit_input(values)
        if len(values) <= 1024:  # the paper's 1024-value sort unit
            s = sort_1024(unit)
        else:
            s = sort_rows(unit[None, :])[0]
        return _dedup_sorted(s).to(v.dtype)

    def merge_dictionaries(self, old_dict, update_dict):
        old = self.to_device(old_dict)
        upd = self.to_device(update_dict, old.dtype)
        # an empty side leaves the other, which is sorted and distinct
        if len(upd) == 0:
            return old
        if len(old) == 0:
            return upd
        _, src = merge_sorted_runs([old, upd], device=self.device)
        merged = torch.cat([old, upd])[src.long()]
        return _dedup_sorted(merged)

    def sort_unique_batch(self, values_list):
        """Every value set rides one row of a single sorter dispatch.

        Each row's sorted prefix is exactly that set's sorted multiset
        (rows are independent and sentinels fill the tails), so per-row
        dedup yields the same update dictionary as `sort_unique`. Sets the
        batched sort can't take (empty / beyond int32) go through
        `sort_unique` one by one, as does a batch with fewer than two
        sortable sets.
        """
        vals = list(values_list)
        batchable = [i for i, v in enumerate(vals)
                     if len(v) and _fits_int32(v)]
        if len(batchable) < 2:
            return [self.sort_unique(v) for v in vals]
        width = max(len(vals[i]) for i in batchable)
        dev_vals = {i: self.to_device(vals[i]) for i in batchable}
        stack = torch.full((len(batchable), width), I32_MAX,
                           dtype=torch.int32, device=self.device)
        for r, i in enumerate(batchable):
            stack[r, :len(vals[i])] = dev_vals[i].to(torch.int32)
        rows = sort_rows(stack)
        out: list = [None] * len(vals)
        for r, i in enumerate(batchable):
            s = rows[r, :len(vals[i])]
            out[i] = _dedup_sorted(s).to(dev_vals[i].dtype)
        for i, v in enumerate(vals):
            if out[i] is None:
                out[i] = self.sort_unique(v)
        return out

    def merge_dictionaries_batch(self, pairs):
        """Every (old, update) pair rides one row of a single merge
        dispatch (`merge_sorted_pairs`); per-row dedup of the merged keys
        yields the same dictionary as `merge_dictionaries`. Pairs with an
        empty side keep the scalar path, as does a batch with fewer than
        two mergeable pairs."""
        pairs = [(self.to_device(o), self.to_device(u)) for o, u in pairs]
        batchable = [i for i, (o, u) in enumerate(pairs)
                     if len(o) and len(u)]
        if len(batchable) < 2:
            return [self.merge_dictionaries(o, u) for o, u in pairs]
        merged_keys = merge_sorted_pairs([pairs[i][0] for i in batchable],
                                         [pairs[i][1] for i in batchable])
        out: list = [None] * len(pairs)
        for r, i in enumerate(batchable):
            out[i] = _dedup_sorted(merged_keys[r]).to(pairs[i][0].dtype)
        for i, (o, u) in enumerate(pairs):
            if out[i] is None:
                out[i] = self.merge_dictionaries(o, u)
        return out

    def apply_stages_batch(self, per_column):
        """The whole ship batch's dictionary stages as ONE fused launch
        (kernels/dict_ops.apply_pipeline_batch): every column's update
        values ride one row of a single sort and merge with its old
        dictionary in the same kernel - replacing the separate sorter and
        merge dispatches of the batched composition, also for a batch of
        one column (the reference takes the composition there: one launch
        where it has two). The old-dictionary and value sides get
        independent `common.width_bucket` widths, so the sort runs at the
        (usually small) value width instead of the dictionary width.

        Columns the fused pipeline can't take - an empty side (nothing to
        sort or merge), values beyond int32, or values colliding with the
        int32.max sentinel pad - fall back to the compositional default.
        Results are elementwise identical either way."""
        cols = [(self.to_device(o), wv) for o, wv in per_column]
        # old dictionaries are sorted, so o[-1] is the max: every column's
        # in one device-to-host copy (a per-column int() is a sync each)
        nonempty = [i for i, (o, _) in enumerate(cols) if len(o)]
        old_max = dict(zip(nonempty, torch.stack(
            [cols[i][0][-1] for i in nonempty]).tolist())) if nonempty else {}

        def fusable(i):
            o, wv = cols[i]
            return (len(o) > 0 and len(wv) > 0 and _fits_int32(o)
                    and _fits_int32(wv) and old_max[i] < I32_MAX
                    and int(wv.max()) < I32_MAX)

        fused = [i for i in range(len(cols)) if fusable(i)]
        if not fused:
            return super().apply_stages_batch(per_column)
        w_old = width_bucket(max(len(cols[i][0]) for i in fused))
        w_val = width_bucket(max(len(cols[i][1]) for i in fused))
        old_stack = torch.full((len(fused), w_old), I32_MAX,
                               dtype=torch.int32, device=self.device)
        for r, i in enumerate(fused):
            o = cols[i][0]
            old_stack[r, :len(o)] = o.to(torch.int32)
        if all(isinstance(cols[i][1], np.ndarray) for i in fused):
            # the batch's update values cross to the device in one copy
            host = np.full((len(fused), w_val), I32_MAX, dtype=np.int32)
            for r, i in enumerate(fused):
                host[r, :len(cols[i][1])] = cols[i][1]
            val_stack = torch.from_numpy(host).to(self.device)
        else:
            val_stack = torch.full((len(fused), w_val), I32_MAX,
                                   dtype=torch.int32, device=self.device)
            for r, i in enumerate(fused):
                wv = self.to_device(cols[i][1], torch.int32)
                val_stack[r, :len(wv)] = wv
        sorted_vals, merged = apply_pipeline_batch(old_stack, val_stack)
        # per-row dedup of the sorted rows, all rows of the batch at once
        upds = _dedup_sorted_rows(sorted_vals,
                                  [len(cols[i][1]) for i in fused])
        news = _dedup_sorted_rows(
            merged, [len(cols[i][0]) + len(cols[i][1]) for i in fused])
        out: list = [None] * len(cols)
        for i, u, nd in zip(fused, upds, news):
            o, wv = cols[i]
            # the update dictionary keeps the values' dtype, the merged one
            # the old dictionary's
            out[i] = self._stage_entry(u.to(_dtype_of(wv)), nd.to(o.dtype),
                                       o)
        rest = [i for i in range(len(cols)) if out[i] is None]
        if rest:
            for i, stage in zip(rest, super().apply_stages_batch(
                    [per_column[i] for i in rest])):
                out[i] = stage
        return out

    # -- consistency -------------------------------------------------------
    def snapshot_column(self, col, prev=None):
        n = col.n_rows
        if n == 0:
            return super().snapshot_column(col, prev)
        n_chunks = (n + SNAPSHOT_BLOCK - 1) // SNAPSHOT_BLOCK
        src = col.codes
        if (prev is not None and prev.n_rows == n
                and (prev.dictionary is col.dictionary  # snapshots alias
                     or (prev.dictionary.shape == col.dictionary.shape
                         and torch.equal(prev.dictionary, col.dictionary)))):
            # tracking buffer: only chunks that changed since the previous
            # snapshot are fetched from the main replica (codes are only
            # comparable when the dictionaries match).
            diff = src != prev.codes
            dirty = torch.zeros(n_chunks, dtype=torch.bool, device=src.device)
            full = n // SNAPSHOT_BLOCK
            if full:
                dirty[:full] = diff[:full * SNAPSHOT_BLOCK].view(
                    full, SNAPSHOT_BLOCK).any(dim=1)
            if full < n_chunks:
                dirty[full] = diff[full * SNAPSHOT_BLOCK:].any()
            prev_arr = prev.codes
            if tracing.enabled():
                copied = torch.clamp(dirty.sum() * SNAPSHOT_BLOCK, max=n)
                tracing.count("snapshot.rows_copied", copied)
                tracing.count("snapshot.rows_carried", n - copied)
        else:
            dirty = torch.ones(n_chunks, dtype=torch.bool, device=src.device)
            prev_arr = col.codes
            tracing.count("snapshot.rows_copied", n)
            tracing.count("snapshot.rows_carried", 0)
        codes = snapshot_copy(src, prev_arr, dirty, block=SNAPSHOT_BLOCK)
        # the copy is a fresh tensor; dictionary and valid are aliased,
        # which is safe because installed columns are never written in place
        return EncodedColumn(codes=codes, dictionary=col.dictionary,
                             valid=col.valid, version=col.version,
                             _dict_cache=col._dict_cache)


# ---------------------------------------------------------------------------
# Analytical islands stacked on one device (§4, Fig. 5)
# ---------------------------------------------------------------------------

def reduce_partials(kind: str, parts: Sequence[int | None]) -> int | None:
    """Exact cross-shard reduction of per-island partials.

    Partials arrive as exact Python ints, and the reduction stays in
    arbitrary-precision int arithmetic, so the answer equals the unsharded
    scan's. ``None`` marks a partial from a shard with no qualifying rows
    (the identity for min/max).
    """
    live = [int(p) for p in parts if p is not None]
    if kind in ("sum", "count"):
        return sum(live)
    if kind == "min":
        return min(live) if live else None
    if kind == "max":
        return max(live) if live else None
    raise ValueError(f"unknown aggregate kind {kind!r}")


def _unshard_rows(rows2d: torch.Tensor, sizes: Sequence[int]) -> torch.Tensor:
    """The real rows of a (n_shards, width) tensor in row order (inverse of
    `dsm.shard_rows`)."""
    return torch.cat([rows2d[s, :size] for s, size in enumerate(sizes)])


class ShardedBackend(ExecutionBackend):
    """Several analytical islands: N row-wise DSM shards over one inner backend.

    Polynesia scales analytics out by replicating the analytical island:
    each island owns a resident DSM shard plus the replicated dictionary
    (§4, Fig. 5). Residency is `dsm.ShardedView`: the consistency manager
    shards each pinned snapshot column ONCE per query round (`shard_view`),
    and every scan-family operator then runs all islands through the inner
    backend's `scan_view` - one launch on HopperBackend, a per-shard loop on
    TorchBackend - and reduces the exact per-island partials with
    `reduce_partials`. All islands live on the inner backend's device.

    Operators also accept raw EncodedColumns (a view is built on the fly);
    a stale ShardedView is a hard `dsm.StaleShardedViewError`.

    Update propagation (log merge, dictionary sort and merge, value encode)
    and snapshots delegate to the inner backend: the dictionary is
    replicated, so those stages run once, and stage 3 of the apply runs on
    the one column all stacked islands share (`application.apply_updates`).
    """

    def __init__(self, inner: str | ExecutionBackend, n_shards: int,
                 device=None):
        if isinstance(inner, ShardedBackend):
            raise ValueError("cannot nest ShardedBackend inside ShardedBackend")
        inner = get_backend(inner, device=device, n_shards=1)
        if int(n_shards) < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        self.inner = inner
        self.device = inner.device
        self.n_shards = int(n_shards)
        self.name = f"{inner.name}@{self.n_shards}"

    # -- the sharded snapshot plane ---------------------------------------
    def shard_view(self, col: EncodedColumn, snapshot_id: int = -1
                   ) -> ShardedView:
        """Materialize the islands' resident shards of `col` (shard once)."""
        return make_sharded_view(col, self.n_shards, snapshot_id=snapshot_id)

    def _as_view(self, col) -> ShardedView:
        if isinstance(col, ShardedView):
            col.require_fresh()
            if col.n_shards != self.n_shards:
                raise ValueError(
                    f"ShardedView has {col.n_shards} shards but backend "
                    f"{self.name!r} has {self.n_shards} islands")
            return col
        return self.shard_view(col)

    # -- analytical engine -------------------------------------------------
    def _mask2d(self, view: ShardedView, lo: int, hi: int) -> torch.Tensor:
        code_lo, code_hi = self.code_range(view, lo, hi)
        return (view.codes >= code_lo) & (view.codes < code_hi) & view.valid

    def filter_mask(self, col, lo, hi):
        view = self._as_view(col)
        return _unshard_rows(self._mask2d(view, lo, hi), view.sizes)

    def filter_agg(self, fcol, acol, lo, hi):
        [(total_s, total_c)] = self.filter_agg_batch(fcol, acol, [(lo, hi)])
        return total_s, total_c

    def filter_agg_mask(self, fcol, acol, lo, hi):
        fv, av = self._as_view(fcol), self._as_view(acol)
        [per_shard] = zip(*self.inner.scan_view(
            fv, av, [self.code_range(fv, lo, hi)]))
        mask = _unshard_rows(self._mask2d(fv, lo, hi), fv.sizes)
        return (reduce_partials("sum", [s for s, _ in per_shard]),
                reduce_partials("count", [c for _, c in per_shard]), mask)

    def filter_agg_batch(self, fcol, acol, bounds):
        fv, av = self._as_view(fcol), self._as_view(acol)
        code_bounds = [self.code_range(fv, lo, hi) for lo, hi in bounds]
        per_shard = self.inner.scan_view(fv, av, code_bounds)
        return [(reduce_partials("sum", [p[q][0] for p in per_shard]),
                 reduce_partials("count", [p[q][1] for p in per_shard]))
                for q in range(len(bounds))]

    def filter_agg_join_batch(self, fcol, acol, jcol, bounds, rcount=None):
        # one scan_view_join covers every island's aggregate AND join scans;
        # the per-island (sum, count, join) partials all reduce as exact sums
        fv, av, jv = (self._as_view(fcol), self._as_view(acol),
                      self._as_view(jcol))
        code_bounds = [self.code_range(fv, lo, hi) for lo, hi in bounds]
        per_shard = self.inner.scan_view_join(fv, av, jv, code_bounds,
                                              rcount=rcount)
        return [(reduce_partials("sum", [p[q][0] for p in per_shard]),
                 reduce_partials("count", [p[q][1] for p in per_shard]),
                 reduce_partials("sum", [p[q][2] for p in per_shard]))
                for q in range(len(bounds))]

    def filter_agg_values_batch(self, fvals, avals, valid, bounds):
        # the correction runs over the flat overlay union, which is not
        # row-partitioned across islands (overlays are tiny next to the
        # shards): the inner backend's single launch
        return self.inner.filter_agg_values_batch(fvals, avals, valid, bounds)

    def filter_agg_values_delta(self, corr, bounds):
        # flat overlay stack, as above
        return self.inner.filter_agg_values_delta(corr, bounds)

    def filter_agg_delta_batch(self, fcol, acol, bounds, corr):
        # on the kernel inner every island's base scan over its resident
        # shard AND the flat overlay correction ride ONE launch; other
        # inners keep the composition (sharded base + inner correction)
        if corr is None:
            return self.filter_agg_batch(fcol, acol, bounds)
        if not isinstance(self.inner, HopperBackend):
            return super().filter_agg_delta_batch(fcol, acol, bounds, corr)
        fv, av = self._as_view(fcol), self._as_view(acol)
        code_bounds = [self.code_range(fv, lo, hi) for lo, hi in bounds]
        return scan_filter_agg_group_sharded(fv.codes, av.codes, fv.valid,
                                             av.dictionary, code_bounds,
                                             corr, bounds)

    def filter_agg_join_delta_batch(self, fcol, acol, jcol, bounds, rcount,
                                    corr_a, corr_j):
        # on the kernel inner every island's aggregate and join scans with
        # the GLOBAL effective histogram AND both flat overlay corrections
        # ride ONE launch, where the reference composes the sharded join
        # scan and two values deltas (equal answers); other inners keep
        # that composition
        if (not isinstance(self.inner, HopperBackend)
                or (corr_a is None and corr_j is None)):
            return super().filter_agg_join_delta_batch(
                fcol, acol, jcol, bounds, rcount, corr_a, corr_j)
        fv, av, jv = (self._as_view(fcol), self._as_view(acol),
                      self._as_view(jcol))
        code_bounds = [self.code_range(fv, lo, hi) for lo, hi in bounds]
        rc = (jv.dict_counts() if rcount is None else rcount
              ).to(torch.int32)
        return scan_filter_agg_join_group_sharded(
            fv.codes, av.codes, jv.codes, fv.valid, jv.valid, av.dictionary,
            rc, code_bounds, corr_a, corr_j, bounds)

    def hash_join_count(self, left, right, left_mask=None):
        # Each island histograms only its own resident probe-side shard;
        # the build side (the replicated right dictionary's counts) depends
        # only on the pinned data, so it lives on the view
        # (`ShardedView.dict_counts`): built once, reused by every join
        # probing the same snapshot, and dropped with the view at the
        # Phase-2 swap. The match runs once on the inner backend (the hash
        # unit on HopperBackend).
        lview = self._as_view(left)
        lv = lview.dictionary
        lcount = self._view_side_counts(lview, left_mask)
        if right is left:  # the engine's self-join fast path
            right = lview
            rv, rcount = lv, lview.dict_counts()
        elif isinstance(right, (ShardedView, MeshView)):
            rv, rcount = right.dictionary, right.dict_counts()
        else:
            rv, rcount = _side_counts(right, None)
        return self.inner._join_match(lv, rv, lcount, rcount, right)

    @staticmethod
    def _view_side_counts(view: ShardedView, mask) -> torch.Tensor:
        """Per-dictionary-value occurrence counts over the islands' resident
        shards, straight off the stacked tensors; the unmasked histogram is
        the view's cached build side."""
        if mask is None:
            return view.dict_counts()
        keep = view.valid & shard_rows(mask, view.bounds)
        return torch.bincount(view.codes[keep].long(),
                              minlength=view.dict_size).to(torch.int64)

    # -- update propagation: dictionary stages run once (replicated dict) --
    def merge_update_logs(self, logs):
        return self.inner.merge_update_logs(logs)

    def sort_unique(self, values):
        return self.inner.sort_unique(values)

    def merge_dictionaries(self, old_dict, update_dict):
        return self.inner.merge_dictionaries(old_dict, update_dict)

    def sort_unique_batch(self, values_list):
        return self.inner.sort_unique_batch(values_list)

    def merge_dictionaries_batch(self, pairs):
        return self.inner.merge_dictionaries_batch(pairs)

    def staged_encoder(self, new_dict):
        return self.inner.staged_encoder(new_dict)

    def apply_stages_batch(self, per_column):
        # the dictionary is replicated, so the ship batch's fused
        # dictionary pipeline runs once on the inner backend
        return self.inner.apply_stages_batch(per_column)

    def make_encoder(self, dictionary):
        return self.inner.make_encoder(dictionary)

    def encode_values_shards(self, encoder, values_list):
        return self.inner.encode_values_shards(encoder, values_list)

    # -- consistency -------------------------------------------------------
    def snapshot_column(self, col, prev=None):
        # one copy pass over the whole column: the copy unit's chunk carry
        # is position-based, so the result and the launch count equal the
        # one-island backend's
        return self.inner.snapshot_column(col, prev=prev)


# ---------------------------------------------------------------------------
# Analytical islands one per device: the mesh placement (§4, Fig. 5)
# ---------------------------------------------------------------------------

class MeshBackend(ShardedBackend):
    """N analytical islands, island *s* resident on its own device.

    The mesh placement (spec ``"hopper@4/mesh"``): where `ShardedBackend`
    stacks every island's shard on one device, this backend keeps island
    *s*'s shard of each pinned column on ``devices[s]`` (`dsm.MeshView`),
    made once per pinned version (`shard_view`) or, at the Phase-2 swap,
    adopted straight from the per-island apply's shard columns
    (`place_shards`; `application.apply_updates_shards`,
    `ConsistencyManager.on_update_shards`). A scan group is one launch of
    the scan kernel per device over a table of its islands, and the exact
    int64 partials add on island 0's device (`kernels.dict_ops.
    scan_filter_agg_mesh`, `kernels.hash_probe.scan_filter_agg_join_mesh`).

    On the delta plane the overlay corrections, whose stacks are built on
    island 0's device, ride the first scan launch there
    (`scan_filter_agg_group_mesh`, `scan_filter_agg_join_group_mesh`).
    Everything else off the scan plane - log merge, the dictionary stages,
    snapshots, the lone join's match - runs once on the inner backend, on
    island 0's device, where the replica lives. The device list may repeat
    a device: islands sharing a card keep their own shard tensors and
    launches. Only the kernel inner (HopperBackend) drives the mesh, as
    only the reference's Pallas backend does.
    """

    placement = "mesh"

    def __init__(self, inner: str | ExecutionBackend, n_shards: int,
                 devices):
        devices = tuple(resolve_device(d) for d in devices)
        if len(devices) != int(n_shards):
            raise ValueError(f"{len(devices)} island devices for "
                             f"{n_shards} islands")
        super().__init__(inner, n_shards, device=devices[0])
        if not isinstance(self.inner, HopperBackend):
            raise ValueError(_mesh_inner_error(self.inner.name,
                                               self.n_shards))
        self.devices = devices
        self.name = f"{self.inner.name}@{self.n_shards}/mesh"

    # -- the mesh-resident snapshot plane ----------------------------------
    def _place_view(self, shard_cols, snapshot_id: int = -1) -> MeshView:
        return stack_shard_columns(shard_cols, snapshot_id,
                                   devices=self.devices)

    def shard_view(self, col: EncodedColumn, snapshot_id: int = -1
                   ) -> MeshView:
        """Shard once, each island's rows on its own device (a shard
        already there is a slice of the column, not a copy)."""
        return self._place_view(shard_column(col, self.n_shards),
                                snapshot_id)

    def place_shards(self, shard_cols, snapshot_id: int = -1) -> MeshView:
        """Phase-2 residency install: the per-island apply's shard columns
        become the islands' resident view directly - each on its own device
        already, no concat and re-split."""
        return self._place_view(shard_cols, snapshot_id)

    def _as_view(self, col) -> MeshView:
        if isinstance(col, ShardedView):
            raise ValueError(f"backend {self.name!r} scans MeshViews; got a "
                             "stacked ShardedView")
        if isinstance(col, MeshView):
            col.require_fresh()
            if col.n_shards != self.n_shards:
                raise ValueError(
                    f"MeshView has {col.n_shards} islands but backend "
                    f"{self.name!r} has {self.n_shards}")
            return col
        return self.shard_view(col)

    # -- analytical engine: one launch per device, int64 reduction ---------
    def filter_mask(self, col, lo, hi):
        view = self._as_view(col)
        code_lo, code_hi = self.code_range(view, lo, hi)
        return torch.cat([((c >= code_lo) & (c < code_hi) & v).to(self.device)
                          for c, v in zip(view.codes, view.valid)])

    def filter_agg_mask(self, fcol, acol, lo, hi):
        fv, av = self._as_view(fcol), self._as_view(acol)
        [(s, c)] = scan_filter_agg_mesh(fv.codes, av.codes, fv.valid,
                                        av.island_dicts(),
                                        [self.code_range(fv, lo, hi)])
        return s, c, self.filter_mask(fv, lo, hi)

    def filter_agg_batch(self, fcol, acol, bounds):
        fv, av = self._as_view(fcol), self._as_view(acol)
        code_bounds = [self.code_range(fv, lo, hi) for lo, hi in bounds]
        return scan_filter_agg_mesh(fv.codes, av.codes, fv.valid,
                                    av.island_dicts(), code_bounds)

    def filter_agg_join_batch(self, fcol, acol, jcol, bounds, rcount=None):
        # the build side is the view's GLOBAL histogram, replicated to
        # every island once per view (or the delta-corrected override,
        # copied per call), so the per-island join partials sum exactly
        fv, av, jv = (self._as_view(fcol), self._as_view(acol),
                      self._as_view(jcol))
        code_bounds = [self.code_range(fv, lo, hi) for lo, hi in bounds]
        rc = (jv.island_rcounts() if rcount is None
              else replicate(rcount.to(torch.int32), jv.devices))
        return scan_filter_agg_join_mesh(fv.codes, av.codes, jv.codes,
                                         fv.valid, jv.valid,
                                         av.island_dicts(), rc, code_bounds)

    def filter_agg_delta_batch(self, fcol, acol, bounds, corr):
        # the base scan stays on the islands' devices and the flat overlay
        # correction rides the first launch on island 0's device, where the
        # reference adds the inner backend's values delta (equal answers)
        if corr is None:
            return self.filter_agg_batch(fcol, acol, bounds)
        fv, av = self._as_view(fcol), self._as_view(acol)
        code_bounds = [self.code_range(fv, lo, hi) for lo, hi in bounds]
        return scan_filter_agg_group_mesh(fv.codes, av.codes, fv.valid,
                                          av.island_dicts(), code_bounds,
                                          corr, bounds)

    def filter_agg_join_delta_batch(self, fcol, acol, jcol, bounds, rcount,
                                    corr_a, corr_j):
        # the join scan with the effective histogram (replicated to every
        # island per call) on the islands' devices, both corrections a
        # slice of the first launch on island 0's device, where the
        # reference adds two values deltas (equal answers)
        if corr_a is None and corr_j is None:
            return self.filter_agg_join_batch(fcol, acol, jcol, bounds,
                                              rcount=rcount)
        fv, av, jv = (self._as_view(fcol), self._as_view(acol),
                      self._as_view(jcol))
        code_bounds = [self.code_range(fv, lo, hi) for lo, hi in bounds]
        rc = (jv.island_rcounts() if rcount is None
              else replicate(rcount.to(torch.int32), jv.devices))
        return scan_filter_agg_join_group_mesh(
            fv.codes, av.codes, jv.codes, fv.valid, jv.valid,
            av.island_dicts(), rc, code_bounds, corr_a, corr_j, bounds)

    @staticmethod
    def _view_side_counts(view: MeshView, mask) -> torch.Tensor:
        """A join side's occurrence counts: each island's rows (under its
        slice of `mask`) histogrammed on its device, summed on island 0's."""
        if mask is None:
            return view.dict_counts()
        total = torch.zeros(view.dict_size, dtype=torch.int64,
                            device=view.device)
        for s, (c, v) in enumerate(zip(view.codes, view.valid)):
            keep = v & mask[view.bounds[s]:view.bounds[s + 1]].to(v.device)
            total += torch.bincount(c[keep].long(), minlength=view.dict_size
                                    ).to(view.device)
        return total


def _mesh_inner_error(name: str, n: int) -> str:
    return (f"mesh placement runs the scan plane as kernel launches on the "
            f"island devices, which the {name!r} backend does not drive; use "
            f"'hopper@{n}/mesh', or keep {name!r} islands on the stacked "
            f"placement (e.g. '{name}@{n}')")


# ---------------------------------------------------------------------------
# Backend resolution
# ---------------------------------------------------------------------------

BACKENDS: dict[str, type[ExecutionBackend]] = {
    "torch": TorchBackend,
    "hopper": HopperBackend,
}
DEFAULT_BACKEND = "hopper"
# How islands are laid out: "stacked" keeps every island's shard on one
# device (leading-axis launches); "mesh" lays island s on its own device.
PLACEMENTS = ("stacked", "mesh")
_instances: dict[tuple, ExecutionBackend] = {}


@dataclasses.dataclass(frozen=True)
class BackendSpec:
    """``name[@N][/placement]``, parsed: ``name`` a registry key,
    ``n_shards`` the island count (None: not given, so one island),
    ``placement`` the island layout (None:
    "stacked"). ``str()`` gives the string form back."""

    name: str
    n_shards: int | None = None
    placement: str | None = None

    def __post_init__(self):
        if not self.name or not isinstance(self.name, str):
            raise ValueError(
                f"BackendSpec needs a non-empty backend name, got "
                f"{self.name!r} (have {sorted(BACKENDS)})")
        if self.n_shards is not None and int(self.n_shards) < 1:
            raise ValueError(
                f"n_shards must be >= 1, got {self.n_shards} "
                f"(BackendSpec for {self.name!r})")
        if self.placement is not None and self.placement not in PLACEMENTS:
            raise ValueError(
                f"bad placement {self.placement!r} (BackendSpec for "
                f"{self.name!r}); expected one of {list(PLACEMENTS)}")

    def __str__(self) -> str:
        s = self.name
        if self.n_shards is not None:
            s += f"@{self.n_shards}"
        if self.placement is not None:
            s += f"/{self.placement}"
        return s


def parse_backend_spec(spec: str | BackendSpec) -> BackendSpec:
    """Validate a ``"name[@N][/placement]"`` backend spec early.

    Returns a `BackendSpec` (instances pass through). An empty spec or
    name, a non-integer count and an unknown placement raise KeyError
    naming the expected form; a count below 1 raises ValueError.
    """
    if isinstance(spec, BackendSpec):
        return spec
    if not isinstance(spec, str) or not spec:
        raise KeyError(
            f"empty backend spec {spec!r}; expected 'name', 'name@N' or "
            f"'name@N/placement' with name in {sorted(BACKENDS)}, N >= 1 "
            f"and placement in {list(PLACEMENTS)}")
    base, psep, placement = spec.partition("/")
    if psep and placement not in PLACEMENTS:
        raise KeyError(
            f"bad placement {placement!r} in backend spec {spec!r}: "
            f"expected one of {list(PLACEMENTS)} (e.g. 'hopper@4/mesh')")
    name, sep, count = base.partition("@")
    if not name:
        raise KeyError(
            f"backend spec {spec!r} has an empty backend name; expected "
            f"'name', 'name@N' or 'name@N/placement' with name in "
            f"{sorted(BACKENDS)}")
    if not sep:
        return BackendSpec(name, None, placement if psep else None)
    try:
        n = int(count)
    except ValueError:
        raise KeyError(
            f"bad shard count {count!r} in backend spec {spec!r}: expected "
            "a decimal integer >= 1 (e.g. 'hopper@4')") from None
    if n < 1:
        raise ValueError(
            f"n_shards must be >= 1, got {n} (backend spec {spec!r})")
    return BackendSpec(name, n, placement if psep else None)


def get_backend(spec: str | BackendSpec | ExecutionBackend | None = None,
                device=None, n_shards: int | None = None,
                placement: str | None = None,
                devices=None) -> ExecutionBackend:
    """Resolve a backend argument: None -> ``"hopper"``, str -> registry,
    instance -> itself.

    ``n_shards`` > 1 (or ``"name@N"``) wraps the named backend in a
    `ShardedBackend` of N islands stacked on one device; with neither, one
    island. ``placement="mesh"`` (or ``"name@N/mesh"``) makes it a
    `MeshBackend` instead: island s on ``devices[s]``, which default to the
    installed island devices or ``cuda:0 .. cuda:N-1``
    (`distributed.island_mesh`; a list may repeat a device, and gives the
    island count when the spec does not). A counted spec with a
    contradicting explicit ``n_shards`` raises, as does an instance whose
    island count, placement or devices contradict an explicit argument.
    ``device=None`` means the GPU and raises when CUDA is not available; a
    mesh backend's device is island 0's. Equal resolutions share one
    instance, keyed by (name, N, placement, devices).
    """
    if isinstance(spec, ExecutionBackend):
        if device is not None and resolve_device(device) != spec.device:
            raise ValueError(
                f"backend instance {spec.name!r} lives on {spec.device} but "
                f"device={device!r} was requested")
        if n_shards is not None and int(n_shards) != spec.n_shards:
            raise ValueError(
                f"backend instance {spec.name!r} has {spec.n_shards} "
                f"shard(s) but n_shards={n_shards} was requested; pass the "
                "spec by name (e.g. 'hopper') to let n_shards wrap it")
        if placement is not None and placement != spec.placement:
            raise ValueError(
                f"backend instance {spec.name!r} uses the "
                f"{spec.placement!r} placement but placement={placement!r} "
                "was requested")
        if devices is not None and tuple(
                resolve_device(d) for d in devices) != getattr(
                    spec, "devices", None):
            raise ValueError(
                f"backend instance {spec.name!r} has island devices "
                f"{getattr(spec, 'devices', None)} but devices={devices!r} "
                "was requested")
        return spec
    from_default = spec is None
    parsed = parse_backend_spec(DEFAULT_BACKEND if from_default else spec)
    name = parsed.name
    if parsed.n_shards is not None:
        if n_shards is None:
            n_shards = parsed.n_shards
        elif int(n_shards) != parsed.n_shards:
            raise ValueError(f"backend spec {str(parsed)!r} contradicts "
                             f"n_shards={n_shards}")
    if parsed.placement is not None:
        if placement is None:
            placement = parsed.placement
        elif placement != parsed.placement:
            raise ValueError(f"backend spec {str(parsed)!r} contradicts "
                             f"placement={placement!r}")
    try:
        cls = BACKENDS[name]
    except KeyError:
        raise KeyError(f"unknown backend {name!r}; have {sorted(BACKENDS)}"
                       ) from None
    if placement not in (None, *PLACEMENTS):
        raise ValueError(f"bad placement {placement!r} (backend spec/"
                         f"argument for {name!r}); expected one of "
                         f"{list(PLACEMENTS)}")
    if n_shards is None and devices is not None and placement == "mesh":
        n_shards = len(devices)
    n = 1 if n_shards is None else int(n_shards)
    if n < 1:
        raise ValueError(f"n_shards must be >= 1, got {n} (backend spec/"
                         f"argument for {name!r})")
    if placement == "mesh":
        # a one-island mesh is legal: the scan plane still takes the mesh
        # entry points, so the placement's semantics do not change with N
        if not issubclass(cls, HopperBackend):
            raise ValueError(_mesh_inner_error(name, n))
        devs = island_mesh(n, devices)
        if device is not None and resolve_device(device) != devs[0]:
            raise ValueError(f"device={device!r} is not island 0's device "
                             f"{devs[0]} (a mesh backend lives on island 0)")
        key = (name, n, "mesh", tuple(str(d) for d in devs))
        if key not in _instances:
            _instances[key] = MeshBackend(name, n, devs)
        return _instances[key]
    if devices is not None:
        raise ValueError("devices= lists the islands' devices of the mesh "
                         f"placement; backend {str(parsed)!r} is stacked "
                         "(use e.g. 'hopper@4/mesh')")
    dev = resolve_device(device)
    key = (name, n, "stacked", (str(dev),))
    if key not in _instances:
        _instances[key] = (cls(dev) if n == 1
                           else ShardedBackend(name, n, device=dev))
    return _instances[key]
