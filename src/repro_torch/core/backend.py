"""Execution backends: plain PyTorch reference vs hand-written Hopper kernels.

Polynesia's speedups come from specialized in-memory hardware; this port
models those units as CUDA kernels. The hot path (engine, shipping, update
application, consistency) is written against the small operator surface
below, so the same code runs either on

* ``TorchBackend`` (``"torch"``) - plain PyTorch ops, the functional
  reference the kernels are held against, or
* ``HopperBackend`` (``"hopper"``) - dispatching each operator to its
  hardware-analog kernel:

    ==========================  =================================
    operator                    kernel
    ==========================  =================================
    filter + aggregate          kernels/dict_ops.scan_filter_agg
                                (+ _batch for fused multi-query)
    filter + aggregate + join   kernels/hash_probe.scan_filter_agg_join
    update-log / dict merge     kernels/merge_runs
    update-dictionary sort      kernels/bitonic_sort
    sort + merge, per batch     kernels/dict_ops.apply_pipeline_batch
    snapshot copy               kernels/snapshot_copy
    ==========================  =================================

Every backend must produce *bit-identical* results: the integer query
answers, merged logs, dictionaries and snapshots are asserted equal across
backends in the tests. A backend is bound to one device at construction
(``get_backend(spec, device)``); ``device=None`` means the GPU and raises
when there is none. Columns and dictionaries are tensors on that device;
update logs are host numpy records (the transactional island is the host).

Islands (``"hopper@N"``), mesh placement (``"/mesh"``) and the delta-store
and view operators are not ported yet and raise ``NotImplementedError``.
"""

from __future__ import annotations

import abc
import contextlib
import sys
from typing import Callable, Iterable, Sequence

import numpy as np
import torch

from repro_torch.core.dsm import EncodedColumn
from repro_torch.core.nsm import UPDATE_DTYPE
from repro_torch.kernels.bitonic_sort import sort_1024, sort_rows
from repro_torch.kernels.common import (I32_MAX, from_host, resolve_device,
                                        width_bucket)
from repro_torch.kernels.dict_ops import (apply_pipeline_batch,
                                          scan_filter_agg,
                                          scan_filter_agg_batch)
from repro_torch.kernels.hash_probe import scan_filter_agg_join
from repro_torch.kernels.merge_runs import merge_sorted_pairs, merge_sorted_runs
from repro_torch.kernels.snapshot_copy import snapshot_copy

SNAPSHOT_BLOCK = 8192  # copy-unit chunk size (kernels/snapshot_copy default)

# Every kernel entry point this module dispatches to, by the module-global
# name used at the call site. `counting_kernel_calls` (and the tests'
# monkeypatch wrappers) wrap exactly these names - keep it next to the
# imports so adding a kernel here keeps the count honest.
KERNEL_ENTRY_POINTS = ("scan_filter_agg", "scan_filter_agg_batch",
                       "scan_filter_agg_join", "merge_sorted_runs",
                       "merge_sorted_pairs", "sort_1024", "sort_rows",
                       "snapshot_copy", "apply_pipeline_batch")


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

    def _join_match(self, lv, rv, lcount, rcount):
        """Match pre-grouped dictionary counts (the join's build+probe):
        both dictionaries are sorted and distinct, so each left value has
        at most one partner, found by binary search."""
        if lv.shape[0] == 0 or rv.shape[0] == 0:
            return 0
        pos = torch.searchsorted(rv, lv).clamp_(max=rv.shape[0] - 1)
        hit = rv[pos] == lv
        return int((lcount[hit] * rcount[pos[hit]]).sum())

    def hash_join_count(self, left, right, left_mask=None):
        lv, lcount = _side_counts(left, left_mask)
        rv, rcount = _side_counts(right, None)
        return self._join_match(lv, rv, lcount, rcount)

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
                             _host_dict=col._host_dict)


class HopperBackend(TorchBackend):
    """Dispatches the hot path to the hand-written CUDA kernels.

    Inherits the plain glue (bincounts, grouping, masks) - the paper's
    fixed-function units do the data-plane work while small control-plane
    steps stay plain. Where a fused kernel's precondition can't hold (a
    value colliding with the int32.max sentinel pad, an empty side, fewer
    than two fusable columns) the batch takes the unfused kernels (sort
    unit, then the 64-bit merge unit), and an empty side needs no kernel at
    all; every such path keeps results identical. Values beyond int32
    (which no session produces: update values and dictionaries are int32)
    are refused on the GPU rather than handed to a library sort. On CPU
    tensors each kernel wrapper runs its plain version, which is how the
    tests drive this class.

    `hash_join_count` (lone join queries) still matches dictionaries with
    the inherited binary search: the bucket-probe kernel is not ported yet
    (ROADMAP.md queue 2, K8). Query groups never reach it - their join is
    the fused scan below.
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
        merge dispatches of the batched composition. The old-dictionary and
        value sides get independent `common.width_bucket` widths, so the
        sort runs at the (usually small) value width instead of the
        dictionary width.

        Columns the fused pipeline can't take - an empty side (nothing to
        sort or merge), values beyond int32, or values colliding with the
        int32.max sentinel pad - fall back to the compositional default,
        as does a batch with fewer than two fusable columns. Results are
        elementwise identical either way."""
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
        if len(fused) < 2:
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
            o = cols[i][0]
            out[i] = self._stage_entry(u, nd.to(o.dtype), o)
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
        else:
            dirty = torch.ones(n_chunks, dtype=torch.bool, device=src.device)
            prev_arr = col.codes
        codes = snapshot_copy(src, prev_arr, dirty, block=SNAPSHOT_BLOCK)
        # the copy is a fresh tensor; dictionary and valid are aliased,
        # which is safe because installed columns are never written in place
        return EncodedColumn(codes=codes, dictionary=col.dictionary,
                             valid=col.valid, version=col.version,
                             _host_dict=col._host_dict)


# ---------------------------------------------------------------------------
# Backend resolution
# ---------------------------------------------------------------------------

BACKENDS: dict[str, type[ExecutionBackend]] = {
    "torch": TorchBackend,
    "hopper": HopperBackend,
}
DEFAULT_BACKEND = "hopper"
_instances: dict[tuple[str, str], ExecutionBackend] = {}


def parse_backend_spec(spec: str) -> str:
    """``name[@N][/placement]`` -> name, for the part of the grammar this
    port supports: one island, stacked placement."""
    name, _, placement = spec.partition("/")
    name, _, count = name.partition("@")
    if count:
        try:
            n = int(count)
        except ValueError:
            raise ValueError(
                f"bad backend spec {spec!r}: shard count {count!r} is not "
                "an integer (expected e.g. 'hopper@4')") from None
        if n < 1:
            raise ValueError(f"bad backend spec {spec!r}: shard count must "
                             "be >= 1")
        if n > 1:
            raise NotImplementedError(
                f"backend spec {spec!r}: analytical islands (@N) are not "
                "ported yet - ROADMAP.md queue 1, item 8 (stacked islands)")
    if placement not in ("", "stacked"):
        if placement == "mesh":
            raise NotImplementedError(
                f"backend spec {spec!r}: mesh placement is not ported yet - "
                "ROADMAP.md queue 1, item 13 (multi-GPU islands)")
        raise ValueError(f"bad backend spec {spec!r}: unknown placement "
                         f"{placement!r}")
    return name


def get_backend(spec: str | ExecutionBackend | None = None,
                device=None) -> ExecutionBackend:
    """Resolve a backend argument: None -> ``"hopper"``, str -> registry,
    instance -> itself. ``device=None`` means the GPU and raises when CUDA
    is not available; an instance keeps the device it was built on (a
    contradicting explicit ``device`` raises)."""
    if isinstance(spec, ExecutionBackend):
        if device is not None and resolve_device(device) != spec.device:
            raise ValueError(
                f"backend instance {spec.name!r} lives on {spec.device} but "
                f"device={device!r} was requested")
        return spec
    name = parse_backend_spec(DEFAULT_BACKEND if spec is None else spec)
    try:
        cls = BACKENDS[name]
    except KeyError:
        raise KeyError(f"unknown backend {name!r}; have {sorted(BACKENDS)}"
                       ) from None
    dev = resolve_device(device)
    key = (name, str(dev))
    if key not in _instances:
        _instances[key] = cls(dev)
    return _instances[key]
