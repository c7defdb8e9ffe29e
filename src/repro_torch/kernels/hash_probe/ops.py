"""The hash lookup unit: bucket table build + probe, and the join-group scans.

* `build_table` lays unique int32 keys into a fixed-slot open-bucket table
  on the host (numpy, as the reference builds it: once per dictionary);
  `HashTable.on(device)` copies it to a device once per table.
* `probe` / `probe_sharded` look queries up in it with the CUDA kernel
  ``csrc/hash_probe.cu`` (one launch; the sharded form probes every
  island's queries, stack-padded, in the same launch). `probe_ref` is the
  plain PyTorch version.
* `scan_filter_agg_join` / `scan_filter_agg_join_sharded`: the join-group
  scan. The self-join cardinality of a predicate's rows against the whole
  column is ``sum(rcount[jcodes[mask & jvalid]])`` with ``rcount`` the
  build-side occurrence histogram, i.e. a second exact scan with the
  histogram as the dictionary. ``csrc/scan_exact.cu`` answers both lanes in
  one pass, reading the filter column once; the sharded form takes the
  GLOBAL histogram, so the per-island join partials sum exactly.
* `scan_filter_agg_join_group`: the join group on the delta plane - the
  same scan with the EFFECTIVE histogram plus the correction lane over the
  aggregate stack and the join-weight stack, in one launch; over stacked
  shards `scan_filter_agg_join_group_sharded`, also one launch.
* `scan_filter_agg_join_mesh`: the join group on the mesh placement - one
  launch of the same scan per device over a table of its islands, and the
  devices' exact int64 partials added on island 0's device; on the delta
  plane `scan_filter_agg_join_group_mesh`, the correction a slice of the
  first launch on island 0's device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import (check_tensor, count_launch,
                                        next_pow2, on_gpu)
from repro_torch.kernels.dict_ops.ops import (_pairs, _per_shard,
                                              scan_exact, scan_exact_group,
                                              scan_exact_group_ref,
                                              scan_exact_mesh,
                                              scan_exact_mesh_ref,
                                              scan_exact_ref)

EMPTY = -2**31                       # reserved free-slot key (int32.min)


@dataclasses.dataclass
class HashTable:
    keys: np.ndarray     # (n_buckets, slots) int32, EMPTY = free
    values: np.ndarray   # (n_buckets, slots) int32
    # the table's copies on devices, made once each by `on`
    _on: dict = dataclasses.field(default_factory=dict, repr=False,
                                  compare=False)

    @property
    def n_buckets(self) -> int:
        return self.keys.shape[0]

    def on(self, device) -> tuple[torch.Tensor, torch.Tensor]:
        """(keys, values) as tensors on `device` (copied once)."""
        dev = device if isinstance(device, torch.device) \
            else torch.device(device)
        pair = self._on.get(dev)
        if pair is None:
            pair = self._on[dev] = (torch.from_numpy(self.keys).to(dev),
                                    torch.from_numpy(self.values).to(dev))
        return pair


def _keys_unique(keys: np.ndarray) -> bool:
    """Uniqueness check with a fast path for strictly ascending keys (most
    tables are built over dictionaries, which are)."""
    if keys.size <= 1:
        return True
    if bool(np.all(np.diff(keys) > 0)):
        return True
    return len(np.unique(keys)) == len(keys)


_tables_built = 0


def tables_built() -> int:
    """Bucket tables `build_table` has built in this process."""
    return _tables_built


def build_table(keys: np.ndarray, values: np.ndarray,
                load_factor: float = 0.5, min_slots: int = 4) -> HashTable:
    """Build the fixed-slot bucket table on the host: pow2 bucket count at
    `load_factor`, slots grown until the fullest bucket fits, padded to a
    multiple of 4 (the kernel's 16-byte loads)."""
    global _tables_built
    _tables_built += 1
    keys = np.asarray(keys, dtype=np.int32)
    values = np.asarray(values, dtype=np.int32)
    if not _keys_unique(keys):
        raise ValueError("hash table keys must be unique")
    n = max(len(keys), 1)
    n_buckets = max(8, int(2 ** np.ceil(np.log2(n / load_factor))))
    bucket = keys.astype(np.int64) % n_buckets
    counts = np.bincount(bucket, minlength=n_buckets)
    slots = max(min_slots, int(counts.max()) if len(keys) else min_slots)
    slots = int(np.ceil(slots / 4) * 4)
    tk = np.full((n_buckets, slots), EMPTY, dtype=np.int32)
    tv = np.zeros((n_buckets, slots), dtype=np.int32)
    # slot = rank within the bucket: position minus the bucket's start in a
    # stable bucket order (narrow ids take numpy's radix sort)
    narrow = bucket.astype(np.uint16) if n_buckets <= (1 << 16) else bucket
    order = np.argsort(narrow, kind="stable")
    sorted_bucket = bucket[order]
    starts = np.cumsum(counts) - counts
    rank = np.arange(len(keys), dtype=np.int64) - starts[sorted_bucket]
    tk[sorted_bucket, rank] = keys[order]
    tv[sorted_bucket, rank] = values[order]
    return HashTable(tk, tv)


def probe_ref(table_keys, table_vals, queries, default: int = -1
              ) -> torch.Tensor:
    """Plain PyTorch version of the probe kernel, for queries of any shape:
    the same bucket rule, slot compare and maximum over the hits."""
    n_buckets = table_keys.shape[0]
    q = queries.to(torch.int64)
    bucket = torch.fmod(q, n_buckets)              # truncates, like lax.rem
    bucket = torch.where(bucket < 0, bucket + n_buckets, bucket)
    hit = table_keys[bucket] == queries.unsqueeze(-1)
    val = torch.where(hit, table_vals[bucket],
                      torch.tensor(EMPTY, dtype=torch.int32,
                                   device=queries.device)).amax(dim=-1)
    return torch.where(hit.any(dim=-1), val,
                       torch.tensor(int(default), dtype=torch.int32,
                                    device=queries.device))


def launch_hash_probe(queries, keys, vals, default: int, out) -> None:
    """The bare launch of ``hash_probe`` on checked GPU tensors: queries and
    out (n,) or (S, W) int32, keys and vals (n_buckets, slots) int32. No
    allocation, no synchronisation (`build.launch`)."""
    shape = queries.shape
    n_buckets, slots = keys.shape
    build.launch("hash_probe", queries.device, queries.data_ptr(),
                 shape[0] if len(shape) == 2 else 1, shape[-1],
                 keys.data_ptr(), vals.data_ptr(), n_buckets, slots,
                 int(default), out.data_ptr())


def _probe(table: HashTable, queries: torch.Tensor, default: int
           ) -> torch.Tensor:
    """Probe (n,) or (S, W) int32 queries on their device."""
    keys, vals = table.on(queries.device)     # on the queries' device
    if not on_gpu(queries):
        return probe_ref(keys, vals, queries, default)
    check_tensor(queries, torch.int32, "queries", queries.dim())
    out = torch.empty_like(queries)
    if queries.numel() == 0:
        return out
    launch_hash_probe(queries, keys, vals, default, out)
    count_launch("hash_probe", (queries.shape[0] if queries.dim() == 2
                                else 1, queries.shape[-1]) + keys.shape)
    return out


def probe(table: HashTable, queries: torch.Tensor, default: int = -1
          ) -> torch.Tensor:
    """Look up each query's value (keys are unique); a miss gives
    `default`. `queries`: a 1-D int32 tensor; the result is an int32
    tensor on its device."""
    if queries.dim() != 1:
        raise ValueError(f"queries: expected (n,), got {tuple(queries.shape)}")
    return _probe(table, queries, default)


def probe_sharded(table: HashTable, query_batches, default: int = -1
                  ) -> list[torch.Tensor]:
    """Probe every island's query batch in ONE launch (leading shard axis).

    query_batches: per-island 1-D int32 tensors on one device (ragged
    lengths allowed: they are stacked into (S, next_pow2(longest)) with 0
    padding, and the padded lookups are dropped). Returns the per-island
    results, elementwise equal to calling `probe` once per island.
    """
    batches = list(query_batches)
    lens = [int(q.shape[0]) for q in batches]
    width = max(lens, default=0)
    if width == 0:
        return [q.new_empty(0) for q in batches] if batches else []
    stacked = torch.zeros((len(batches), next_pow2(width)), dtype=torch.int32,
                          device=batches[0].device)
    for s, q in enumerate(batches):
        stacked[s, :lens[s]] = q
    out = _probe(table, stacked, default)
    return [out[s, :lens[s]] for s in range(len(batches))]


def scan_filter_agg_join_ref(fcodes, acodes, jcodes, fvalid, jvalid, adict,
                             rcount, bounds):
    """Plain version of `scan_filter_agg_join`."""
    sums, counts, jsums = scan_exact_ref(fcodes, acodes, fvalid, adict,
                                         list(bounds), jcodes, jvalid,
                                         rcount).tolist()
    return list(zip(sums, counts, jsums))


def scan_filter_agg_join(fcodes, acodes, jcodes, fvalid, jvalid, adict,
                         rcount, bounds):
    """One join-query group in ONE launch (flat columns).

    For every (code_lo, code_hi) in `bounds` returns the exact
    ``(sum, count, join_count)`` triple, where sum/count aggregate
    ``adict[acodes]`` over the filter mask and join_count is the self-join
    cardinality against the build-side histogram `rcount` (int32, one
    occurrence count per join-dictionary value, valid rows only).
    """
    bounds = list(bounds)
    if fcodes.shape[0] == 0 or not bounds:
        return [(0, 0, 0) for _ in bounds]
    sums, counts, jsums = scan_exact(fcodes, acodes, fvalid, adict, bounds,
                                     jcodes, jvalid, rcount).tolist()
    return list(zip(sums, counts, jsums))


def scan_filter_agg_join_sharded_ref(fcodes, acodes, jcodes, fvalid, jvalid,
                                     adict, rcount, bounds):
    """Plain version of `scan_filter_agg_join_sharded`."""
    return _per_shard(scan_exact_ref(fcodes, acodes, fvalid, adict,
                                     list(bounds), jcodes, jvalid, rcount))


def scan_filter_agg_join_sharded(fcodes, acodes, jcodes, fvalid, jvalid,
                                 adict, rcount, bounds):
    """Every island's join-query group in ONE launch (stacked shards).

    Arrays are (n_shards, width) resident shards (padded slots carry
    valid = 0); `rcount` is the GLOBAL build-side histogram (summed across
    islands, e.g. ``ShardedView.dict_counts``), so each island's partial
    join count probes the full build side and the cross-island reduction
    is a plain exact sum. Returns ``[[(sum, count, join_count)] * Q] *
    n_shards``.
    """
    n_shards, width = fcodes.shape
    bounds = list(bounds)
    if width == 0 or not bounds:
        return [[(0, 0, 0)] * len(bounds) for _ in range(n_shards)]
    return _per_shard(scan_exact(fcodes, acodes, fvalid, adict, bounds,
                                 jcodes, jvalid, rcount))


def _join_group(fcodes, acodes, jcodes, fvalid, jvalid, adict, rcount,
                code_bounds, corr_a, corr_j, vbounds, scan):
    nq = len(code_bounds)
    if nq == 0:
        return []
    if fcodes.shape[0] == 0:
        return [(0, 0, 0)] * nq
    return _pairs(scan(fcodes, acodes, fvalid, adict, list(code_bounds),
                       corr_a, list(vbounds), jcodes, jvalid, rcount,
                       corr_j).sum(0))


def scan_filter_agg_join_group_ref(fcodes, acodes, jcodes, fvalid, jvalid,
                                   adict, rcount, code_bounds, corr_a,
                                   corr_j, vbounds):
    """Plain version of `scan_filter_agg_join_group`."""
    return _join_group(fcodes, acodes, jcodes, fvalid, jvalid, adict, rcount,
                       code_bounds, corr_a, corr_j, vbounds,
                       scan_exact_group_ref)


def scan_filter_agg_join_group(fcodes, acodes, jcodes, fvalid, jvalid,
                               adict, rcount, code_bounds, corr_a, corr_j,
                               vbounds):
    """One join-query group on the delta plane - aggregate and self-join
    scans PLUS both overlay corrections - in ONE launch (flat columns).

    `corr_a` is the (6, nr) aggregate correction stack (as
    `dict_ops.scan_filter_agg_group`); `corr_j` carries ``[fv_eff, w_eff,
    valid_eff, fv_base, w_base, valid_base]``, the w lanes being each
    overlay row's effective join-histogram weight, of which only the sum
    delta applies (to the join count). Either may be None. `rcount` must
    already be the EFFECTIVE (delta-corrected) int32 histogram. Returns
    [(sum, count, join_count)] with the corrections folded."""
    return _join_group(fcodes, acodes, jcodes, fvalid, jvalid, adict, rcount,
                       code_bounds, corr_a, corr_j, vbounds,
                       scan_exact_group)


def _join_group_sharded(fcodes, acodes, jcodes, fvalid, jvalid, adict,
                        rcount, code_bounds, corr_a, corr_j, vbounds, scan):
    if fcodes.dim() != 2:
        raise ValueError(f"fcodes: expected (n_shards, width), got shape "
                         f"{tuple(fcodes.shape)}")
    if not code_bounds:
        return []
    return _pairs(scan(fcodes, acodes, fvalid, adict, list(code_bounds),
                       corr_a, list(vbounds), jcodes, jvalid, rcount,
                       corr_j).sum(0))


def scan_filter_agg_join_group_sharded_ref(fcodes, acodes, jcodes, fvalid,
                                           jvalid, adict, rcount, code_bounds,
                                           corr_a, corr_j, vbounds):
    """Plain version of `scan_filter_agg_join_group_sharded`."""
    return _join_group_sharded(fcodes, acodes, jcodes, fvalid, jvalid, adict,
                               rcount, code_bounds, corr_a, corr_j, vbounds,
                               scan_exact_group_ref)


def scan_filter_agg_join_group_sharded(fcodes, acodes, jcodes, fvalid,
                                       jvalid, adict, rcount, code_bounds,
                                       corr_a, corr_j, vbounds):
    """Sharded sibling of `scan_filter_agg_join_group`: every island's
    aggregate and self-join scans over the stacked (n_shards, width)
    shards and both corrections over the flat (global) overlay stacks, in
    ONE launch (counted as ``scan_exact_join_group_sharded``). `rcount` is
    the GLOBAL effective build-side histogram (int32), so the per-island
    join partials sum exactly. Returns the reduced ``[(sum, count,
    join_count)]`` with the corrections folded: equal to
    `scan_filter_agg_join_sharded` reduced plus two values deltas."""
    return _join_group_sharded(fcodes, acodes, jcodes, fvalid, jvalid, adict,
                               rcount, code_bounds, corr_a, corr_j, vbounds,
                               scan_exact_group)


def scan_filter_agg_join_mesh_ref(fcodes, acodes, jcodes, fvalid, jvalid,
                                  adict, rcount, bounds):
    """Plain version of `scan_filter_agg_join_mesh`."""
    return _pairs(scan_exact_mesh_ref(fcodes, acodes, fvalid, adict,
                                      list(bounds), jcodes, jvalid, rcount))


def scan_filter_agg_join_mesh(fcodes, acodes, jcodes, fvalid, jvalid, adict,
                              rcount, bounds):
    """Every island's join-query group on its OWN device, reduced.

    The mesh sibling of `scan_filter_agg_join_sharded`: each argument is a
    sequence of one flat tensor per island on that island's device; `adict`
    and `rcount` are the replicated dictionary and the GLOBAL build-side
    histogram (int32, e.g. ``MeshView.island_rcounts``), so each island's
    partial join count probes the full build side. One launch of the scan
    with its join lane per device for up to 16 of its islands (the island
    table), the devices' partials added exactly on island 0's device.
    Returns ``[(sum, count, join_count)] * Q`` as exact Python
    ints."""
    bounds = list(bounds)
    if not bounds:
        return []
    return _pairs(scan_exact_mesh(fcodes, acodes, fvalid, adict, bounds,
                                  jcodes, jvalid, rcount))


def scan_filter_agg_join_group_mesh_ref(fcodes, acodes, jcodes, fvalid,
                                        jvalid, adict, rcount, code_bounds,
                                        corr_a, corr_j, vbounds):
    """Plain version of `scan_filter_agg_join_group_mesh`: each island's
    plain join scan, summed on island 0's device, plus both corrections
    there."""
    if not code_bounds:
        return []
    return _pairs(scan_exact_mesh_ref(fcodes, acodes, fvalid, adict,
                                      list(code_bounds), jcodes, jvalid,
                                      rcount, corr_a, corr_j, list(vbounds)))


def scan_filter_agg_join_group_mesh(fcodes, acodes, jcodes, fvalid, jvalid,
                                    adict, rcount, code_bounds, corr_a,
                                    corr_j, vbounds):
    """The mesh sibling of `scan_filter_agg_join_group_sharded`: per-island
    sequences as `scan_filter_agg_join_mesh` takes them, `rcount` each
    island's copy of the GLOBAL effective histogram, and the stacks
    `corr_a` / `corr_j` (either may be None) on island 0's device. One
    launch per device and group of its islands, both corrections a slice of
    the first launch on island 0's device. Returns ``[(sum, count,
    join_count)]`` with the corrections folded."""
    if not code_bounds:
        return []
    return _pairs(scan_exact_mesh(fcodes, acodes, fvalid, adict,
                                  list(code_bounds), jcodes, jvalid, rcount,
                                  corr_a, corr_j, list(vbounds)))
