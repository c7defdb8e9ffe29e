"""Public wrappers for the merge unit (``csrc/merge_runs.cu``).

Keys are full-width int64 commit ids (or dictionary values) compared
natively; every entry carries an int32 source index through the merge, with
which callers gather payloads. `merge_sorted_runs` merges k runs in one
launch (`merge_runs_kway`); `merge_sorted_pair(s)` merge rows of
independent pairs in one launch (`merge_runs`). Both are stable (equal keys
keep run order) and need no padding of their own, so no key value is
special - a key equal to int64.max merges like any other.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import (I64_MAX, check_tensor, count_launch,
                                        from_host, on_gpu)


def _as_keys(run, device=None) -> torch.Tensor:
    if isinstance(run, torch.Tensor):
        t = run.reshape(-1).to(torch.int64)
    else:
        t = from_host(np.asarray(run).reshape(-1), np.int64)
    return t if device is None else t.to(device)


def merge_pair_ref(a, b, ai, bi):
    """Plain PyTorch version of `merge_sorted_pair`: a stable sort of the
    concatenation."""
    keys = torch.cat([a.to(torch.int64), b.to(torch.int64)], dim=-1)
    idxs = torch.cat([ai.to(torch.int32), bi.to(torch.int32)], dim=-1)
    skeys, order = torch.sort(keys, dim=-1, stable=True)
    return skeys, torch.gather(idxs, -1, order)


def merge_runs_ref(runs):
    """Plain version of `merge_sorted_runs` over int64 key tensors."""
    if not runs:
        return (torch.empty(0, dtype=torch.int64),
                torch.empty(0, dtype=torch.int32))
    cat = torch.cat(runs)
    skeys, order = torch.sort(cat, stable=True)
    return skeys, order.to(torch.int32)


MAX_RUNS = 64    # runs one k-way launch takes (csrc/merge_runs.cu)


def launch_merge_runs(a, ai, b, bi, out_keys, out_idx) -> None:
    """The bare row-wise pair merge on checked GPU tensors with
    preallocated outputs. No allocation, no synchronisation."""
    build.launch("merge_runs", a.device, a.data_ptr(), ai.data_ptr(),
                 b.data_ptr(), bi.data_ptr(), out_keys.data_ptr(),
                 out_idx.data_ptr(), a.shape[0], a.shape[1], b.shape[1])


def run_offsets(lens) -> ctypes.Array:
    """The k + 1 run offsets of runs of `lens` entries, as the k-way
    launch takes them (host memory, passed in the launch's parameters)."""
    offs = [0]
    for n in lens:
        offs.append(offs[-1] + int(n))
    return (ctypes.c_int * len(offs))(*offs)


def launch_merge_kway(keys, offsets, out_keys, out_idx) -> None:
    """The bare k-way merge of the runs of `keys` (int64, 1-D, checked GPU
    tensor) that `offsets` (`run_offsets`, at most MAX_RUNS runs) marks,
    into preallocated outputs. No allocation, no synchronisation."""
    build.launch("merge_runs_kway", keys.device, keys.data_ptr(), offsets,
                 len(offsets) - 1, out_keys.data_ptr(), out_idx.data_ptr())


def merge_sorted_pair(a, b, ai, bi):
    """Merge two ascending (rows, wa) / (rows, wb) int64 key runs with
    their int32 index lanes -> ((rows, wa + wb) keys, indices)."""
    if not on_gpu(a, b, ai, bi):
        return merge_pair_ref(a, b, ai, bi)
    for t, dt, name in ((a, torch.int64, "a"), (b, torch.int64, "b"),
                        (ai, torch.int32, "ai"), (bi, torch.int32, "bi")):
        check_tensor(t, dt, name, 2)
    rows, wa = a.shape
    wb = b.shape[1]
    if b.shape[0] != rows or ai.shape != a.shape or bi.shape != b.shape:
        raise ValueError("run and index shapes do not line up")
    out_keys = torch.empty((rows, wa + wb), dtype=torch.int64, device=a.device)
    out_idx = torch.empty((rows, wa + wb), dtype=torch.int32, device=a.device)
    if rows == 0 or wa + wb == 0:
        return out_keys, out_idx
    launch_merge_runs(a, ai, b, bi, out_keys, out_idx)
    count_launch("merge_runs", (rows, wa, wb))
    return out_keys, out_idx


def _merge_kway(cat, lens):
    """One launch for up to MAX_RUNS runs; more runs are merged in groups
    of MAX_RUNS, then the groups' results (a launch each, and one more)."""
    n = cat.shape[0]
    if n >= 2**31:
        raise ValueError(f"merge_sorted_runs: {n} entries exceed int32 "
                         "source indices")
    if n == 0 or len(lens) == 1:
        return cat, torch.arange(n, dtype=torch.int32, device=cat.device)
    if len(lens) > MAX_RUNS:
        starts = np.cumsum([0] + list(lens))
        keys, srcs = [], []
        for g in range(0, len(lens), MAX_RUNS):
            lo, hi = int(starts[g]), int(starts[min(g + MAX_RUNS, len(lens))])
            k, s = _merge_kway(cat[lo:hi], lens[g:g + MAX_RUNS])
            keys.append(k)
            srcs.append(s + lo)
        merged, top = _merge_kway(torch.cat(keys), [k.shape[0] for k in keys])
        return merged, torch.cat(srcs)[top.long()]
    out_keys = torch.empty_like(cat)
    out_idx = torch.empty(n, dtype=torch.int32, device=cat.device)
    launch_merge_kway(cat, run_offsets(lens), out_keys, out_idx)
    count_launch("merge_runs", (len(lens), n))
    return out_keys, out_idx


def merge_sorted_runs(runs, device=None):
    """K-way merge (the comparator tree) in one launch.

    runs: list of 1-D ascending integer key arrays (numpy or tensors;
    per-thread update logs - int64 commit ids are first-class). `device`
    says where to merge (default: where the runs lie). Returns
    (merged_keys int64, merged_source_index int32) on that device, where
    source index is the position in the concatenated input - callers
    gather payloads with it. Equal keys keep run order.
    """
    keys = [_as_keys(r) for r in runs]
    if not keys:
        return merge_runs_ref(keys)
    if device is None:
        device = keys[0].device
    cat = torch.cat(keys).to(device)        # one host-to-device copy
    if not on_gpu(cat):
        return merge_runs_ref([cat])
    return _merge_kway(cat, [int(k.shape[0]) for k in keys])


def merge_sorted_pairs(a_list, b_list, device=None):
    """Merge C independent ascending (a_i, b_i) run pairs in ONE launch:
    pair i rides row i, padded to the widest pair with int64.max keys that
    sort to the row's tail and are trimmed off.

    Values only - no payload indices come back. Returns the merged int64
    key tensors, each of exact length len(a_i) + len(b_i).
    """
    a64 = [_as_keys(a, device) for a in a_list]
    b64 = [_as_keys(b, device) for b in b_list]
    rows = len(a64)
    if rows == 0:
        return []
    dev = a64[0].device
    wa = max(max(a.shape[0] for a in a64), 1)
    wb = max(max(b.shape[0] for b in b64), 1)
    ak = torch.full((rows, wa), I64_MAX, dtype=torch.int64, device=dev)
    bk = torch.full((rows, wb), I64_MAX, dtype=torch.int64, device=dev)
    ai = torch.full((rows, wa), -1, dtype=torch.int32, device=dev)
    bi = torch.full((rows, wb), -1, dtype=torch.int32, device=dev)
    for i, (a, b) in enumerate(zip(a64, b64)):
        ak[i, :a.shape[0]] = a
        bk[i, :b.shape[0]] = b
    merged, _ = merge_sorted_pair(ak, bk, ai, bi)
    return [merged[i, :a.shape[0] + b.shape[0]]
            for i, (a, b) in enumerate(zip(a64, b64))]
