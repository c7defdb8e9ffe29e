"""Public wrappers for the merge unit (``csrc/merge_runs.cu``).

Keys are full-width int64 commit ids (or dictionary values) compared
natively; every entry carries an int32 source index through the merge, with
which callers gather payloads. The kernel is stable (equal keys keep run A
first) and needs no padding of its own, so no key value is special - a key
equal to int64.max merges like any other.
"""

from __future__ import annotations

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


def launch_merge_runs(a, ai, b, bi, out_keys, out_idx) -> None:
    """The bare launch on checked GPU tensors with preallocated outputs.
    No allocation, no synchronisation."""
    lib = build.load_library()
    with torch.cuda.device(a.device):
        code = lib.merge_runs(a.data_ptr(), ai.data_ptr(), b.data_ptr(),
                              bi.data_ptr(), out_keys.data_ptr(),
                              out_idx.data_ptr(), a.shape[0], a.shape[1],
                              b.shape[1],
                              torch.cuda.current_stream().cuda_stream)
    build.check(code, "merge_runs")


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


def merge_sorted_runs(runs, device=None):
    """K-way merge (the comparator tree): pairwise tournament.

    runs: list of 1-D ascending integer key arrays (numpy or tensors;
    per-thread update logs - int64 commit ids are first-class). `device`
    says where to merge (default: where the runs lie). Returns
    (merged_keys int64, merged_source_index int32) on that device, where
    source index is the position in the concatenated input - callers
    gather payloads with it.
    """
    keys = [_as_keys(r) for r in runs]
    if not keys:
        return merge_runs_ref(keys)
    if device is None:
        device = keys[0].device
    device = torch.device(device)
    lens = [int(k.shape[0]) for k in keys]
    cat = torch.cat(keys).to(device)        # one host-to-device copy
    if device.type != "cuda":
        return merge_runs_ref([cat])
    idx = torch.arange(cat.shape[0], dtype=torch.int32, device=device)
    offs = np.cumsum([0] + lens)
    keyed = [(cat[lo:hi][None, :], idx[lo:hi][None, :])
             for lo, hi in zip(offs[:-1], offs[1:])]
    while len(keyed) > 1:
        nxt = []
        for p in range(0, len(keyed) - 1, 2):
            (ak, ai), (bk, bi) = keyed[p], keyed[p + 1]
            nxt.append(merge_sorted_pair(ak, bk, ai, bi))
        if len(keyed) % 2:
            nxt.append(keyed[-1])
        keyed = nxt
    return keyed[0][0][0], keyed[0][1][0]


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
