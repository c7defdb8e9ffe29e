"""Public wrappers for the fused dictionary-encoded scan.

One CUDA kernel (``csrc/scan_exact.cu``) answers Q code-range predicates in
one pass over the encoded columns, accumulating exact int64 sums on the
device; the optional join lane (``kernels/hash_probe/ops.py``) rides the
same pass. Columns are flat ``(n,)`` tensors (one island) or stacked
``(n_shards, width)`` shards (several islands, one launch for all, padded
slots carry ``valid = 0``). The plain PyTorch version of the same function
is ``scan_exact_ref``.

All arguments are tensors on one device: ``fcodes``/``acodes`` int32,
``valid`` bool or uint8, ``dictionary`` (k,) int32; ``bounds`` is a host
sequence of ``(code_lo, code_hi)`` pairs (exclusive upper bound). Answers
come back as exact Python ints - one device-to-host copy per call.

The delta store's correction lane rides the same kernel: a correction
stack is a (6, nr) int32 tensor of overlay rows ``[fv_eff, av_eff,
valid_eff, fv_base, av_base, valid_base]`` and ``vbounds`` the same
predicates as INCLUSIVE raw-value ranges ``(lo, hi)``. `scan_exact_group`
is a base scan plus the lane in one launch (a query group on the delta
plane: `scan_filter_agg_group`, its sharded sibling, and the join group of
``kernels/hash_probe``); `scan_values_exact` is the lane alone
(`scan_values_delta`, and `scan_values_agg` over a 3-row stack holding only
the effective triple). ``None`` for a stack is a zero-row stack; stacks are
not padded.

On the mesh placement (`scan_filter_agg_mesh`, and the join group's
`scan_filter_agg_join_mesh` in ``kernels/hash_probe``) each island's shard
is a flat column on its own device: one launch of the scan's island-table
entry per device (up to MAX_ISLANDS islands a launch, `mesh_launch_groups`)
adding every island there into one int64 partial, and the partials of
other devices added on island 0's device.

Every bare launch goes through `build.launch` (the raw stream handle, a
device guard only off the current device).

The reference's original float32 single-predicate scan
(``scan_filter_agg(exact=False)``) is a kernel of its own,
``csrc/scan_float.cu``: a float32 sum and an int32 count in one launch,
left on the device as 0-d tensors.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.bitonic_sort.ops import (  # noqa: F401 (re-export)
    apply_pipeline_batch)
from repro_torch.kernels.common import (as_u8, check_tensor, count_launch,
                                        on_gpu, sm_count)


def _bounds_tensor(bounds, device) -> torch.Tensor:
    return torch.tensor([[int(lo), int(hi)] for lo, hi in bounds],
                        dtype=torch.int32, device=device).reshape(-1, 2)


def _gathered(table, codes, keep) -> torch.Tensor:
    """int64 ``table[codes]`` where `keep`, 0 elsewhere: the gather is
    guarded by the mask, so a padded slot's code never indexes `table`
    (which may be empty)."""
    out = torch.zeros(codes.shape, dtype=torch.int64, device=codes.device)
    out[keep] = table.to(torch.int64)[codes[keep].long()]
    return out


def scan_exact_ref(fcodes, acodes, fvalid, adict, bounds, jcodes=None,
                   jvalid=None, rcount=None) -> torch.Tensor:
    """Plain PyTorch version of the scan kernel.

    Flat (n,) columns give a (2, Q) int64 tensor (sums, counts), or (3, Q)
    with the join lane (sums, counts, join sums); stacked (S, W) columns
    give one such block per shard, (S, 2|3, Q). On the inputs' device.
    """
    nq = len(bounds)
    lanes = 2 if jcodes is None else 3
    lead = tuple(fcodes.shape[:-1])
    out = torch.zeros(lead + (lanes, nq), dtype=torch.int64,
                      device=fcodes.device)
    if fcodes.shape[-1] == 0 or nq == 0:
        return out
    fv = fvalid != 0
    vals = _gathered(adict, acodes, fv)
    zero = torch.zeros((), dtype=torch.int64, device=fcodes.device)
    if jcodes is not None:
        weights = _gathered(rcount, jcodes, fv & (jvalid != 0))
    for q, (lo, hi) in enumerate(bounds):
        mask = (fcodes >= int(lo)) & (fcodes < int(hi)) & fv
        out[..., 0, q] = torch.where(mask, vals, zero).sum(-1)
        out[..., 1, q] = mask.sum(-1)
        if jcodes is not None:
            out[..., 2, q] = torch.where(mask, weights, zero).sum(-1)
    return out


def _ptr(t):
    return None if t is None else t.data_ptr()


def launch_scan_exact(fcodes, acodes, fvalid_u8, adict, bounds_dev, out,
                      jcodes=None, jvalid_u8=None, rcount=None, corr_a=None,
                      corr_j=None, vbounds_dev=None) -> None:
    """The bare launch of ``scan_exact`` on checked GPU tensors, flat (n,)
    or stacked (S, W): `out` is a zeroed (2|3, Q) or (S, 2|3, Q) int64
    tensor the kernel adds into, `bounds_dev` a (Q, 2) int32 tensor. No
    allocation, no synchronisation.

    With `vbounds_dev` ((Q, 2) int32, inclusive) the correction lane runs
    in the same launch over `corr_a` ((6 or 3, nr) int32) and, with the
    join lane, `corr_j` ((6, nr) int32), into one more row of `out`:
    (S + 1, 2|3, Q), a flat column counting as S = 1. `fcodes` None runs
    the lane alone into a (1, 2, Q) `out`."""
    if fcodes is None:
        n_shards, width = 0, 0
    else:
        n_shards = fcodes.shape[0] if fcodes.dim() == 2 else 1
        width = fcodes.shape[-1]
    nq = (bounds_dev if bounds_dev is not None else vbounds_dev).shape[0]
    nr_a = 0 if corr_a is None else corr_a.shape[1]
    nr_j = 0 if corr_j is None else corr_j.shape[1]
    corr_base = int(corr_a is None or corr_a.shape[0] == 6)
    build.launch("scan_exact", out.device,
                 _ptr(fcodes), _ptr(acodes), _ptr(fvalid_u8), _ptr(adict),
                 _ptr(bounds_dev), nq, _ptr(jcodes), _ptr(jvalid_u8),
                 _ptr(rcount), n_shards, width, _ptr(corr_a), nr_a,
                 corr_base, _ptr(corr_j), nr_j, _ptr(vbounds_dev),
                 out.data_ptr())


def scan_exact(fcodes, acodes, fvalid, adict, bounds, jcodes=None,
               jvalid=None, rcount=None) -> torch.Tensor:
    """The scan on the inputs' device: the CUDA kernel for GPU tensors, the
    plain version for CPU tensors. Same result layout as `scan_exact_ref`.

    Every valid row's code must index its dictionary (rows that fail the
    mask, such as padded slots, are never looked up)."""
    join = jcodes is not None
    tensors = [fcodes, acodes, fvalid, adict]
    if join:
        tensors += [jcodes, jvalid, rcount]
    if not on_gpu(*tensors):
        return scan_exact_ref(fcodes, acodes, fvalid, adict, bounds, jcodes,
                              jvalid, rcount)
    ndim = fcodes.dim()
    if ndim not in (1, 2):
        raise ValueError(f"fcodes: expected (n,) or (n_shards, width), got "
                         f"shape {tuple(fcodes.shape)}")
    nq = len(bounds)
    lead = tuple(fcodes.shape[:-1])
    out = torch.zeros(lead + (3 if join else 2, nq), dtype=torch.int64,
                      device=fcodes.device)
    if fcodes.numel() == 0 or nq == 0:
        return out
    fv = as_u8(fvalid)
    check_tensor(fcodes, torch.int32, "fcodes", ndim)
    check_tensor(acodes, torch.int32, "acodes", ndim)
    check_tensor(fv, torch.uint8, "fvalid", ndim)
    check_tensor(adict, torch.int32, "dictionary", 1)
    if acodes.shape != fcodes.shape or fv.shape != fcodes.shape:
        raise ValueError("fcodes, acodes and valid must have one shape")
    jv = None
    if join:
        jv = as_u8(jvalid)
        check_tensor(jcodes, torch.int32, "jcodes", ndim)
        check_tensor(jv, torch.uint8, "jvalid", ndim)
        check_tensor(rcount, torch.int32, "rcount", 1)
        if jcodes.shape != fcodes.shape or jv.shape != fcodes.shape:
            raise ValueError("jcodes and jvalid must match fcodes' shape")
    launch_scan_exact(fcodes, acodes, fv, adict,
                      _bounds_tensor(bounds, fcodes.device), out,
                      jcodes if join else None, jv if join else None,
                      rcount if join else None)
    name = "scan_exact" + ("_join" if join else "") + (
        "_sharded" if ndim == 2 else "")
    count_launch(name, tuple(fcodes.shape) + (adict.shape[0],) + (
        (rcount.shape[0],) if join else ()) + (nq,))
    return out


def scan_filter_agg_batch_ref(fcodes, acodes, valid, dictionary, bounds):
    """Plain version of `scan_filter_agg_batch` (exact Python ints)."""
    sums, counts = scan_exact_ref(fcodes, acodes, valid, dictionary,
                                  list(bounds)).tolist()
    return list(zip(sums, counts))


def scan_filter_agg_batch(fcodes, acodes, valid, dictionary, bounds):
    """One fused pass answering Q code-range queries over the same columns.

    bounds: sequence of (code_lo, code_hi). Returns [(sum, count), ...] as
    exact Python ints.
    """
    bounds = list(bounds)
    if fcodes.shape[0] == 0 or not bounds:
        return [(0, 0) for _ in bounds]
    sums, counts = scan_exact(fcodes, acodes, valid, dictionary,
                              bounds).tolist()
    return list(zip(sums, counts))


def scan_filter_agg_float_ref(fcodes, acodes, valid, dictionary, code_lo,
                              code_hi):
    """Plain version of the float32 scan: (0-d float32 sum, 0-d int32
    count)."""
    mask = (fcodes >= code_lo) & (fcodes < code_hi) & (valid != 0)
    vals = dictionary[acodes.long()].to(torch.float32)
    return (torch.where(mask, vals, 0.0).sum(),
            mask.sum(dtype=torch.int32))


FLOAT_SCAN_THREADS = 256     # the block size of csrc/scan_float.cu
FLOAT_SCAN_GROUP = 4         # rows a thread reads at once (16 B a column)
FLOAT_SCAN_TREE = 5 + 3      # a block's sum: rounding levels of its trees

_float_blocks: dict[int, int] = {}          # device index -> blocks an SM
_float_counters: dict[tuple, torch.Tensor] = {}   # (device, stream) -> ticket


def float_scan_blocks_per_sm(device) -> int:
    """Blocks of the float scan that one SM holds at once (the CUDA
    occupancy API over the kernel's registers; asked once per device)."""
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    n = _float_blocks.get(idx)
    if n is None:
        per_sm = ctypes.c_int(0)
        with torch.cuda.device(idx):
            build.check(build.entry("scan_float_occupancy")(
                1, ctypes.byref(per_sm)), "scan_float_occupancy")
        n = _float_blocks[idx] = max(1, per_sm.value)
    return n


def float_scan_parts(device, n: int) -> int:
    """Blocks of the float scan's one launch (its scratch length): one per
    1,024 rows (256 threads, 4 rows each), at most as many as the card
    holds at once (the blocks stride over the rows)."""
    rows = FLOAT_SCAN_THREADS * FLOAT_SCAN_GROUP
    return max(1, min(-(-n // rows),
                      float_scan_blocks_per_sm(device) * sm_count(device)))


def float_scan_error_bound(n: int, parts: int, abs_sum) -> float:
    """Most the float scan's sum over ``n`` rows with ``parts`` blocks can
    differ from the exact sum, given sum(|v|) over the rows it selects:
    gamma_h * sum(|v|), gamma_h = h u / (1 - h u), u = 2**-24, for a
    summation tree of height h (Higham, Accuracy and Stability, 4.2). Here
    h counts the roundings on a value's way to the result (the order of
    csrc/scan_float.cu): its conversion to float32 (1); its group's
    (r0 + r1) + (r2 + r3) (2); the adds into its thread's sum, at most one
    a group (ceil((n // 4) / (parts * 256)) groups) plus a head and a tail
    row (2); its block's trees (5 warp-shuffle levels, 3 over the 8 warps'
    sums); the last block's thread's adds of the partials (ceil(parts /
    256)) and that block's trees (8 again)."""
    groups = -(-(n // FLOAT_SCAN_GROUP) // (parts * FLOAT_SCAN_THREADS))
    height = (1 + 2 + groups + 2 + FLOAT_SCAN_TREE
              + -(-parts // FLOAT_SCAN_THREADS) + FLOAT_SCAN_TREE)
    hu = height * 2.0**-24
    return hu / (1.0 - hu) * float(abs_sum)


def float_scan_counter(device) -> torch.Tensor:
    """The float scan's ticket counter for `device`'s current stream: one
    int32 zero, made once per (device, stream) and left zero by every
    launch, so launches in one stream's order share it and two streams
    never do."""
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    key = (idx, torch._C._cuda_getCurrentRawStream(idx))
    t = _float_counters.get(key)
    if t is None:
        t = _float_counters[key] = torch.zeros((1,), dtype=torch.int32,
                                               device=torch.device("cuda",
                                                                   idx))
    return t


def launch_scan_float(fcodes, acodes, valid_u8, dictionary, code_lo: int,
                      code_hi: int, psum, pcnt, counter, out_sum,
                      out_cnt) -> None:
    """The bare launch (one kernel) on checked GPU tensors: ``psum`` /
    ``pcnt`` scratch of the grid's blocks, ``counter`` the current stream's
    `float_scan_counter`, ``out_sum`` (1,) float32, ``out_cnt`` (1,)
    int32. No allocation, no synchronisation."""
    build.launch("scan_float", fcodes.device, fcodes.data_ptr(),
                 acodes.data_ptr(), valid_u8.data_ptr(), dictionary.data_ptr(),
                 fcodes.shape[0], int(code_lo), int(code_hi), psum.data_ptr(),
                 pcnt.data_ptr(), psum.shape[0], counter.data_ptr(),
                 out_sum.data_ptr(), out_cnt.data_ptr())


def scan_filter_agg_float(fcodes, acodes, valid, dictionary, code_lo,
                          code_hi):
    """The float32 single-predicate scan: (0-d float32 sum of
    dict[acodes], 0-d int32 count) over rows with code_lo <= fcodes <
    code_hi and valid, both left on the device (one launch)."""
    if not on_gpu(fcodes, acodes, valid, dictionary):
        return scan_filter_agg_float_ref(fcodes, acodes, valid, dictionary,
                                         code_lo, code_hi)
    (n,) = fcodes.shape
    fv = as_u8(valid)
    check_tensor(fcodes, torch.int32, "fcodes", 1)
    check_tensor(acodes, torch.int32, "acodes", 1)
    check_tensor(fv, torch.uint8, "valid", 1)
    check_tensor(dictionary, torch.int32, "dictionary", 1)
    if acodes.shape != fcodes.shape or fv.shape != fcodes.shape:
        raise ValueError("fcodes, acodes and valid must have one shape")
    dev = fcodes.device
    if n == 0:
        return (torch.zeros((), dtype=torch.float32, device=dev),
                torch.zeros((), dtype=torch.int32, device=dev))
    out_sum = torch.empty((1,), dtype=torch.float32, device=dev)
    out_cnt = torch.empty((1,), dtype=torch.int32, device=dev)
    parts = float_scan_parts(dev, n)
    psum = torch.empty((parts,), dtype=torch.float32, device=dev)
    pcnt = torch.empty((parts,), dtype=torch.int32, device=dev)
    launch_scan_float(fcodes, acodes, fv, dictionary, code_lo, code_hi, psum,
                      pcnt, float_scan_counter(dev), out_sum, out_cnt)
    count_launch("scan_float", (n, dictionary.shape[0]))
    return out_sum[0], out_cnt[0]


def scan_filter_agg(fcodes, acodes, valid, dictionary, code_lo, code_hi,
                    exact: bool = True):
    """sum(dict[acodes]) and count over rows with code_lo <= fcodes <
    code_hi: exact Python ints (the execution backend's path), or with
    ``exact=False`` the reference's original float32 scan, (0-d float32
    sum, 0-d int32 count) on the device."""
    if not exact:
        return scan_filter_agg_float(fcodes, acodes, valid, dictionary,
                                     code_lo, code_hi)
    [(s, c)] = scan_filter_agg_batch(fcodes, acodes, valid, dictionary,
                                     [(code_lo, code_hi)])
    return s, c


def _per_shard(parts: torch.Tensor) -> list:
    """(S, lanes, Q) partials -> [[(lane values...)] * Q] * S as exact
    Python ints, with one device-to-host copy."""
    return [[tuple(t) for t in zip(*lanes)] for lanes in parts.tolist()]


def scan_filter_agg_sharded_ref(fcodes, acodes, valid, dictionary, bounds):
    """Plain version of `scan_filter_agg_sharded`."""
    return _per_shard(scan_exact_ref(fcodes, acodes, valid, dictionary,
                                     list(bounds)))


def scan_filter_agg_sharded(fcodes, acodes, valid, dictionary, bounds):
    """All islands' fused scans in ONE launch over a leading shard axis.

    fcodes/acodes/valid: (n_shards, width) stacked resident shards (padded
    slots must carry valid = 0 - see dsm.ShardedView). bounds: Q (code_lo,
    code_hi) predicates shared by every island. Returns per-island exact
    partials ``[[(sum, count)] * Q] * n_shards`` as Python ints, equal to
    running the flat scan on each shard.
    """
    n_shards, width = fcodes.shape
    bounds = list(bounds)
    if width == 0 or not bounds:
        return [[(0, 0)] * len(bounds) for _ in range(n_shards)]
    return _per_shard(scan_exact(fcodes, acodes, valid, dictionary, bounds))


# ---------------------------------------------------------------------------
# The delta store's correction lane (one launch with the base scan, or alone)
# ---------------------------------------------------------------------------

def _stack(corr, device) -> torch.Tensor:
    """A correction stack as a tensor; None is a zero-row (6, 0) stack."""
    if corr is None:
        return torch.zeros((6, 0), dtype=torch.int32, device=device)
    return corr


def _check_stack(stack: torch.Tensor, name: str) -> None:
    check_tensor(stack, torch.int32, name, 2)
    if stack.shape[0] not in (3, 6):
        raise ValueError(f"{name}: expected 6 (or 3) rows, got shape "
                         f"{tuple(stack.shape)}")


def scan_values_exact_ref(stack, vbounds) -> torch.Tensor:
    """Plain PyTorch version of the correction lane alone: a (2, Q) int64
    tensor holding, per inclusive range ``(lo, hi)``, the sum of the
    effective rows' values minus the base rows' and the difference of their
    counts (a row counts where ``lo <= fv <= hi`` and its valid lane is not
    0). A 3-row stack has only the effective triple: the plain raw-value
    scan."""
    nq = len(vbounds)
    out = torch.zeros((2, nq), dtype=torch.int64, device=stack.device)
    if stack.shape[1] == 0 or nq == 0:
        return out
    zero = torch.zeros((), dtype=torch.int64, device=stack.device)
    triples = [(stack[0], stack[1].to(torch.int64), stack[2] != 0, 1)]
    if stack.shape[0] == 6:
        triples.append((stack[3], stack[4].to(torch.int64), stack[5] != 0,
                        -1))
    for q, (lo, hi) in enumerate(vbounds):
        for fv, av, valid, sign in triples:
            mask = (fv >= int(lo)) & (fv <= int(hi)) & valid
            out[0, q] += sign * torch.where(mask, av, zero).sum()
            out[1, q] += sign * mask.sum()
    return out


def scan_values_exact(stack, vbounds) -> torch.Tensor:
    """The correction lane alone on the stack's device (the CUDA kernel
    for a GPU tensor, one launch; the plain version for a CPU tensor).
    Same layout as `scan_values_exact_ref`."""
    if not on_gpu(stack):
        return scan_values_exact_ref(stack, vbounds)
    nq = len(vbounds)
    out = torch.zeros((1, 2, nq), dtype=torch.int64, device=stack.device)
    if stack.shape[1] == 0 or nq == 0:
        return out[0]
    _check_stack(stack, "correction stack")
    launch_scan_exact(None, None, None, None, None, out, corr_a=stack,
                      vbounds_dev=_bounds_tensor(vbounds, stack.device))
    count_launch("scan_values" if stack.shape[0] == 3 else
                 "scan_values_delta", (stack.shape[1], nq))
    return out[0]


def scan_exact_group_ref(fcodes, acodes, fvalid, adict, bounds, corr_a,
                         vbounds, jcodes=None, jvalid=None, rcount=None,
                         corr_j=None) -> torch.Tensor:
    """Plain version of `scan_exact_group`: the base scan's partials (one
    row per shard, a flat column being one shard) and, as one more row,
    the correction lane's (the aggregate stack's deltas in the sum and
    count lanes, the join-weight stack's sum delta in the join lane)."""
    base = scan_exact_ref(fcodes, acodes, fvalid, adict, bounds, jcodes,
                          jvalid, rcount)
    if base.dim() == 2:
        base = base[None]
    corr = torch.zeros((1,) + tuple(base.shape[1:]), dtype=torch.int64,
                       device=base.device)
    corr[0, :2] = scan_values_exact_ref(_stack(corr_a, base.device), vbounds)
    if jcodes is not None:
        corr[0, 2] = scan_values_exact_ref(_stack(corr_j, base.device),
                                           vbounds)[0]
    return torch.cat([base, corr])


def scan_exact_group(fcodes, acodes, fvalid, adict, bounds, corr_a, vbounds,
                     jcodes=None, jvalid=None, rcount=None, corr_j=None
                     ) -> torch.Tensor:
    """A base scan (flat or stacked, with or without the join lane) plus
    the correction lane in ONE launch on the inputs' device. `bounds` are
    the Q code ranges of the base scan, `vbounds` the same Q predicates as
    inclusive raw-value ranges; `corr_a` the aggregate stack, `corr_j` the
    join-weight stack (join lane only). Same layout as
    `scan_exact_group_ref`; the answer is the sum over its first axis."""
    join = jcodes is not None
    dev = fcodes.device
    corr_a, corr_j = _stack(corr_a, dev), _stack(corr_j, dev)
    tensors = [fcodes, acodes, fvalid, adict, corr_a]
    if join:
        tensors += [jcodes, jvalid, rcount, corr_j]
    if not on_gpu(*tensors):
        return scan_exact_group_ref(fcodes, acodes, fvalid, adict, bounds,
                                    corr_a, vbounds, jcodes, jvalid, rcount,
                                    corr_j)
    ndim = fcodes.dim()
    if ndim not in (1, 2):
        raise ValueError(f"fcodes: expected (n,) or (n_shards, width), got "
                         f"shape {tuple(fcodes.shape)}")
    nq = len(bounds)
    if len(vbounds) != nq:
        raise ValueError(f"{nq} code ranges but {len(vbounds)} value ranges")
    n_shards = fcodes.shape[0] if ndim == 2 else 1
    out = torch.zeros((n_shards + 1, 3 if join else 2, nq),
                      dtype=torch.int64, device=dev)
    if nq == 0:
        return out
    fv = as_u8(fvalid)
    check_tensor(fcodes, torch.int32, "fcodes", ndim)
    check_tensor(acodes, torch.int32, "acodes", ndim)
    check_tensor(fv, torch.uint8, "fvalid", ndim)
    check_tensor(adict, torch.int32, "dictionary", 1)
    if acodes.shape != fcodes.shape or fv.shape != fcodes.shape:
        raise ValueError("fcodes, acodes and valid must have one shape")
    _check_stack(corr_a, "corr_a")
    jv = None
    if join:
        jv = as_u8(jvalid)
        check_tensor(jcodes, torch.int32, "jcodes", ndim)
        check_tensor(jv, torch.uint8, "jvalid", ndim)
        check_tensor(rcount, torch.int32, "rcount", 1)
        if jcodes.shape != fcodes.shape or jv.shape != fcodes.shape:
            raise ValueError("jcodes and jvalid must match fcodes' shape")
        _check_stack(corr_j, "corr_j")
        if corr_j.shape[0] != 6:
            raise ValueError("corr_j: the join-weight stack has 6 rows")
    launch_scan_exact(fcodes, acodes, fv, adict, _bounds_tensor(bounds, dev),
                      out, jcodes if join else None, jv,
                      rcount if join else None, corr_a=corr_a,
                      corr_j=corr_j if join else None,
                      vbounds_dev=_bounds_tensor(vbounds, dev))
    name = "scan_exact" + ("_join" if join else "") + "_group" + (
        "_sharded" if ndim == 2 else "")
    count_launch(name, tuple(fcodes.shape) + (adict.shape[0],) + (
        (rcount.shape[0],) if join else ()) + (nq, corr_a.shape[1]) + (
        (corr_j.shape[1],) if join else ()))
    return out


def _pairs(parts: torch.Tensor) -> list:
    """(lanes, Q) -> [(lane values...)] * Q as exact Python ints (one
    device-to-host copy)."""
    return [tuple(t) for t in zip(*parts.tolist())]


def _values_stack(fvals, avals, valid) -> torch.Tensor:
    """Raw overlay rows as a 3-row stack (the effective triple only)."""
    return torch.stack([fvals.to(torch.int32), avals.to(torch.int32),
                        valid.to(torch.int32)])


def scan_values_agg_ref(fvals, avals, valid, bounds):
    """Plain version of `scan_values_agg`."""
    return _pairs(scan_values_exact_ref(_values_stack(fvals, avals, valid),
                                        list(bounds)))


def scan_values_agg(fvals, avals, valid, bounds):
    """One pass answering Q INCLUSIVE value-range queries over raw
    (decoded) rows: per ``(lo, hi)`` the exact ``(sum(avals), count)``
    over rows with ``lo <= fvals <= hi`` and `valid`. fvals/avals int32
    tensors (no dictionary), valid bool or integer, all on one device."""
    bounds = list(bounds)
    if fvals.shape[0] == 0 or not bounds:
        return [(0, 0) for _ in bounds]
    return _pairs(scan_values_exact(_values_stack(fvals, avals, valid),
                                    bounds))


def scan_values_delta_ref(corr, vbounds):
    """Plain version of `scan_values_delta`."""
    vbounds = list(vbounds)
    return _pairs(scan_values_exact_ref(_stack(corr, "cpu"), vbounds))


def scan_values_delta(corr, vbounds):
    """Effective-minus-base correction of one (6, nr) overlay stack in ONE
    launch: per inclusive range, the exact ``(d_sum, d_count)`` the
    overlay adds to a base scan. ``None`` is a zero-row stack."""
    vbounds = list(vbounds)
    if not vbounds:
        return []
    if corr is None or corr.shape[1] == 0:
        return [(0, 0)] * len(vbounds)
    return _pairs(scan_values_exact(corr, vbounds))


def _group(fcodes, acodes, valid, dictionary, code_bounds, corr, vbounds,
           scan):
    nq = len(code_bounds)
    if nq == 0:
        return []
    if fcodes.shape[-1] == 0:
        return [(0, 0)] * nq
    return _pairs(scan(fcodes, acodes, valid, dictionary, list(code_bounds),
                       corr, list(vbounds)).sum(0))


def scan_filter_agg_group_ref(fcodes, acodes, valid, dictionary, code_bounds,
                              corr, vbounds):
    """Plain version of `scan_filter_agg_group`."""
    return _group(fcodes, acodes, valid, dictionary, code_bounds, corr,
                  vbounds, scan_exact_group_ref)


def scan_filter_agg_group(fcodes, acodes, valid, dictionary, code_bounds,
                          corr, vbounds):
    """One no-join query group on the delta plane - base scan PLUS the
    overlay correction - in ONE launch.

    code_bounds: Q exclusive code ranges over the (n,) base columns;
    vbounds: the same Q predicates as inclusive raw-value ranges; corr: the
    (6, nr) correction stack (None: no overlay). Returns [(sum, count)]
    exact Python ints: base + effective state - base state of the overlay
    rows."""
    return _group(fcodes, acodes, valid, dictionary, code_bounds, corr,
                  vbounds, scan_exact_group)


def scan_filter_agg_group_sharded_ref(fcodes, acodes, valid, dictionary,
                                      code_bounds, corr, vbounds):
    """Plain version of `scan_filter_agg_group_sharded`."""
    return _group(fcodes, acodes, valid, dictionary, code_bounds, corr,
                  vbounds, scan_exact_group_ref)


def scan_filter_agg_group_sharded(fcodes, acodes, valid, dictionary,
                                  code_bounds, corr, vbounds):
    """Sharded sibling of `scan_filter_agg_group`: every island's base scan
    over the stacked (n_shards, width) shards and the correction over the
    flat (global) overlay stack, in ONE launch. Returns the reduced
    [(sum, count)]: cross-island totals with the correction folded."""
    if fcodes.dim() != 2:
        raise ValueError(f"fcodes: expected (n_shards, width), got shape "
                         f"{tuple(fcodes.shape)}")
    return _group(fcodes, acodes, valid, dictionary, code_bounds, corr,
                  vbounds, scan_exact_group)


# ---------------------------------------------------------------------------
# The mesh placement: one launch per device, over a table of its islands
# ---------------------------------------------------------------------------
#
# The JAX package runs every island's scan in one `shard_map` call and
# psums the partials over the island axis as 16-bit lanes (its kernels had
# no int64). Here island s's flat shard lies on its own device. The islands
# of one device are one `scan_exact_islands` launch there (up to
# MAX_ISLANDS; more make more launches into the same output), their column
# pointers, lengths, dictionaries and histograms in a table passed by value
# with the launch, and every island's blocks add into one zeroed (2|3, Q)
# int64 partial per device. On one card that partial is the answer: no copy,
# no add. Across cards each other device's partial is copied to island 0's
# device and added there, in device order: no lanes, and no NCCL (its
# collectives refuse a device listed twice, and the partials are 3 * Q
# int64s a device). A copy is ordered after the launch on the source
# device's current stream. Arguments are sequences with one tensor per
# island (codes, validity, and the replicated dictionary and build-side
# histogram, each on its island's device, not assumed to be one tensor);
# `bounds` is the host sequence of code ranges.

MAX_ISLANDS = 16    # islands one launch takes (csrc/scan_exact.cu)


def _islands(*per_island) -> list[tuple]:
    """Regroup per-argument sequences into per-island tuples."""
    n = len(per_island[0])
    if n < 1 or any(len(p) != n for p in per_island):
        raise ValueError("every mesh argument needs one tensor per island "
                         f"(got {[len(p) for p in per_island]})")
    return list(zip(*per_island))


def mesh_launch_groups(devices, sizes) -> list[tuple[torch.device,
                                                     list[int]]]:
    """The launches of a mesh scan: ``(device, island indices)`` per launch.
    Empty islands (``sizes[s] == 0``) launch nothing; the others are
    grouped by device, in island order, at most MAX_ISLANDS a launch. Devices
    come in the order of their first non-empty island, each device's
    launches together."""
    per_device: dict = {}
    for s, (dev, n) in enumerate(zip(devices, sizes)):
        if not n:
            continue
        groups = per_device.setdefault(dev, [])
        if not groups or len(groups[-1]) == MAX_ISLANDS:
            groups.append([])
        groups[-1].append(s)
    return [(dev, g) for dev, groups in per_device.items() for g in groups]


def _island_table(islands) -> ctypes.Array:
    """The launch's island table: 8 int64s an island (the 7 column
    pointers, 0 for the join lane's when there is none, and n)."""
    vals = []
    for isl in islands:
        f, a, fv, ad = isl[:4]
        j, jv, rc = isl[4:] if len(isl) == 7 else (None, None, None)
        vals += [f.data_ptr(), a.data_ptr(), fv.data_ptr(), ad.data_ptr(),
                 _ptr(j) or 0, _ptr(jv) or 0, _ptr(rc) or 0, f.shape[0]]
    return (ctypes.c_longlong * len(vals))(*vals)


def launch_scan_exact_islands(islands, bounds_dev, out) -> None:
    """The bare launch of ``scan_exact_islands`` on checked GPU tensors:
    1 - MAX_ISLANDS non-empty islands, each a tuple (fcodes, acodes,
    fvalid_u8, adict[, jcodes, jvalid_u8, rcount]) of flat tensors on
    `out`'s device, `bounds_dev` their (Q, 2) int32 bounds there, `out` a
    zeroed (2|3, Q) int64 partial every island adds into. No allocation, no
    synchronisation."""
    build.launch("scan_exact_islands", out.device, _island_table(islands),
                 len(islands), bounds_dev.data_ptr(), bounds_dev.shape[0],
                 int(len(islands[0]) == 7), out.data_ptr())


def scan_exact_mesh_ref(fcodes, acodes, fvalid, adict, bounds, jcodes=None,
                        jvalid=None, rcount=None) -> torch.Tensor:
    """Plain version of `scan_exact_mesh`: `scan_exact_ref` on each island,
    the partials summed on island 0's device in island order."""
    join = jcodes is not None
    extra = (jcodes, jvalid, rcount) if join else ()
    total = None
    for isl in _islands(fcodes, acodes, fvalid, adict, *extra):
        part = scan_exact_ref(*isl[:4], list(bounds), *isl[4:])
        total = part if total is None else total + part.to(total.device)
    return total


def launch_scan_exact_mesh(islands, groups, bounds_devs, outs
                           ) -> torch.Tensor:
    """The bare launches of a mesh scan on checked GPU tensors: island s's
    ``islands[s]`` = (fcodes, acodes, fvalid_u8, adict[, jcodes, jvalid_u8,
    rcount]) flat on its device, `groups` its launches
    (`mesh_launch_groups`), ``bounds_devs[device]`` the (Q, 2) int32 bounds
    and ``outs[device]`` the zeroed (2|3, Q) int64 partial of every device
    that launches, island 0's device first in `outs` (its partial is the
    total). One launch per group; then every other device's partial is
    copied to the first and added there. Returns the first. No allocation
    beyond those copies, no synchronisation."""
    for dev, members in groups:
        launch_scan_exact_islands([islands[s] for s in members],
                                  bounds_devs[dev], outs[dev])
    parts = iter(outs.values())
    total = next(parts)
    for out in parts:
        total.add_(out.to(total.device))
    return total


def scan_exact_mesh(fcodes, acodes, fvalid, adict, bounds, jcodes=None,
                    jvalid=None, rcount=None) -> torch.Tensor:
    """Every island's scan on its own device, reduced exactly: a (2, Q)
    int64 tensor (sums, counts), or (3, Q) with the join lane, on island
    0's device. On GPU islands one `scan_exact_islands` launch per
    (device, group of up to MAX_ISLANDS non-empty islands), counted under
    ``scan_exact_mesh`` / ``scan_exact_join_mesh`` with the shape
    (islands in the launch, widest island, k[, kj], Q), k and kj the
    largest dictionary and histogram among them; on CPU islands the plain
    version. Islands must all be on GPUs or all on the CPU."""
    join = jcodes is not None
    extra = (jcodes, jvalid, rcount) if join else ()
    islands = _islands(fcodes, acodes, fvalid, adict, *extra)
    kinds = {on_gpu(*isl) for isl in islands}
    if len(kinds) != 1:
        raise ValueError("mesh islands must all lie on GPUs or all on the CPU")
    if not kinds.pop():
        return scan_exact_mesh_ref(fcodes, acodes, fvalid, adict, bounds,
                                   jcodes, jvalid, rcount)
    bounds = list(bounds)
    nq, lanes = len(bounds), 3 if join else 2
    checked = []
    for isl in islands:
        f, a, fv, ad = isl[:4]
        fv = as_u8(fv)
        check_tensor(f, torch.int32, "fcodes", 1)
        check_tensor(a, torch.int32, "acodes", 1)
        check_tensor(fv, torch.uint8, "fvalid", 1)
        check_tensor(ad, torch.int32, "dictionary", 1)
        if a.shape != f.shape or fv.shape != f.shape:
            raise ValueError("an island's fcodes, acodes and valid must have "
                             "one shape")
        rest = ()
        if join:
            j, jv, rc = isl[4], as_u8(isl[5]), isl[6]
            check_tensor(j, torch.int32, "jcodes", 1)
            check_tensor(jv, torch.uint8, "jvalid", 1)
            check_tensor(rc, torch.int32, "rcount", 1)
            if j.shape != f.shape or jv.shape != f.shape:
                raise ValueError("an island's jcodes and jvalid must match "
                                 "its fcodes")
            rest = (j, jv, rc)
        checked.append((f, a, fv, ad) + rest)
    groups = mesh_launch_groups([isl[0].device for isl in checked],
                                [isl[0].shape[0] for isl in checked])
    first = checked[0][0].device
    outs = {dev: torch.zeros((lanes, nq), dtype=torch.int64, device=dev)
            for dev in dict.fromkeys([first] + [dev for dev, _ in groups])}
    if nq == 0 or not groups:
        return outs[first]
    bounds_devs = {dev: _bounds_tensor(bounds, dev) for dev, _ in groups}
    total = launch_scan_exact_mesh(checked, groups, bounds_devs, outs)
    name = "scan_exact_join_mesh" if join else "scan_exact_mesh"
    for _, members in groups:
        widest = [max(checked[s][c].shape[0] for s in members)
                  for c in ((0, 3, 6) if join else (0, 3))]
        count_launch(name, (len(members), *widest, nq))
    return total


def scan_filter_agg_mesh_ref(fcodes, acodes, valid, dictionary, bounds):
    """Plain version of `scan_filter_agg_mesh`."""
    return _pairs(scan_exact_mesh_ref(fcodes, acodes, valid, dictionary,
                                      list(bounds)))


def scan_filter_agg_mesh(fcodes, acodes, valid, dictionary, bounds):
    """Every island's fused multi-query scan on its OWN device, reduced.

    The mesh sibling of `scan_filter_agg_sharded`: island s's resident
    shard is the flat ``fcodes[s]`` / ``acodes[s]`` / ``valid[s]`` on its
    device, ``dictionary[s]`` the replicated dictionary there. bounds: Q
    (code_lo, code_hi) predicates shared by every island. Returns the
    cross-island totals ``[(sum, count)] * Q`` as exact Python ints (one
    device-to-host copy), equal to the flat scan of the whole column."""
    bounds = list(bounds)
    if not bounds:
        return []
    return _pairs(scan_exact_mesh(fcodes, acodes, valid, dictionary, bounds))
