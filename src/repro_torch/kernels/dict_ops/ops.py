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
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.bitonic_sort.ops import (  # noqa: F401 (re-export)
    apply_pipeline_batch)
from repro_torch.kernels.common import (as_u8, check_tensor, count_launch,
                                        on_gpu)


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


def launch_scan_exact(fcodes, acodes, fvalid_u8, adict, bounds_dev, out,
                      jcodes=None, jvalid_u8=None, rcount=None) -> None:
    """The bare launch of ``scan_exact`` on checked GPU tensors, flat (n,)
    or stacked (S, W): `out` is a zeroed (2|3, Q) or (S, 2|3, Q) int64
    tensor the kernel adds into, `bounds_dev` a (Q, 2) int32 tensor. No
    allocation, no synchronisation."""
    join = jcodes is not None
    n_shards = fcodes.shape[0] if fcodes.dim() == 2 else 1
    lib = build.load_library()
    with torch.cuda.device(fcodes.device):
        code = lib.scan_exact(
            fcodes.data_ptr(), acodes.data_ptr(), fvalid_u8.data_ptr(),
            adict.data_ptr(), bounds_dev.data_ptr(), bounds_dev.shape[0],
            jcodes.data_ptr() if join else None,
            jvalid_u8.data_ptr() if join else None,
            rcount.data_ptr() if join else None, n_shards,
            fcodes.shape[-1], out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    build.check(code, "scan_exact")


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


def scan_filter_agg(fcodes, acodes, valid, dictionary, code_lo, code_hi,
                    exact: bool = True):
    """sum(dict[acodes]) and count over rows with code_lo <= fcodes < code_hi,
    as exact Python ints."""
    if not exact:
        raise NotImplementedError(
            "the float32 single-predicate scan (exact=False) is not ported "
            "yet: ROADMAP.md queue 2, K18")
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
