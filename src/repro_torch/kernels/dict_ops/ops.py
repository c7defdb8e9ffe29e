"""Public wrappers for the fused dictionary-encoded scan.

One CUDA kernel (``csrc/scan_exact.cu``) answers Q code-range predicates in
one pass over the encoded columns, accumulating exact int64 sums on the
device; the optional join lane (``kernels/hash_probe/ops.py``) rides the
same pass. The plain PyTorch version of the same function is
``scan_exact_ref``.

All arguments are tensors on one device: ``fcodes``/``acodes`` (n,) int32,
``valid`` (n,) bool or uint8, ``dictionary`` (k,) int32; ``bounds`` is a
host sequence of ``(code_lo, code_hi)`` pairs (exclusive upper bound).
Answers come back as exact Python ints - one device-to-host copy per call.
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


def scan_exact_ref(fcodes, acodes, fvalid, adict, bounds, jcodes=None,
                   jvalid=None, rcount=None) -> torch.Tensor:
    """Plain PyTorch version of the scan kernel.

    Returns a (2, Q) int64 tensor (sums, counts), or (3, Q) with the join
    lane (sums, counts, join sums), on the inputs' device.
    """
    nq = len(bounds)
    lanes = 2 if jcodes is None else 3
    out = torch.zeros((lanes, nq), dtype=torch.int64, device=fcodes.device)
    if fcodes.shape[0] == 0 or nq == 0:
        return out
    fv = fvalid != 0
    vals = adict.to(torch.int64)[acodes.long()]
    zero = torch.zeros((), dtype=torch.int64, device=fcodes.device)
    if jcodes is not None:
        weights = torch.where(jvalid != 0,
                              rcount.to(torch.int64)[jcodes.long()], zero)
    for q, (lo, hi) in enumerate(bounds):
        mask = (fcodes >= int(lo)) & (fcodes < int(hi)) & fv
        out[0, q] = torch.where(mask, vals, zero).sum()
        out[1, q] = mask.sum()
        if jcodes is not None:
            out[2, q] = torch.where(mask, weights, zero).sum()
    return out


def launch_scan_exact(fcodes, acodes, fvalid_u8, adict, bounds_dev, out,
                      jcodes=None, jvalid_u8=None, rcount=None) -> None:
    """The bare launch of ``scan_exact`` on checked GPU tensors: `out` is a
    zeroed (2|3, Q) int64 tensor the kernel adds into, `bounds_dev` a
    (Q, 2) int32 tensor. No allocation, no synchronisation."""
    join = jcodes is not None
    lib = build.load_library()
    with torch.cuda.device(fcodes.device):
        code = lib.scan_exact(
            fcodes.data_ptr(), acodes.data_ptr(), fvalid_u8.data_ptr(),
            adict.data_ptr(), adict.shape[0], bounds_dev.data_ptr(),
            bounds_dev.shape[0], jcodes.data_ptr() if join else None,
            jvalid_u8.data_ptr() if join else None,
            rcount.data_ptr() if join else None,
            rcount.shape[0] if join else 0, fcodes.shape[0], out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    build.check(code, "scan_exact")


def scan_exact(fcodes, acodes, fvalid, adict, bounds, jcodes=None,
               jvalid=None, rcount=None) -> torch.Tensor:
    """The scan on the inputs' device: the CUDA kernel for GPU tensors, the
    plain version for CPU tensors. Same result layout as `scan_exact_ref`."""
    join = jcodes is not None
    tensors = [fcodes, acodes, fvalid, adict]
    if join:
        tensors += [jcodes, jvalid, rcount]
    if not on_gpu(*tensors):
        return scan_exact_ref(fcodes, acodes, fvalid, adict, bounds, jcodes,
                              jvalid, rcount)
    n = fcodes.shape[0]
    nq = len(bounds)
    out = torch.zeros((3 if join else 2, nq), dtype=torch.int64,
                      device=fcodes.device)
    if n == 0 or nq == 0:
        return out
    fv = as_u8(fvalid)
    check_tensor(fcodes, torch.int32, "fcodes", 1)
    check_tensor(acodes, torch.int32, "acodes", 1)
    check_tensor(fv, torch.uint8, "fvalid", 1)
    check_tensor(adict, torch.int32, "dictionary", 1)
    if acodes.shape[0] != n or fv.shape[0] != n:
        raise ValueError("fcodes, acodes and valid must have one length")
    if adict.shape[0] == 0:
        raise ValueError("cannot scan rows against an empty dictionary")
    jv = None
    if join:
        jv = as_u8(jvalid)
        check_tensor(jcodes, torch.int32, "jcodes", 1)
        check_tensor(jv, torch.uint8, "jvalid", 1)
        check_tensor(rcount, torch.int32, "rcount", 1)
        if jcodes.shape[0] != n or jv.shape[0] != n:
            raise ValueError("jcodes and jvalid must match fcodes' length")
        if rcount.shape[0] == 0:
            raise ValueError("cannot join rows against an empty histogram")
    launch_scan_exact(fcodes, acodes, fv, adict,
                      _bounds_tensor(bounds, fcodes.device), out,
                      jcodes if join else None, jv if join else None,
                      rcount if join else None)
    if join:
        count_launch("scan_exact_join",
                     (n, adict.shape[0], rcount.shape[0], nq))
    else:
        count_launch("scan_exact", (n, adict.shape[0], nq))
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
