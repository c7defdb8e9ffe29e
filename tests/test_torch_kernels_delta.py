"""The port's delta-store scan entries vs the JAX package's, on the same
numpy inputs: the raw-value scan (`scan_values_agg`), the values delta
(`scan_values_delta`), the query group with its correction, flat and over
stacked shards (`scan_filter_agg_group[_sharded]`), and the join group with
both corrections (`scan_filter_agg_join_group`).

Integers throughout: tolerance 0. The reference runs as its own tests run
it on the CPU: the jitted lowering by default, Pallas interpret mode for
the small kernel-semantics cases. The edges are those `chip_smoke.py`
holds the CUDA kernels to: stacks of 0, 1, 3 and 4097 rows, negative and
int32-extreme values, empty ranges (lo > hi), hi = int32.max, 1, 3 and 9
predicates (9 takes a second predicate slice on the card), 3 and 4 islands.
"""

import numpy as np
import pytest
import torch

from repro.kernels import common as ref_common
from repro.kernels.dict_ops import (
    scan_filter_agg_group as ref_group,
    scan_filter_agg_group_sharded as ref_group_sharded,
    scan_values_agg as ref_values, scan_values_delta as ref_values_delta)
from repro.kernels.hash_probe import \
    scan_filter_agg_join_group as ref_join_group
from repro_torch.kernels.dict_ops import (scan_exact_group,
                                          scan_exact_group_ref, scan_exact_ref,
                                          scan_filter_agg_group,
                                          scan_filter_agg_group_ref,
                                          scan_filter_agg_group_sharded,
                                          scan_filter_agg_group_sharded_ref,
                                          scan_values_agg,
                                          scan_values_agg_ref,
                                          scan_values_delta,
                                          scan_values_delta_ref,
                                          scan_values_exact,
                                          scan_values_exact_ref)
from repro_torch.kernels.hash_probe import (scan_filter_agg_join_group,
                                            scan_filter_agg_join_group_ref)

torch.set_num_threads(1)
T = torch.from_numpy
I32_MIN, I32_MAX = -2**31, 2**31 - 1

NRS = [0, 1, 3, 4097]
NQS = [1, 3, 9]


@pytest.fixture
def interpret_mode():
    yield ref_common.set_interpret_override
    ref_common.set_interpret_override(None)


def _stack(rng, nr, extremes=True):
    """A (6, nr) int32 correction stack: raw values spread over the whole
    int32 range (and its two ends), 0/1 validity lanes."""
    vals = rng.integers(-1000, 1000, size=(4, nr)).astype(np.int64)
    vals[:, ::3] = rng.integers(I32_MIN, I32_MAX, size=vals[:, ::3].shape,
                                endpoint=True)
    if extremes and nr:
        vals[:, 0] = [I32_MIN, I32_MAX, I32_MAX, I32_MIN]
    valid = (rng.random((2, nr)) < 0.8).astype(np.int64)
    stack = np.stack([vals[0], vals[1], valid[0], vals[2], vals[3], valid[1]])
    return stack.astype(np.int32)


def _vbounds(rng, nq):
    """nq inclusive value ranges: the whole int32 range, an empty range
    (lo > hi), one ending at int32.max, and random ones."""
    fixed = [(I32_MIN, I32_MAX), (5, -5), (0, I32_MAX), (I32_MIN, I32_MIN),
             (-1000, 1000)]
    out = fixed[:nq]
    while len(out) < nq:
        lo = int(rng.integers(-1200, 1200))
        out.append((lo, lo + int(rng.integers(-5, 900))))
    return out


def _columns(rng, n, k, kj=None):
    kj = kj or k
    fcodes = rng.integers(0, k, size=n).astype(np.int32)
    acodes = rng.integers(0, k, size=n).astype(np.int32)
    jcodes = rng.integers(0, kj, size=n).astype(np.int32)
    fvalid = rng.random(n) < 0.9
    jvalid = rng.random(n) < 0.85
    d = np.sort(rng.choice(np.arange(-10**6, 10**6, dtype=np.int64), size=k,
                           replace=False)).astype(np.int32)
    d[0], d[-1] = I32_MIN + 1, I32_MAX - 1
    rcount = np.bincount(jcodes[jvalid], minlength=kj).astype(np.int32)
    return fcodes, acodes, jcodes, fvalid, jvalid, d, rcount


def _code_bounds(rng, k, nq):
    lows = rng.integers(0, k, size=nq)
    out = [(int(lo), int(lo) + int(rng.integers(0, k))) for lo in lows]
    out[0] = (0, k)
    return out


def _tuples(xs):
    return [tuple(int(v) for v in x) for x in xs]


# ---------------------------------------------------------------------------
# the correction lane alone: raw-value scan (K3) and values delta (K13)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nq", NQS)
@pytest.mark.parametrize("nr", NRS)
def test_scan_values_agg_matches_reference(rng, nr, nq):
    stack = _stack(rng, nr)
    vb = _vbounds(rng, nq)
    want = _tuples(ref_values(stack[0], stack[1], stack[2], vb))
    for valid in (T(stack[2]), T(stack[2] != 0)):   # int or bool validity
        got = scan_values_agg(T(stack[0]), T(stack[1]), valid, vb)
        assert got == want
        assert scan_values_agg_ref(T(stack[0]), T(stack[1]), valid, vb) == want


@pytest.mark.parametrize("nq", NQS)
@pytest.mark.parametrize("nr", NRS)
def test_scan_values_delta_matches_reference(rng, nr, nq):
    stack = _stack(rng, nr)
    vb = _vbounds(rng, nq)
    want = _tuples(ref_values_delta(stack, vb))
    assert scan_values_delta(T(stack), vb) == want
    assert scan_values_delta_ref(T(stack), vb) == want
    # the delta is two raw-value scans subtracted
    eff = ref_values(stack[0], stack[1], stack[2], vb)
    base = ref_values(stack[3], stack[4], stack[5], vb)
    assert want == [(e[0] - b[0], e[1] - b[1]) for e, b in zip(eff, base)]


def test_values_entries_take_no_stack_and_no_predicates(rng):
    vb = _vbounds(rng, 3)
    assert scan_values_delta(None, vb) == _tuples(ref_values_delta(None, vb))
    assert scan_values_delta(None, vb) == [(0, 0)] * 3
    assert scan_values_delta(T(_stack(rng, 5)), []) == []
    e = torch.empty(0, dtype=torch.int32)
    assert scan_values_agg(e, e, e.bool(), vb) == [(0, 0)] * 3
    assert scan_values_agg(e, e, e.bool(), []) == []


def test_values_tensor_layout(rng):
    """The lane's tensor result is (2, Q) int64 (sum or delta, count); a
    3-row stack is the plain raw-value scan."""
    stack = T(_stack(rng, 50))
    vb = _vbounds(rng, 4)
    full = scan_values_exact(stack, vb)
    assert full.shape == (2, 4) and full.dtype == torch.int64
    assert torch.equal(full, scan_values_exact_ref(stack, vb))
    eff = scan_values_exact(stack[:3].contiguous(), vb)
    base = scan_values_exact(stack[3:].contiguous(), vb)
    assert torch.equal(full, eff - base)


@pytest.mark.parametrize("nr", [0, 1, 3, 300])
def test_values_vs_pallas_interpret(interpret_mode, rng, nr):
    interpret_mode("1")
    stack = _stack(rng, nr)
    vb = _vbounds(rng, 9)
    assert scan_values_agg(T(stack[0]), T(stack[1]), T(stack[2]), vb) == \
        _tuples(ref_values(stack[0], stack[1], stack[2], vb))
    assert scan_values_delta(T(stack), vb) == \
        _tuples(ref_values_delta(stack, vb))


# ---------------------------------------------------------------------------
# the query group on the delta plane (K12), flat and sharded
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nq", NQS)
@pytest.mark.parametrize("nr", NRS)
def test_scan_filter_agg_group_matches_reference(rng, nr, nq):
    f, a, _, fv, _, d, _ = _columns(rng, 5003, 97)
    stack = _stack(rng, nr)
    cb, vb = _code_bounds(rng, 97, nq), _vbounds(rng, nq)
    want = _tuples(ref_group(f, a, fv, d, cb, stack, vb))
    args = (T(f), T(a), T(fv), T(d), cb, T(stack), vb)
    assert scan_filter_agg_group(*args) == want
    assert scan_filter_agg_group_ref(*args) == want


def _stacked(rng, sizes, k):
    """(S, W) stacked shards as a ShardedView lays them out (padded slots:
    code 0, invalid) plus the flat columns they hold."""
    n = sum(sizes)
    f, a, _, fv, _, d, _ = _columns(rng, n, k)
    width = max(sizes)
    lay = [np.zeros((len(sizes), width), dtype=t.dtype) for t in (f, a, fv)]
    lo = 0
    for s, size in enumerate(sizes):
        for out, flat in zip(lay, (f, a, fv)):
            out[s, :size] = flat[lo:lo + size]
        lo += size
    return lay, (f, a, fv), d


@pytest.mark.parametrize("nr", NRS)
@pytest.mark.parametrize("sizes", [(1001, 1000, 1000), (250, 250, 250, 250),
                                   (7, 0, 3, 5)])
def test_scan_filter_agg_group_sharded_matches_reference(rng, sizes, nr):
    (fs, as_, vs), flat, d = _stacked(rng, sizes, 61)
    stack = _stack(rng, nr)
    nq = 9 if nr == 4097 else 3
    cb, vb = _code_bounds(rng, 61, nq), _vbounds(rng, nq)
    want = _tuples(ref_group_sharded(fs, as_, vs, d, cb, stack, vb))
    args = (T(fs), T(as_), T(vs), T(d), cb, T(stack), vb)
    assert scan_filter_agg_group_sharded(*args) == want
    assert scan_filter_agg_group_sharded_ref(*args) == want
    # islands change nothing: the flat group over the same rows
    assert want == _tuples(ref_group(*flat, d, cb, stack, vb))


def test_group_layout_is_shard_rows_plus_a_correction_row(rng):
    """(S + 1, lanes, Q): the base scan's per-shard rows, then the lane's
    row; a flat column is one shard."""
    (fs, as_, vs), _, d = _stacked(rng, (40, 40, 39), 20)
    stack, vb = T(_stack(rng, 30)), _vbounds(rng, 3)
    cb = _code_bounds(rng, 20, 3)
    parts = scan_exact_group(T(fs), T(as_), T(vs), T(d), cb, stack, vb)
    assert parts.shape == (4, 2, 3) and parts.dtype == torch.int64
    assert torch.equal(parts[:3], scan_exact_ref(T(fs), T(as_), T(vs), T(d),
                                                 cb))
    assert torch.equal(parts[3], scan_values_exact(stack, vb))
    flat = scan_exact_group_ref(T(fs[0]), T(as_[0]), T(vs[0]), T(d), cb,
                                None, vb)
    assert flat.shape == (2, 2, 3) and not flat[1].any()


def test_group_with_no_predicates_or_no_rows(rng):
    f, a, _, fv, _, d, _ = _columns(rng, 10, 5)
    stack = T(_stack(rng, 4))
    assert scan_filter_agg_group(T(f), T(a), T(fv), T(d), [], stack, []) == []
    e = torch.empty(0, dtype=torch.int32)
    assert scan_filter_agg_group(e, e, e.bool(), T(d), [(0, 5)], stack,
                                 [(0, 9)]) == \
        _tuples(ref_group(f[:0], a[:0], fv[:0], d, [(0, 5)],
                          stack.numpy(), [(0, 9)]))


@pytest.mark.parametrize("nr", [0, 1, 3, 300])
def test_group_vs_pallas_interpret(interpret_mode, rng, nr):
    interpret_mode("1")
    f, a, _, fv, _, d, _ = _columns(rng, 700, 33)
    stack = _stack(rng, nr)
    cb, vb = _code_bounds(rng, 33, 9), _vbounds(rng, 9)
    assert scan_filter_agg_group(T(f), T(a), T(fv), T(d), cb, T(stack),
                                 vb) == \
        _tuples(ref_group(f, a, fv, d, cb, stack, vb))
    (fs, as_, vs), _, d = _stacked(rng, (100, 99, 99), 33)
    assert scan_filter_agg_group_sharded(T(fs), T(as_), T(vs), T(d), cb,
                                         T(stack), vb) == \
        _tuples(ref_group_sharded(fs, as_, vs, d, cb, stack, vb))


# ---------------------------------------------------------------------------
# the join group on the delta plane (K14)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nq", NQS)
@pytest.mark.parametrize("nr_a,nr_j", [(0, 0), (1, 3), (3, 0), (0, 1),
                                       (4097, 4097), (4097, 2)])
def test_scan_filter_agg_join_group_matches_reference(rng, nr_a, nr_j, nq):
    f, a, j, fv, jv, d, rc = _columns(rng, 4099, 83, 47)
    ca, cj = _stack(rng, nr_a), _stack(rng, nr_j)
    cj[1] = np.abs(cj[1]) % 5000          # join weights are row counts
    cj[4] = np.abs(cj[4]) % 5000
    cb, vb = _code_bounds(rng, 83, nq), _vbounds(rng, nq)
    want = _tuples(ref_join_group(f, a, j, fv, jv, d, rc, cb, ca, cj, vb))
    args = (T(f), T(a), T(j), T(fv), T(jv), T(d), T(rc), cb, T(ca), T(cj),
            vb)
    assert scan_filter_agg_join_group(*args) == want
    assert scan_filter_agg_join_group_ref(*args) == want


def test_join_group_takes_absent_stacks(rng):
    f, a, j, fv, jv, d, rc = _columns(rng, 900, 40)
    ca = _stack(rng, 17)
    cb, vb = _code_bounds(rng, 40, 3), _vbounds(rng, 3)
    base = (T(f), T(a), T(j), T(fv), T(jv), T(d), T(rc), cb)
    for pa, pj in ((None, None), (ca, None), (None, ca)):
        got = scan_filter_agg_join_group(
            *base, None if pa is None else T(pa),
            None if pj is None else T(pj), vb)
        assert got == _tuples(ref_join_group(f, a, j, fv, jv, d, rc, cb, pa,
                                             pj, vb))


@pytest.mark.parametrize("nr", [0, 3, 300])
def test_join_group_vs_pallas_interpret(interpret_mode, rng, nr):
    interpret_mode("1")
    f, a, j, fv, jv, d, rc = _columns(rng, 600, 31, 17)
    ca, cj = _stack(rng, nr), _stack(rng, nr + 2)
    cj[1], cj[4] = np.abs(cj[1]) % 900, np.abs(cj[4]) % 900
    cb, vb = _code_bounds(rng, 31, 9), _vbounds(rng, 9)
    assert scan_filter_agg_join_group(T(f), T(a), T(j), T(fv), T(jv), T(d),
                                      T(rc), cb, T(ca), T(cj), vb) == \
        _tuples(ref_join_group(f, a, j, fv, jv, d, rc, cb, ca, cj, vb))
