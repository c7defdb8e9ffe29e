"""The port's scan entries vs the JAX package's, on the same numpy inputs.

Integers throughout: tolerance 0. The reference runs as its own tests run
it on the CPU: the jitted lowering by default, Pallas interpret mode for
the small kernel-semantics cases.
"""

import numpy as np
import pytest
import torch

from repro.kernels import common as ref_common
from repro.kernels.dict_ops import (scan_filter_agg as ref_scan,
                                    scan_filter_agg_batch as ref_scan_batch)
from repro.kernels.dict_ops.ref import scan_filter_agg_batch_ref as ref_oracle
from repro.kernels.hash_probe import scan_filter_agg_join as ref_join
from repro_torch.kernels.dict_ops import (scan_exact, scan_exact_ref,
                                          scan_filter_agg,
                                          scan_filter_agg_batch,
                                          scan_filter_agg_batch_ref)
from repro_torch.kernels.hash_probe import (scan_filter_agg_join,
                                            scan_filter_agg_join_ref)

torch.set_num_threads(1)
T = torch.from_numpy


@pytest.fixture
def interpret_mode():
    yield ref_common.set_interpret_override
    ref_common.set_interpret_override(None)


def _columns(rng, n, k, kj=None, dmin=-(10**6), dmax=10**6):
    kj = kj or k
    fcodes = rng.integers(0, k, size=n).astype(np.int32)
    acodes = rng.integers(0, k, size=n).astype(np.int32)
    jcodes = rng.integers(0, kj, size=n).astype(np.int32)
    fvalid = rng.random(n) < 0.9
    jvalid = rng.random(n) < 0.85
    d = np.sort(rng.choice(np.arange(dmin, dmax, dtype=np.int64), size=k,
                           replace=False)).astype(np.int32)
    rcount = np.bincount(jcodes[jvalid], minlength=kj).astype(np.int32)
    return fcodes, acodes, jcodes, fvalid, jvalid, d, rcount


# n: empty, one row, non-pow2, over one 4096 block; k crossing a pow2 bucket
SWEEP = [(0, 8), (1, 8), (100, 3), (4096, 8), (4097, 33), (10_000, 64),
         (12_345, 65), (30_000, 500)]


@pytest.mark.parametrize("n,k", SWEEP)
def test_scan_batch_matches_reference(rng, n, k):
    f, a, _, v, _, d, _ = _columns(rng, n, k)
    bounds = [(k // 4, 3 * k // 4), (0, k), (k // 2, k // 2), (1, 2),
              (0, 1)]                         # Q = 5: not a power of two
    got = scan_filter_agg_batch(T(f), T(a), T(v), T(d), bounds)
    assert got == ref_scan_batch(f, a, v, d, bounds)
    assert got == ref_oracle(f, a, v, d, bounds)
    assert got == scan_filter_agg_batch_ref(T(f), T(a), T(v), T(d), bounds)
    assert all(type(x) is int for pair in got for x in pair)


@pytest.mark.parametrize("n,k", SWEEP)
def test_scan_join_matches_reference(rng, n, k):
    f, a, j, fv, jv, d, rc = _columns(rng, n, k, kj=k + 3)
    bounds = [(0, k), (k // 3, k), (2, 2)]
    got = scan_filter_agg_join(T(f), T(a), T(j), T(fv), T(jv), T(d), T(rc),
                               bounds)
    assert got == ref_join(f, a, j, fv, jv, d, rc, bounds)
    assert got == scan_filter_agg_join_ref(T(f), T(a), T(j), T(fv), T(jv),
                                           T(d), T(rc), bounds)
    # the join lane is a second exact scan with the histogram as dictionary
    keep = fv & jv
    want_j = [int(rc.astype(np.int64)[j[keep & (f >= lo) & (f < hi)]].sum())
              for lo, hi in bounds]
    assert [g[2] for g in got] == want_j


@pytest.mark.parametrize("nq", [1, 2, 3, 7, 8, 9, 19])
def test_scan_query_counts_that_are_not_powers_of_two(rng, nq):
    n, k = 5000, 40
    f, a, _, v, _, d, _ = _columns(rng, n, k)
    lows = rng.integers(0, k, size=nq)
    bounds = [(int(lo), int(lo) + 1 + i % 9) for i, lo in enumerate(lows)]
    assert (scan_filter_agg_batch(T(f), T(a), T(v), T(d), bounds)
            == ref_scan_batch(f, a, v, d, bounds))


@pytest.mark.parametrize("case", ["int32_extremes", "all_negative",
                                  "sum_beyond_int32", "nothing_valid",
                                  "empty_bounds"])
def test_scan_value_extremes(rng, case):
    n, k = 9000, 16
    f, a, _, v, _, d, _ = _columns(rng, n, k)
    bounds = [(0, k), (3, 11)]
    if case == "int32_extremes":
        d = np.sort(np.concatenate([[-2**31, 2**31 - 1],
                                    d[:k - 2]])).astype(np.int32)
    elif case == "all_negative":
        d = np.sort(-np.abs(d.astype(np.int64)) - 1).astype(np.int32)
    elif case == "sum_beyond_int32":
        d = np.sort(rng.integers(2**30, 2**31 - 1, size=k)).astype(np.int32)
    elif case == "nothing_valid":
        v = np.zeros(n, dtype=bool)
    else:
        bounds = []
    got = scan_filter_agg_batch(T(f), T(a), T(v), T(d), bounds)
    assert got == ref_scan_batch(f, a, v, d, bounds)
    if case == "sum_beyond_int32":
        assert got[0][0] > 2**40


@pytest.mark.parametrize("n,k", [(300, 32), (4097, 9)])
def test_scan_single_predicate_vs_pallas_interpret(interpret_mode, n, k):
    """The kernel-semantics oracle: the reference's Pallas kernel itself,
    in interpret mode."""
    rng = np.random.default_rng(7)
    f, a, j, fv, jv, d, rc = _columns(rng, n, k, dmin=-1000, dmax=1000)
    interpret_mode("1")
    want = ref_scan(f, a, fv, d, 4, 20, exact=True)
    want_join = ref_join(f, a, j, fv, jv, d, rc, [(4, 20), (0, k)])
    interpret_mode(None)
    got = scan_filter_agg(T(f), T(a), T(fv), T(d), 4, 20)
    assert got == (int(want[0]), int(want[1]))
    assert scan_filter_agg_join(T(f), T(a), T(j), T(fv), T(jv), T(d), T(rc),
                                [(4, 20), (0, k)]) == want_join


def test_valid_may_be_bool_or_uint8_and_results_are_tensors_of_int64(rng):
    f, a, j, fv, jv, d, rc = _columns(rng, 777, 12)
    bounds = [(0, 12), (5, 6)]
    ref = scan_exact_ref(T(f), T(a), T(fv), T(d), bounds, T(j), T(jv), T(rc))
    got = scan_exact(T(f), T(a), T(fv.astype(np.uint8)), T(d), bounds, T(j),
                     T(jv.astype(np.uint8)), T(rc))
    assert got.dtype == torch.int64 and got.shape == (3, 2)
    assert torch.equal(got, ref)
    assert scan_exact(T(f), T(a), T(fv), T(d), bounds).shape == (2, 2)
