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
from repro.kernels.dict_ops import \
    scan_filter_agg_sharded as ref_scan_sharded
from repro.kernels.hash_probe import scan_filter_agg_join as ref_join
from repro.kernels.hash_probe import \
    scan_filter_agg_join_sharded as ref_join_sharded
from repro_torch.kernels.dict_ops import (scan_exact, scan_exact_ref,
                                          scan_filter_agg,
                                          scan_filter_agg_batch,
                                          scan_filter_agg_batch_ref,
                                          scan_filter_agg_sharded,
                                          scan_filter_agg_sharded_ref)
from repro_torch.kernels.hash_probe import (scan_filter_agg_join,
                                            scan_filter_agg_join_ref,
                                            scan_filter_agg_join_sharded,
                                            scan_filter_agg_join_sharded_ref)

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


# ---------------------------------------------------------------------------
# the stacked (n_shards, width) form: every island in one launch
# ---------------------------------------------------------------------------

def _stacked(rng, sizes, k, kj=None):
    """Per-island shards of random columns laid out as a ShardedView lays
    them out: (n_shards, max size), padded slots codes 0 and invalid."""
    width = max(sizes, default=0)
    n = sum(sizes)
    f, a, j, fv, jv, d, rc = _columns(rng, n, k, kj=kj)
    out = []
    for col, fill in ((f, 0), (a, 0), (j, 0), (fv, False), (jv, False)):
        st = np.full((len(sizes), width), fill, dtype=col.dtype)
        lo = 0
        for s, size in enumerate(sizes):
            st[s, :size] = col[lo:lo + size]
            lo += size
        out.append(st)
    return (*out, d, rc)


# shards: equal, a padded tail, an empty shard, more shards than rows,
# one shard, wider than a 4096 block
SHARD_SWEEP = [(250, 250, 250, 250), (334, 333, 333), (0, 40, 41),
               (1, 1, 0, 0, 0), (777,), (5000, 4999), (0, 0)]


@pytest.mark.parametrize("sizes", SHARD_SWEEP)
@pytest.mark.parametrize("k", [7, 65])
def test_sharded_scan_matches_reference(rng, sizes, k):
    f, a, _, fv, _, d, _ = _stacked(rng, sizes, k)
    bounds = [(k // 4, 3 * k // 4), (0, k), (3, 3), (1, 2), (0, 1)]
    got = scan_filter_agg_sharded(T(f), T(a), T(fv), T(d), bounds)
    assert got == ref_scan_sharded(f, a, fv, d, bounds)
    assert got == scan_filter_agg_sharded_ref(T(f), T(a), T(fv), T(d), bounds)
    assert len(got) == len(sizes) and all(len(p) == len(bounds) for p in got)
    # each island's partials are the flat scan of its unpadded shard
    for s, size in enumerate(sizes):
        assert got[s] == scan_filter_agg_batch(
            T(f[s, :size].copy()), T(a[s, :size].copy()),
            T(fv[s, :size].copy()), T(d), bounds)


@pytest.mark.parametrize("sizes", SHARD_SWEEP)
def test_sharded_join_scan_matches_reference(rng, sizes):
    k = 33
    f, a, j, fv, jv, d, rc = _stacked(rng, sizes, k, kj=k + 5)
    bounds = [(0, k), (k // 3, k), (2, 2)]
    got = scan_filter_agg_join_sharded(T(f), T(a), T(j), T(fv), T(jv), T(d),
                                       T(rc), bounds)
    assert got == ref_join_sharded(f, a, j, fv, jv, d, rc, bounds)
    assert got == scan_filter_agg_join_sharded_ref(
        T(f), T(a), T(j), T(fv), T(jv), T(d), T(rc), bounds)
    for s, size in enumerate(sizes):
        assert got[s] == scan_filter_agg_join(
            *(T(x[s, :size].copy()) for x in (f, a, j, fv, jv)), T(d), T(rc),
            bounds)


def test_empty_dictionary_with_only_padded_slots(rng):
    """k = 0: no row is valid, so the guarded gather never looks a code up
    (the reference pads its dictionary instead)."""
    f = np.zeros((3, 5), np.int32)
    v = np.zeros((3, 5), bool)
    d = np.empty(0, np.int32)
    bounds = [(0, 0), (0, 1)]
    got = scan_filter_agg_sharded(T(f), T(f), T(v), T(d), bounds)
    assert got == ref_scan_sharded(f, f, v, d, bounds) == [[(0, 0)] * 2] * 3
    assert scan_filter_agg_join_sharded(T(f), T(f), T(f), T(v), T(v), T(d),
                                        T(d), bounds) == [[(0, 0, 0)] * 2] * 3
    assert scan_exact_ref(T(f[0]), T(f[0]), T(v[0]), T(d), bounds).shape == \
        (2, 2)


def test_sharded_scan_vs_pallas_interpret(interpret_mode):
    rng = np.random.default_rng(11)
    f, a, j, fv, jv, d, rc = _stacked(rng, (300, 299, 0), 32, kj=40)
    bounds = [(4, 20), (0, 32)]
    interpret_mode("1")
    want = ref_scan_sharded(f, a, fv, d, bounds)
    want_join = ref_join_sharded(f, a, j, fv, jv, d, rc, bounds)
    interpret_mode(None)
    assert scan_filter_agg_sharded(T(f), T(a), T(fv), T(d), bounds) == want
    assert scan_filter_agg_join_sharded(T(f), T(a), T(j), T(fv), T(jv), T(d),
                                        T(rc), bounds) == want_join


def test_sharded_scan_layout_is_per_shard_blocks(rng):
    f, a, j, fv, jv, d, rc = _stacked(rng, (100, 99), 12)
    got = scan_exact(T(f), T(a), T(fv), T(d), [(0, 12), (5, 6)], T(j),
                     T(jv), T(rc))
    assert got.dtype == torch.int64 and got.shape == (2, 3, 2)
    assert torch.equal(got[1], scan_exact(T(f[1]), T(a[1]), T(fv[1]), T(d),
                                          [(0, 12), (5, 6)], T(j[1]),
                                          T(jv[1]), T(rc)))


# ---------------------------------------------------------------------------
# the join lane at every predicate pass: one predicate (its own pass on the
# card), two to eight (the wide pass), and past eight (more grid slices)
# ---------------------------------------------------------------------------

JOIN_QS = [1, 2, 3, 8, 9, 17]


def _join_bounds(rng, k, nq):
    """nq code ranges: everything, an empty one, then random ones."""
    lows = rng.integers(0, k, size=nq)
    out = [(int(lo), int(lo) + 1 + int(rng.integers(0, k)))
           for lo in lows]
    out[0] = (0, k)
    if nq > 1:
        out[1] = (5, 5)
    return out


@pytest.mark.parametrize("nq", JOIN_QS)
@pytest.mark.parametrize("sizes", [(1001, 1000, 999), (7, 5, 6, 0), (4099,)])
def test_sharded_join_scan_at_every_predicate_pass_matches_reference(
        rng, sizes, nq):
    """Shards whose width (1001, 7, 4099) is not a multiple of 4, so on the
    card every shard after the first starts off a 16-byte boundary; rows
    that are fvalid but not jvalid add to the sum and count, not to the
    join sum."""
    k = 41
    f, a, j, fv, jv, d, rc = _stacked(rng, sizes, k, kj=k + 2)
    bounds = _join_bounds(rng, k, nq)
    got = scan_filter_agg_join_sharded(T(f), T(a), T(j), T(fv), T(jv), T(d),
                                       T(rc), bounds)
    assert got == ref_join_sharded(f, a, j, fv, jv, d, rc, bounds)
    assert got == scan_filter_agg_join_sharded_ref(
        T(f), T(a), T(j), T(fv), T(jv), T(d), T(rc), bounds)
    for s, size in enumerate(sizes):
        cols = [x[s, :size].copy() for x in (f, a, j, fv, jv)]
        assert got[s] == ref_join(*cols, d, rc, bounds)
