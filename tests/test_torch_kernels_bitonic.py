"""The port's sort-unit and fused apply-pipeline entries vs the JAX
package's (tolerance 0)."""

import numpy as np
import pytest
import torch

from repro.kernels import common as ref_common
from repro.kernels.bitonic_sort import (sort_1024 as ref_sort_1024,
                                        sort_rows as ref_sort_rows)
from repro.kernels.dict_ops import apply_pipeline_batch as ref_apply
from repro_torch.kernels.bitonic_sort import (apply_pipeline_batch,
                                              apply_pipeline_batch_ref,
                                              sort_1024, sort_rows,
                                              sort_rows_ref)
from repro_torch.kernels.common import next_pow2, width_bucket
from repro_torch.kernels import dict_ops

torch.set_num_threads(1)
T = torch.from_numpy
I32_MAX = np.iinfo(np.int32).max
I32_MIN = np.iinfo(np.int32).min


@pytest.fixture
def interpret_mode():
    yield ref_common.set_interpret_override
    ref_common.set_interpret_override(None)


@pytest.mark.parametrize("rows,width", [(8, 128), (16, 1024), (3, 100),
                                        (1, 1024), (5, 513), (1, 1), (2, 2),
                                        (4, 1500)])
def test_sort_rows_sweep(rng, rows, width):
    x = rng.integers(-1000, 1000, size=(rows, width)).astype(np.int32)
    got = sort_rows(T(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref_sort_rows(x)))
    np.testing.assert_array_equal(got.numpy(), np.sort(x, axis=-1))
    assert torch.equal(got, sort_rows_ref(T(x)))


@pytest.mark.parametrize("case", ["extremes", "all_equal", "sentinel_values",
                                  "already_sorted", "reversed"])
def test_sort_rows_edge_values(rng, case):
    x = rng.integers(I32_MIN, I32_MAX, size=(3, 77)).astype(np.int32)
    if case == "extremes":
        x[:, 0], x[:, 1] = I32_MAX, I32_MIN
    elif case == "all_equal":
        x[:] = 42
    elif case == "sentinel_values":
        x[:, ::3] = I32_MAX          # real values equal to the pad sentinel
    elif case == "already_sorted":
        x = np.sort(x, axis=1)
    else:
        x = np.sort(x, axis=1)[:, ::-1].copy()
    np.testing.assert_array_equal(sort_rows(T(x)).numpy(),
                                  np.asarray(ref_sort_rows(x)))


@pytest.mark.parametrize("rows,width", [(2, 64), (3, 100), (1, 1), (4, 1500)])
def test_sort_rows_float32_matches_reference(rng, rows, width):
    x = rng.standard_normal((rows, width)).astype(np.float32) * 1e6
    x[0, 0] = np.inf
    x[-1, -1] = -np.inf
    got = sort_rows(T(x))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref_sort_rows(x)))
    np.testing.assert_array_equal(sort_1024(T(x[0, :1024])).numpy(),
                                  np.asarray(ref_sort_1024(x[0, :1024])))


def test_sort_rows_float32_orders_nan_last():
    x = np.asarray([[np.nan, 1.0, -np.inf, np.inf, -0.5, np.nan, 2.0]],
                   dtype=np.float32)
    np.testing.assert_array_equal(sort_rows(T(x)).numpy(), np.sort(x, axis=1))


def test_sort_1024_unit_is_sized_like_the_paper(rng):
    v = rng.integers(0, 1 << 20, size=1024).astype(np.int32)
    np.testing.assert_array_equal(sort_1024(T(v)).numpy(),
                                  np.asarray(ref_sort_1024(v)))
    with pytest.raises(AssertionError):
        sort_1024(torch.zeros(2048, dtype=torch.int32))


def _stacks(rng, rows, n_old, n_val, w_old=None, w_val=None):
    w_old = w_old or width_bucket(n_old)
    w_val = w_val or width_bucket(n_val)
    old = np.full((rows, w_old), I32_MAX, dtype=np.int32)
    val = np.full((rows, w_val), I32_MAX, dtype=np.int32)
    for r in range(rows):
        k = max(1, n_old - r)                   # ragged rows
        m = max(1, n_val - 2 * r)
        old[r, :k] = np.sort(rng.choice(1 << 24, size=k, replace=False))
        val[r, :m] = rng.integers(0, 1 << 24, size=m)
        val[r, 0] = old[r, 0]                   # a value already present
    return old, val


def _edge(old, val, case):
    """The apply's edge values: a row of sentinels only, values all equal
    to an old key, int32.min among the values and the old keys."""
    if case == "old_sentinels_only":
        old[0] = I32_MAX
    elif case == "values_equal_an_old_key":
        for r in range(old.shape[0]):
            n = int((val[r] != I32_MAX).sum())
            val[r, :n] = old[r, n % max(1, int((old[r] != I32_MAX).sum()))]
    elif case == "int32_min":
        val[:, 1] = I32_MIN
        old[:, 0] = I32_MIN
        old[:] = np.sort(old, axis=1)
    return old, val


# (rows, n_old, n_val): widths cross pow2 buckets on both sides; the named
# cases add the tile merge's edges: the value widths 1, 2,048 (the largest
# sorted in every merge block), 4,096 and 65,536 (the separate sort, with
# pairwise merges), a dictionary width that is not a multiple of a merge
# tile (4,096 slots), the edge values of `_edge`, and 1 and 65 rows
@pytest.mark.parametrize("rows,n_old,n_val,edge", [
    pytest.param(1, 1, 1, None, id="1-1-1"),
    pytest.param(2, 8, 8, None, id="2-8-8"),
    pytest.param(4, 32, 100, None, id="4-32-100"),
    pytest.param(3, 33, 5, None, id="3-33-5"),
    pytest.param(8, 600, 129, None, id="8-600-129"),
    pytest.param(2, 1025, 1024, None, id="2-1025-1024"),
    pytest.param(5, 7, 300, None, id="5-7-300"),
    pytest.param(3, 40, 1, dict(w_val=1), id="w_val_1"),
    pytest.param(2, 5000, 2000, dict(w_val=2048), id="w_val_2048"),
    pytest.param(2, 6000, 3000, None, id="w_val_4096"),
    pytest.param(1, 1000, 40_000, None, id="w_val_65536"),
    pytest.param(3, 4500, 200, dict(w_old=5003), id="w_old_5003"),
    pytest.param(3, 300, 50, dict(case="old_sentinels_only"),
                 id="old_sentinels_only"),
    pytest.param(4, 300, 60, dict(case="values_equal_an_old_key"),
                 id="values_equal_an_old_key"),
    pytest.param(2, 300, 70, dict(case="int32_min"), id="int32_min"),
    pytest.param(65, 90, 20, None, id="65_rows"),
])
def test_apply_pipeline_matches_reference(rng, rows, n_old, n_val, edge):
    torch.set_num_threads(1)
    edge = edge or {}
    old, val = _stacks(rng, rows, n_old, n_val, edge.get("w_old"),
                       edge.get("w_val"))
    old, val = _edge(old, val, edge.get("case"))
    svals, merged = apply_pipeline_batch(T(old), T(val))
    rs, rm = ref_apply(old, val)
    np.testing.assert_array_equal(svals.numpy(), np.asarray(rs))
    np.testing.assert_array_equal(merged.numpy(), np.asarray(rm))
    assert merged.shape == (rows, next_pow2(old.shape[1] + val.shape[1]))
    ps, pm = apply_pipeline_batch_ref(T(old), T(val))
    assert torch.equal(ps, svals) and torch.equal(pm, merged)
    # what the caller slices out: real entries first, sentinels in the tail
    for r in range(rows):
        n_real = int((old[r] != I32_MAX).sum() + (val[r] != I32_MAX).sum())
        assert (merged[r, n_real:] == I32_MAX).all()


def test_apply_pipeline_is_reexported_where_the_reference_has_it():
    assert dict_ops.apply_pipeline_batch is apply_pipeline_batch


@pytest.mark.parametrize("rows,n_old,n_val", [(2, 8, 8), (3, 20, 40)])
def test_apply_pipeline_vs_pallas_interpret_kernels(interpret_mode, rows,
                                                    n_old, n_val):
    """Against the reference's sort network + half-cleaner merge themselves
    (Pallas interpret mode)."""
    rng = np.random.default_rng(7)
    old, val = _stacks(rng, rows, n_old, n_val)
    interpret_mode("1")
    rs, rm = ref_apply(old, val)
    rsort = np.asarray(ref_sort_rows(val))
    interpret_mode(None)
    svals, merged = apply_pipeline_batch(T(old), T(val))
    np.testing.assert_array_equal(svals.numpy(), np.asarray(rs))
    np.testing.assert_array_equal(merged.numpy(), np.asarray(rm))
    np.testing.assert_array_equal(sort_rows(T(val)).numpy(), rsort)


# ---------------------------------------------------------------------------
# the CUDA tile merge (csrc/bitonic.cu), modelled in numpy
# ---------------------------------------------------------------------------

def _cu_constant(name):
    import pathlib
    import re
    src = (pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"
           / "kernels" / "csrc" / "bitonic.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


MT, MT_THREADS = _cu_constant("MT"), _cu_constant("MT_THREADS")
IPT = MT // MT_THREADS


def _merge_path(a, a_off, wa, b, b_off, wb, d):
    """`merge_path`: a's entries among the first d outputs, ties a first."""
    lo, hi = max(0, d - wb), min(d, wa)
    while lo < hi:
        mid = (lo + hi) >> 1
        if b[d - 1 - mid - b_off] < a[mid - a_off]:
            hi = mid
        else:
            lo = mid + 1
    return lo


def _merge_path_warp(a, wa, b, wb, d):
    """`merge_path_warp`: 32 probes a step, a ballot of a monotone test."""
    lo, hi = max(0, d - wb), min(d, wa)
    while lo < hi:
        span = hi - lo
        before = [not b[d - 1 - (lo + ((span * ln) >> 5))]
                  < a[lo + ((span * ln) >> 5)] for ln in range(32)]
        t = sum(before)
        assert before == [True] * t + [False] * (32 - t)   # a prefix
        new_lo = lo + ((span * (t - 1)) >> 5) + 1 if t else lo
        hi = lo + ((span * t) >> 5) if t < 32 else hi
        lo = new_lo
    return lo


def _stage(x, width, lo, hi):
    """`stage` with 16-byte loads: x[lo & ~3 .. ceil4(hi)) where the width
    is a multiple of 4 (the rows here are aligned), else x[lo .. hi)."""
    if hi <= lo:
        return x[:0], lo
    if width % 4 == 0:
        lo4, hi4 = lo & ~3, (hi + 3) & ~3
        assert hi4 <= width
        return x[lo4:hi4], lo4
    return x[lo:hi], lo


def _runs(a, a_off, wa, b, b_off, wb, i, g, total):
    """`merge_run`: IPT slots from split (i, g - i), the pad from total."""
    j, out = g - i, []
    for m in range(IPT):
        if g + m >= total:
            out.append(I32_MAX)
        elif j >= wb or (i < wa and not b[j - b_off] < a[i - a_off]):
            out.append(a[i - a_off])
            i += 1
        else:
            out.append(b[j - b_off])
            j += 1
    return out


def tile_merge_np(a, b, w_out, fused):
    """One row of the tile merge: `apply_tiles_kernel` (fused: b sorted in
    the block, a's reachable window staged) or `merge_tiles_kernel` (both
    slices found by the warps' splits and staged)."""
    wa, wb = len(a), len(b)
    total, out = wa + wb, []
    for t0 in range(0, w_out, MT):
        n_tile = min(MT, w_out - t0)
        if t0 >= total:
            out += [I32_MAX] * n_tile
            continue
        tile = []
        if fused:
            sa, a_off = _stage(a, wa, max(0, t0 - wb), min(t0 + MT, wa))
            assert len(sa) <= MT + wb + 8
            for k in range(MT_THREADS):
                g = t0 + k * IPT
                i = _merge_path(sa, a_off, wa, b, 0, wb, g) if g < total \
                    else wa
                tile += _runs(sa, a_off, wa, b, 0, wb, i, g, total)
        else:
            d1 = min(t0 + MT, total)
            a_lo = _merge_path_warp(a, wa, b, wb, t0)
            a_hi = _merge_path_warp(a, wa, b, wb, d1)
            sa, sa0 = _stage(a, wa, a_lo, a_hi)
            sb, sb0 = _stage(b, wb, t0 - a_lo, d1 - a_hi)
            assert len(sa) <= MT + 8 and len(sb) <= MT + 8
            la, lb = a_hi - a_lo, d1 - a_hi - (t0 - a_lo)
            for k in range(MT_THREADS):
                g = k * IPT
                i = _merge_path(sa, sa0 - a_lo, la, sb, sb0 - (t0 - a_lo),
                                lb, g) if g < la + lb else la
                tile += _runs(sa, sa0 - a_lo, la, sb, sb0 - (t0 - a_lo), lb,
                              i, g, la + lb)
        out += tile[:n_tile]
    return np.asarray(out, dtype=np.int64)


# (w_old, n_old, w_val, n_val): the path's 32,768 + 256, ties everywhere
# (narrow key ranges), widths not multiples of 4 or of a tile, one value
@pytest.mark.parametrize("w_old,n_old,w_val,n_val,keys", [
    (32768, 24_000, 256, 200, 1 << 30), (8192, 8192, 2048, 2048, 50),
    (5003, 4500, 256, 256, 7), (64, 40, 1, 1, 1 << 30), (4, 0, 2, 2, 3),
    (9000, 9000, 4096, 3000, 1000)])
def test_tile_merge_model_matches_the_sort(rng, w_old, n_old, w_val, n_val,
                                           keys):
    """The kernels' splits write every slot once, with the sorted multiset:
    the fused entry's tiles (values sorted in the block) and the device-
    memory tile merge (the sort's pairwise merges, the large entry)."""
    torch.set_num_threads(1)
    old = np.full(w_old, I32_MAX, dtype=np.int64)
    old[:n_old] = np.sort(rng.integers(-keys, keys, n_old))
    val = np.full(w_val, I32_MAX, dtype=np.int64)
    val[:n_val] = rng.integers(-keys, keys, n_val)
    w_merge = next_pow2(w_old + w_val)
    want = np.sort(np.concatenate([old, val, np.full(w_merge - w_old - w_val,
                                                     I32_MAX)]))
    svals = np.sort(val)
    for fused in ((True, False) if w_val <= 2048 else (False,)):
        got = tile_merge_np(list(old), list(svals), w_merge, fused)
        np.testing.assert_array_equal(got, want)
