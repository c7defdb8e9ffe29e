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


# (rows, n_old, n_val): widths cross pow2 buckets on both sides
@pytest.mark.parametrize("rows,n_old,n_val", [(1, 1, 1), (2, 8, 8), (4, 32, 100),
                                              (3, 33, 5), (8, 600, 129),
                                              (2, 1025, 1024), (5, 7, 300)])
def test_apply_pipeline_matches_reference(rng, rows, n_old, n_val):
    old, val = _stacks(rng, rows, n_old, n_val)
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
