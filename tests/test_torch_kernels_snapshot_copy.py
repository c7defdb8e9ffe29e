"""The port's copy-unit entry vs the JAX package's (tolerance 0)."""

import numpy as np
import pytest
import torch

from repro.kernels import common as ref_common
from repro.kernels.snapshot_copy import snapshot_copy as ref_snapshot_copy
from repro_torch.kernels.snapshot_copy import (snapshot_copy,
                                               snapshot_copy_ref)

torch.set_num_threads(1)
T = torch.from_numpy


@pytest.fixture
def interpret_mode():
    yield ref_common.set_interpret_override
    ref_common.set_interpret_override(None)


def _inputs(rng, n, block, dirty):
    src = rng.integers(0, 10**6, size=n).astype(np.int32)
    prev = rng.integers(0, 10**6, size=n).astype(np.int32)
    n_chunks = (n + block - 1) // block
    flags = {"clean": np.zeros(n_chunks, np.int32),
             "dirty": np.ones(n_chunks, np.int32),
             "mixed": rng.integers(0, 2, size=n_chunks).astype(np.int32)}[dirty]
    return src, prev, flags


# full chunks, a ragged last chunk, one short chunk, above the reference's
# 65536-row host shortcut
@pytest.mark.parametrize("n,block", [(50_000, 8192), (8192, 1024),
                                     (1000, 256), (8193, 8192), (5, 8192),
                                     (70_000, 8192), (1, 1)])
@pytest.mark.parametrize("dirty", ["clean", "dirty", "mixed"])
def test_snapshot_copy_sweep(rng, n, block, dirty):
    src, prev, flags = _inputs(rng, n, block, dirty)
    got = snapshot_copy(T(src), T(prev), T(flags), block=block)
    want = np.asarray(ref_snapshot_copy(src, prev, flags, block=block))
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, snapshot_copy_ref(T(src), T(prev), T(flags), block))
    if dirty == "clean":
        np.testing.assert_array_equal(got.numpy(), prev)
    if dirty == "dirty":
        np.testing.assert_array_equal(got.numpy(), src)


@pytest.mark.parametrize("dtype", [torch.bool, torch.uint8, torch.int32])
def test_dirty_flags_of_any_mask_type(rng, dtype):
    src, prev, flags = _inputs(rng, 3000, 256, "mixed")
    want = np.asarray(ref_snapshot_copy(src, prev, flags, block=256))
    got = snapshot_copy(T(src), T(prev), T(flags).to(dtype), block=256)
    np.testing.assert_array_equal(got.numpy(), want)


def test_snapshot_copy_returns_a_new_tensor_and_checks_shapes(rng):
    src, prev, flags = _inputs(rng, 600, 256, "dirty")
    s = T(src)
    out = snapshot_copy(s, T(prev), T(flags), block=256)
    assert out.data_ptr() != s.data_ptr()
    assert snapshot_copy(T(src[:0]), T(prev[:0]), T(flags[:0])).shape == (0,)
    with pytest.raises(ValueError, match="flags"):
        snapshot_copy(s, T(prev), T(flags[:1]), block=256)
    with pytest.raises(ValueError, match="one shape"):
        snapshot_copy(s, T(prev[:-1]), T(flags), block=256)


def test_snapshot_copy_vs_pallas_interpret_kernel(interpret_mode):
    rng = np.random.default_rng(7)
    src, prev, _ = _inputs(rng, 300, 64, "mixed")
    flags = np.asarray([1, 0, 1, 1, 0], dtype=np.int32)
    interpret_mode("1")
    want = np.asarray(ref_snapshot_copy(src, prev, flags, block=64))
    interpret_mode(None)
    got = snapshot_copy(T(src), T(prev), T(flags), block=64)
    np.testing.assert_array_equal(got.numpy(), want)
