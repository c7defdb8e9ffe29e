"""The port's selective scan (K17) on the CPU vs the JAX package's: its
Pallas kernel in interpret mode on the reference's sweep, its jnp oracle
at sizes the kernel's wrapper does not take (T or D not a multiple of the
blocks), and the decode step. float32, 3e-5 (the reference's kernel
test)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.selective_scan import selective_scan as ref_scan
from repro.kernels.selective_scan.ref import (selective_scan_ref as ref_plain,
                                              selective_scan_step_ref as
                                              ref_step)
from repro.kernels.selective_scan.selective_scan import selective_scan_kernel
from repro_torch.kernels.common import (kernel_launch_counts,
                                        reset_kernel_launch_counts)
from repro_torch.kernels.selective_scan import (selective_scan,
                                                selective_scan_ref,
                                                selective_scan_step_ref)

torch.set_num_threads(1)
T = torch.from_numpy
TOL = dict(rtol=3e-5, atol=3e-5)


def _inputs(rng, B, Tn, D, N):
    x = rng.normal(size=(B, Tn, D)).astype(np.float32)
    dt = (np.abs(rng.normal(size=(B, Tn, D))) * 0.1).astype(np.float32)
    a = (-np.abs(rng.normal(size=(D, N)))).astype(np.float32)
    b = rng.normal(size=(B, Tn, N)).astype(np.float32)
    c = rng.normal(size=(B, Tn, N)).astype(np.float32)
    d = rng.normal(size=(D,)).astype(np.float32)
    return x, dt, a, b, c, d


@pytest.mark.parametrize("B,Tn,D,N", [(1, 256, 128, 8), (2, 512, 256, 16)])
def test_selective_scan_sweep_vs_the_pallas_kernel(rng, B, Tn, D, N):
    args = _inputs(rng, B, Tn, D, N)
    want = selective_scan_kernel(*map(jnp.asarray, args), d_block=min(128, D),
                                 t_block=min(256, Tn), interpret=True)
    reset_kernel_launch_counts()
    got = selective_scan(*map(T, args))
    assert kernel_launch_counts() == {}
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("B,Tn,D,N", [(1, 1, 1, 4), (2, 37, 100, 4),
                                      (3, 300, 130, 16), (1, 17, 128, 8)])
def test_selective_scan_at_ragged_sizes(rng, B, Tn, D, N):
    args = _inputs(rng, B, Tn, D, N)
    want = np.asarray(ref_plain(*map(jnp.asarray, args)))
    # the reference's wrapper takes its oracle here
    np.testing.assert_array_equal(
        np.asarray(ref_scan(*map(jnp.asarray, args))), want)
    np.testing.assert_allclose(selective_scan(*map(T, args)).numpy(), want,
                               **TOL)
    np.testing.assert_allclose(selective_scan_ref(*map(T, args)).numpy(),
                               want, **TOL)


@pytest.mark.parametrize("B,D,N", [(1, 8, 4), (3, 130, 16)])
def test_selective_scan_step(rng, B, D, N):
    h = rng.normal(size=(B, D, N)).astype(np.float32)
    x, dt, a, b, c, d = _inputs(rng, B, 1, D, N)
    args = (h, x[:, 0], dt[:, 0], a, b[:, 0], c[:, 0], d)
    want_h, want_y = ref_step(*map(jnp.asarray, args))
    got_h, got_y = selective_scan_step_ref(*map(T, args))
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), **TOL)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), **TOL)
