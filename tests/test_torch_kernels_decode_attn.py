"""The port's flash-decode attention (K16) on the CPU vs the JAX package's:
its Pallas kernel in interpret mode on the reference's sweep, and its jnp
oracle at cache lengths the kernel's wrapper does not take (S not a
multiple of 512, where the reference falls back). float32, 2e-5 (the
reference's kernel test)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attn import decode_attention as ref_decode
from repro.kernels.decode_attn.decode_attn import decode_attention_kernel
from repro.kernels.decode_attn.ref import decode_attention_ref as ref_plain
from repro_torch.kernels.common import (kernel_launch_counts,
                                        reset_kernel_launch_counts)
from repro_torch.kernels.decode_attn import (decode_attention,
                                             decode_attention_ref)

torch.set_num_threads(1)
T = torch.from_numpy
TOL = dict(rtol=2e-5, atol=2e-5)


def _inputs(rng, B, H, Hkv, S, d):
    q = rng.normal(size=(B, H, d)).astype(np.float32)
    k = rng.normal(size=(B, S, Hkv, d)).astype(np.float32)
    v = rng.normal(size=(B, S, Hkv, d)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("H,Hkv,S,L,cap", [(8, 2, 1024, 777, 0.0),
                                           (4, 4, 2048, 2048, 0.0),
                                           (8, 1, 512, 100, 50.0)])
def test_decode_attention_sweep_vs_the_pallas_kernel(rng, H, Hkv, S, L,
                                                     cap):
    B, d = 2, 64
    q, k, v = _inputs(rng, B, H, Hkv, S, d)
    want = decode_attention_kernel(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray([L], dtype=jnp.int32), d ** -0.5, cap, interpret=True)
    reset_kernel_launch_counts()
    got = decode_attention(T(q), T(k), T(v), L, softcap=cap)
    assert kernel_launch_counts() == {}          # the CPU runs no kernel
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("B,H,Hkv,S,L,d,cap", [
    (2, 10, 2, 777, 777, 128, 0.0),      # G 5, full cache, S % 512 != 0
    (1, 7, 1, 1000, 1, 128, 50.0),       # G 7, one valid slot
    (3, 16, 8, 300, 123, 256, 50.0),     # gemma2's heads
    (2, 4, 4, 9, 5, 64, 30.0),
])
def test_decode_attention_at_ragged_cache_lengths(rng, B, H, Hkv, S, L, d,
                                                  cap):
    q, k, v = _inputs(rng, B, H, Hkv, S, d)
    want = ref_plain(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), L,
                     d ** -0.5, cap)
    # the reference's wrapper takes its oracle here
    np.testing.assert_array_equal(
        np.asarray(ref_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              L, softcap=cap)), np.asarray(want))
    got = decode_attention(T(q), T(k), T(v), torch.tensor(L), softcap=cap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(
        decode_attention_ref(T(q), T(k), T(v), L, d ** -0.5, cap).numpy(),
        np.asarray(want), **TOL)


def test_decode_attention_keeps_the_query_type(rng):
    q, k, v = _inputs(rng, 1, 4, 2, 16, 64)
    got = decode_attention(T(q).bfloat16(), T(k).bfloat16(),
                           T(v).bfloat16(), 16)
    assert got.dtype == torch.bfloat16 and got.shape == (1, 4, 64)
