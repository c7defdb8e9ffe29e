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
from repro_torch.kernels.decode_attn.ops import (MAX_SPLITS, TILE,
                                                 shape_supported, split_plan)

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


@pytest.mark.parametrize("L,cap", [(777, 0.0), (1024, 50.0), (1, 50.0)])
def test_decode_attention_at_kimi_heads_vs_the_pallas_kernel(rng, L, cap):
    """kimi-k2's heads: head_dim 112, G 8 (64 query heads over 8 KV heads),
    the shape the first CUDA kernel refused."""
    B, H, Hkv, S, d = 1, 64, 8, 1024, 112
    q, k, v = _inputs(rng, B, H, Hkv, S, d)
    want = decode_attention_kernel(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray([L], dtype=jnp.int32), d ** -0.5, cap, interpret=True)
    got = decode_attention(T(q), T(k), T(v), L, softcap=cap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _attention_configs():
    from repro_torch.configs import ARCH_NAMES, get_config
    for name in ARCH_NAMES:
        cfg = get_config(name)
        mixers = {cfg.blocks[i % cfg.period].mixer
                  for i in range(cfg.n_layers)}
        if mixers - {"mamba"}:
            yield name, cfg


def test_every_attention_config_fits_the_kernels_shape_rule():
    """Each full config with attention layers decodes through the kernel on
    the card: its (head_dim, n_heads / n_kv_heads) passes the rule the
    wrapper checks (d 112 of kimi-k2 included)."""
    seen = {}
    for name, cfg in _attention_configs():
        assert cfg.n_heads % cfg.n_kv_heads == 0, name
        group = cfg.n_heads // cfg.n_kv_heads
        assert shape_supported(cfg.head_dim, group), (name, cfg.head_dim,
                                                      group)
        seen[name] = (cfg.head_dim, group)
    assert seen["kimi-k2-1t-a32b"] == (112, 8)
    assert seen["gemma2-9b"] == (256, 2)
    assert "falcon-mamba-7b" not in seen
    for d, g in ((8, 1), (120, 2), (272, 1), (128, 9), (64, 0)):
        assert not shape_supported(d, g)


@pytest.mark.parametrize("per_sm", [1, 2, 3, 4])
@pytest.mark.parametrize("B,Hkv,length", [(4, 8, 32768),   # decode_32k
                                          (4, 8, 287),     # the serve path
                                          (4, 8, 1),
                                          (64, 8, 4096),   # pairs fill waves
                                          (1, 1, 500_000)])  # split cap
def test_split_plan_fills_whole_waves(B, Hkv, length, per_sm):
    """On 132 SMs: the splits cover [0, length) in chunks of whole 32-slot
    tiles, every split non-empty, and the grid is one wave where splitting
    is needed - nearly full at long caches (up to MAX_SPLITS splits),
    never a spill into a second wave (the first design ran 544 blocks on
    528)."""
    resident = per_sm * 132
    n_split, chunk = split_plan(length, B, Hkv, resident)
    assert chunk % TILE == 0 and TILE == 32 and 1 <= n_split <= MAX_SPLITS
    assert (n_split - 1) * chunk < length <= n_split * chunk
    blocks = n_split * B * Hkv
    if B * Hkv <= resident:
        assert blocks <= resident
    else:
        assert n_split == 1
    if length >= 32768:                      # long caches fill the wave
        assert blocks >= 0.9 * min(resident, MAX_SPLITS * B * Hkv)


def _tiled_like_the_kernel(q, k, v, length, scale, cap, n_split, chunk):
    """The kernel's arithmetic in float64 torch: per split, 32-slot tiles
    with one online-softmax rescale each, then the logsumexp combine."""
    B, H, d = q.shape
    Hkv = k.shape[2]
    qg = q.double().reshape(B, Hkv, H // Hkv, d)
    parts = []
    for s in range(n_split):
        m = torch.full(qg.shape[:3], -np.inf, dtype=torch.float64)
        l = torch.zeros(qg.shape[:3], dtype=torch.float64)
        acc = torch.zeros(qg.shape, dtype=torch.float64)
        for base in range(s * chunk, min((s + 1) * chunk, length), 32):
            kt = k[:, base:min(base + 32, length)].double()
            vt = v[:, base:min(base + 32, length)].double()
            sc = torch.einsum("bhgd,bshd->bhgs", qg, kt) * scale
            if cap > 0:
                sc = cap * torch.tanh(sc / cap)
            m_new = torch.maximum(m, sc.amax(-1))
            p = torch.exp(sc - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum("bhgs,bshd->bhgd",
                                                        p, vt)
            m = m_new
        parts.append((m, l, acc))
    M = torch.stack([m for m, _, _ in parts]).amax(0)
    L = sum(torch.exp(m - M) * l for m, l, _ in parts)
    A = sum(torch.exp(m - M)[..., None] * a for m, _, a in parts)
    return (A / L[..., None]).reshape(B, H, d)


@pytest.mark.parametrize("B,H,Hkv,S,d,length,cap,resident", [
    (2, 64, 8, 1000, 112, 777, 50.0, 264),
    (1, 16, 8, 4096, 256, 287, 50.0, 264),
    (3, 4, 2, 300, 16, 300, 0.0, 396),
    (1, 8, 8, 70, 64, 1, 0.0, 132),
])
def test_the_split_plan_and_combine_give_the_plain_answer(
        rng, B, H, Hkv, S, d, length, cap, resident):
    """The chunks `split_plan` hands the kernel, tiled and merged as the
    kernel does, give the plain version's answer: no slot is lost or read
    twice across splits and tiles."""
    q, k, v = (T(a) for a in _inputs(rng, B, H, Hkv, S, d))
    n_split, chunk = split_plan(length, B, Hkv, resident)
    got = _tiled_like_the_kernel(q, k, v, length, d ** -0.5, cap, n_split,
                                 chunk)
    want = decode_attention_ref(q, k, v, length, d ** -0.5, cap)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
