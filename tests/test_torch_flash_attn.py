"""The port's blocked attention (``kernels/flash_attn``) on the CPU against
the JAX package's ``repro.nn.flash.flash_attention`` (a jitted nested
``lax.scan``; no Pallas kernel to run in interpret mode).

- `flash_attention_fwd_ref` (the plain loop) against the reference's
  output, and its log-sum-exp against a float32 numpy log-sum-exp of the
  masked scores: causal, sliding window, non-causal with Sq != Skv,
  softcap 30, G in {1, 2, 4}, float32 and bf16.
- `flash_attention_bwd_ref` (the kernels' algorithm written in plain torch)
  against ``jax.grad`` of the reference, and autograd of the port's plain
  loop against the same.
- The wrappers' GPU branch rehearsed on the CPU, as
  tests/test_torch_kernels_fold.py does: ``on_gpu`` patched to True and the
  bare launches patched to write the plain versions' results, so the
  `FlashAttention` plumbing, the launch counts (also under remat) and the
  refusals run as on the card.

Inputs come from seeded numpy; tolerances: float32 2e-5 relative plus
absolute; a bf16 output one bf16 step (2**-7 relative) more.
"""

import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from repro.nn import flash as ref_flash
from repro_torch.kernels import common
from repro_torch.kernels.flash_attn import ops
from repro_torch.nn import flash

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

torch.set_num_threads(1)

TOL = dict(rtol=2e-5, atol=2e-5)
# two float32 answers 2e-5 apart may round to neighbouring bf16 values:
# one bf16 step, 2**-7 of the value
BF16_TOL = dict(rtol=2**-7 + 2e-5, atol=2e-5)
BLOCKS = dict(q_block=16, kv_block=32)


def _inputs(seed, B, Sq, Skv, H, Hkv, dh):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=shape).astype(np.float32)
                 for shape in ((B, Sq, H, dh), (B, Skv, Hkv, dh),
                               (B, Skv, Hkv, dh)))


def _lse_numpy(q, k, causal, window, softcap):
    """float32 numpy log-sum-exp of each row's masked scores, (B, H, Sq)."""
    B, Sq, H, dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    kh = np.repeat(k, H // Hkv, axis=2)
    s = np.einsum("bqhd,bkhd->bhqk", q, kh).astype(np.float32) * dh ** -0.5
    if softcap > 0:
        s = softcap * np.tanh(s / softcap)
    i, j = np.arange(Sq)[:, None], np.arange(Skv)[None, :]
    mask = np.ones((Sq, Skv), dtype=bool)
    if causal:
        mask &= j <= i
    if window > 0:
        mask &= j > i - window
    s = np.where(mask, s, -np.inf)
    m = s.max(-1, keepdims=True)
    return (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]


CASES = [
    # (B, Sq, Skv, H, Hkv, dh), causal, window, softcap
    ((2, 64, 64, 4, 4, 16), True, 0, 0.0),          # G 1
    ((2, 64, 64, 4, 2, 16), True, 24, 0.0),         # G 2, window
    ((1, 32, 96, 4, 1, 16), False, 0, 0.0),         # G 4, Sq != Skv
    ((2, 64, 64, 8, 2, 32), True, 0, 30.0),         # softcap 30
    ((1, 64, 64, 4, 2, 16), True, 40, 30.0),        # window and softcap
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,causal,window,cap", CASES)
def test_fwd_ref_matches_the_reference(shape, causal, window, cap, dtype):
    q, k, v = _inputs(sum(shape), *shape)
    kw = dict(causal=causal, window=window, softcap=cap)
    want = ref_flash.flash_attention(
        *(jnp.asarray(x, dtype=getattr(jnp, dtype)) for x in (q, k, v)),
        **kw, **BLOCKS)
    got, lse = ops.flash_attention_fwd_ref(
        *(torch.tensor(x).to(getattr(torch, dtype)) for x in (q, k, v)),
        **kw, **BLOCKS)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, dtype=np.float32),
                               **(TOL if dtype == "float32" else BF16_TOL))
    if dtype == "bfloat16":      # the scores of the bf16-rounded inputs
        q, k = (torch.tensor(x).bfloat16().float().numpy() for x in (q, k))
    assert lse.dtype == torch.float32 and lse.shape == (
        shape[0], shape[3], shape[1])
    np.testing.assert_allclose(lse.numpy(), _lse_numpy(q, k, causal, window,
                                                       cap), **TOL)


@pytest.mark.parametrize("shape,causal,window,cap", CASES)
def test_bwd_ref_matches_jax_grad(shape, causal, window, cap):
    q, k, v = _inputs(sum(shape) + 1, *shape)
    dout = np.random.default_rng(7).normal(
        size=q.shape).astype(np.float32)
    kw = dict(causal=causal, window=window, softcap=cap)

    def loss(q, k, v):
        return (ref_flash.flash_attention(q, k, v, **kw, **BLOCKS)
                * dout).sum()
    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out, lse = ops.flash_attention_fwd_ref(tq, tk, tv, **kw, **BLOCKS)
    got = ops.flash_attention_bwd_ref(tq.detach(), tk.detach(), tv.detach(),
                                      out.detach(), lse.detach(),
                                      torch.tensor(dout),
                                      **kw, **BLOCKS)
    auto = torch.autograd.grad(out, (tq, tk, tv), torch.tensor(dout))
    for name, g, a, w in zip("qkv", got, auto, want):
        w = np.asarray(w)
        scale = np.abs(w).max()
        np.testing.assert_allclose(g.numpy() / scale, w / scale, rtol=0,
                                   atol=1e-5, err_msg=f"d{name}")
        np.testing.assert_allclose(a.numpy() / scale, w / scale, rtol=0,
                                   atol=1e-5, err_msg=f"autograd d{name}")


def test_bwd_ref_blocks_do_not_change_the_answer():
    """The plain backward at the kernel's default blocks (one block pair
    at this size) and at small blocks agree."""
    shape = (1, 64, 64, 4, 2, 16)
    q, k, v = (torch.tensor(x) for x in _inputs(3, *shape))
    dout = torch.tensor(np.random.default_rng(3).normal(
        size=q.shape).astype(np.float32))
    kw = dict(causal=True, window=20, softcap=30.0)
    out, lse = ops.flash_attention_fwd_ref(q, k, v, **kw)
    big = ops.flash_attention_bwd_ref(q, k, v, out, lse, dout, **kw)
    small = ops.flash_attention_bwd_ref(q, k, v, out, lse, dout, **kw,
                                        **BLOCKS)
    for a, b in zip(big, small):
        torch.testing.assert_close(a, b, **TOL)


# ---------------------------------------------------------------------------
# the GPU branch, rehearsed on the CPU
# ---------------------------------------------------------------------------

def fake_flash_launches(monkeypatch):
    """The blocked attention's GPU branch with its three bare launches
    writing the plain versions' results: the forward, the dQ pass (D as the
    kernel writes it, and the whole plain backward), the dK/dV pass (its
    dk, dv). The plain versions are bound here, so that a spy set later on
    `flash_attention_fwd_ref` counts only the wrapper's own calls of it."""
    fwd_ref, bwd_ref = ops.flash_attention_fwd_ref, ops.flash_attention_bwd_ref
    grads = []

    def fwd(q, k, v, out, lse, causal, window, softcap):
        o, l = fwd_ref(q, k, v, causal=causal, window=window,
                       softcap=softcap)
        out.copy_(o)
        lse.copy_(l)

    def bwd_dq(q, k, v, out, dout, lse, delta, dq, causal, window, softcap):
        delta.copy_((dout.float() * out.float()).sum(-1).transpose(1, 2))
        grads[:] = bwd_ref(q, k, v, out, lse, dout, causal=causal,
                           window=window, softcap=softcap)
        dq.copy_(grads[0])

    def bwd_dkdv(q, k, v, dout, lse, delta, dk, dv, *opts):
        dk.copy_(grads[1])
        dv.copy_(grads[2])
    monkeypatch.setattr(ops, "on_gpu", lambda *t: True)
    for name, fake in (("launch_flash_attention", fwd),
                       ("launch_flash_attention_bwd_dq", bwd_dq),
                       ("launch_flash_attention_bwd_dkdv", bwd_dkdv)):
        monkeypatch.setattr(ops, name, fake)


@pytest.fixture
def flash_gpu(monkeypatch):
    """`on_gpu` True and the bare launches faked (`fake_flash_launches`)."""
    fake_flash_launches(monkeypatch)
    common.reset_kernel_launch_counts()
    yield
    common.reset_kernel_launch_counts()


def _grad_inputs(seed=0, shape=(2, 64, 64, 4, 2, 64)):
    return tuple(torch.tensor(x, requires_grad=True)
                 for x in _inputs(seed, *shape))


@pytest.mark.parametrize("kw", [dict(causal=True),
                                dict(causal=True, window=24, softcap=50.0),
                                dict(causal=False)])
def test_gpu_branch_goes_through_the_function(flash_gpu, kw):
    """With a gradient to take: one forward launch, the `FlashAttention`
    node, two backward launches, the plain loop's answer and gradients."""
    q, k, v = _grad_inputs()
    out = flash.flash_attention(q, k, v, **kw, **BLOCKS)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    dout = torch.randn(out.shape, generator=torch.Generator().manual_seed(1))
    got = torch.autograd.grad(out, (q, k, v), dout)
    shape = (2, 64, 64, 4, 2, 64, int(kw["causal"]), kw.get("window", 0),
             int(kw.get("softcap", 0)))
    assert common.kernel_launch_counts() == {"flash_attention": 1,
                                             "flash_attention_bwd": 2}
    assert common.kernel_launch_shapes() == {
        "flash_attention": {shape: 1}, "flash_attention_bwd": {shape: 2}}
    ref = ops.flash_attention_fwd_ref(q, k, v, **kw, **BLOCKS)[0]
    torch.testing.assert_close(out, ref, **TOL)
    want = torch.autograd.grad(ref, (q, k, v), dout)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0,
                                   atol=1e-5 * float(w.abs().max()))


def test_gpu_branch_without_a_gradient_launches_once(flash_gpu):
    q, k, v = _grad_inputs()
    with torch.no_grad():
        out = flash.flash_attention(q, k, v, causal=True)
    assert out.grad_fn is None
    assert common.kernel_launch_counts() == {"flash_attention": 1}
    q, k, v = (t.detach() for t in (q, k, v))
    assert flash.flash_attention(q, k, v, causal=False).grad_fn is None
    assert common.kernel_launch_counts() == {"flash_attention": 2}


def test_gpu_branch_launch_counts_under_remat(flash_gpu):
    """Under `torch.utils.checkpoint` (as `models/encdec.py` remats a
    layer) the forward launches twice - the forward and its recompute -
    and the backward once (two launches)."""
    q, k, v = _grad_inputs(2)

    def layer(q, k, v):
        return flash.flash_attention(q, k, v, causal=True).square()
    checkpoint(layer, q, k, v, use_reentrant=False).sum().backward()
    assert common.kernel_launch_counts() == {"flash_attention": 2,
                                             "flash_attention_bwd": 2}
    want = torch.autograd.grad(
        ops.flash_attention_fwd_ref(q, k, v)[0].square().sum(), (q, k, v))
    for g, w in zip((q.grad, k.grad, v.grad), want):
        torch.testing.assert_close(g, w, rtol=0,
                                   atol=1e-5 * float(w.abs().max()))


def test_gpu_branch_backward_refuses_cpu_tensors(flash_gpu, monkeypatch):
    """The Function's backward never differentiates the plain loop: on
    tensors that lie on the CPU it raises."""
    q, k, v = _grad_inputs()
    out = flash.flash_attention(q, k, v, causal=True)
    monkeypatch.setattr(ops, "on_gpu", common.on_gpu)
    with pytest.raises(RuntimeError, match="CUDA tensors only"):
        out.sum().backward()


@pytest.mark.parametrize("case,error,match", [
    ("head_dim 96", ValueError, "flash_attention_fwd_ref"),
    ("length", ValueError, "multiples of the blocks"),
    ("no key in a row's band", ValueError, "no key in their band"),
    ("types", TypeError, "float32"),
    ("float16", TypeError, "float32 or bf16"),
    ("not contiguous", ValueError, "contiguous"),
    ("group", ValueError, "do not fit"),
])
def test_gpu_branch_refusals(flash_gpu, case, error, match):
    q, k, v = (t.detach() for t in _grad_inputs())
    kw = dict(causal=True)
    if case == "head_dim 96":
        q, k, v = (t[..., :48].repeat(1, 1, 1, 2).contiguous()
                   for t in (q, k, v))
    elif case == "length":
        q, k, v = (t[:, :48].contiguous() for t in (q, k, v))
        kw.update(q_block=32, kv_block=32)
    elif case == "no key in a row's band":
        k, v = k[:, :16].contiguous(), v[:, :16].contiguous()
        kw.update(causal=False, window=8, q_block=16, kv_block=16)
    elif case == "types":
        k = k.bfloat16()
    elif case == "float16":
        q, k, v = q.half(), k.half(), v.half()
    elif case == "not contiguous":
        q = q.transpose(0, 1).contiguous().transpose(0, 1)
    else:
        k, v = k[:, :, :1].expand(-1, -1, 3, -1).contiguous(), v[:, :, :3]
    with pytest.raises(error, match=match):
        flash.flash_attention(q, k, v, **kw)
    assert common.kernel_launch_counts() == {}


@pytest.mark.parametrize("dh", ops.HEAD_DIMS)
def test_gpu_branch_takes_every_configs_head_dim(flash_gpu, dh):
    """64 (whisper), 112 (kimi-k2), 128 and 256 (gemma2), bf16 as the
    paths run, with G = 8 at 112 and G = 2 at 256."""
    H, Hkv = {64: (8, 8), 112: (8, 1), 128: (5, 1), 256: (4, 2)}[dh]
    q, k, v = (torch.tensor(x).bfloat16() for x in _inputs(dh, 1, 32, 32, H,
                                                         Hkv, dh))
    out = flash.flash_attention(q, k, v, causal=True, softcap=50.0)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    assert common.kernel_launch_counts() == {"flash_attention": 1}


# ---------------------------------------------------------------------------
# the bf16 kernels' rounding points, emulated in plain torch
# ---------------------------------------------------------------------------
#
# The bf16 instances of csrc/flash_attn.cu multiply bf16 operands on the
# tensor cores and add in float32. Where they round is emulated here, tile
# by tile as the kernels walk: the forward splits the probabilities P into
# P_hi = bf16(P) and P_lo = bf16(P - P_hi) and sums both products, the
# backward rounds P and dS once each. Each emulation is held against the
# JAX package's float32 answer on the same bf16 values with the tolerances
# chip_smoke.py holds the kernels to on the card; a forward that rounds P
# once is shown to miss that bound, which is why the forward splits it.

LOG2E = 1.4426950408889634
EMU_TILE = 64                    # the kernels' key (and query) tile


def _band(Sq, Skv, causal, window):
    i, j = torch.arange(Sq)[:, None], torch.arange(Skv)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool)
    if causal:
        mask &= j <= i
    if window > 0:
        mask &= j > i - window
    return mask


def _scores2(q, k, causal, window, softcap):
    """float32 scores in base 2, (B, H, Sq, Skv), the masked -1e30, and the
    backward's factor scale (1 - tanh^2)."""
    B, Sq, H, dh = q.shape
    G = H // k.shape[2]
    scale = dh ** -0.5
    dot = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                       torch.repeat_interleave(k, G, dim=2).float())
    if softcap > 0:
        t = torch.tanh(dot * (scale / softcap))
        s2, f = softcap * LOG2E * t, scale * (1 - t * t)
    else:
        s2, f = dot * (scale * LOG2E), torch.full_like(dot, scale)
    mask = _band(Sq, k.shape[1], causal, window)
    return torch.where(mask, s2, torch.tensor(-1e30)), f, mask


def _bf16(x):
    return x.bfloat16().float()


def emulate_fwd(q, k, v, causal, window, softcap, split=True):
    """The bf16 forward's arithmetic: an online softmax in base 2 over key
    tiles of 64, P (float32) into the product as bf16 P_hi + bf16 P_lo
    (`split`) or as bf16 P alone. Returns (out bf16, lse float32)."""
    B, Sq, H, dh = q.shape
    vh = torch.repeat_interleave(v, H // k.shape[2], dim=2).float()
    s2, _, _ = _scores2(q, k, causal, window, softcap)
    m = torch.full((B, H, Sq, 1), -1e30)
    l = torch.zeros((B, H, Sq, 1))
    acc = torch.zeros((B, H, Sq, dh))
    for k0 in range(0, k.shape[1], EMU_TILE):
        s = s2[..., k0:k0 + EMU_TILE]
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        hi = _bf16(p)
        vt = vh[:, k0:k0 + EMU_TILE]
        pv = torch.einsum("bhqk,bkhd->bhqd", hi, vt)
        if split:
            pv = pv + torch.einsum("bhqk,bkhd->bhqd", _bf16(p - hi), vt)
        acc = acc * alpha + pv
        m = m_new
    out = (acc / l.clamp(min=1e-30)).transpose(1, 2).bfloat16()
    return out, (m / LOG2E + torch.log(l))[..., 0]


def emulate_bwd(q, k, v, out, lse, dout, causal, window, softcap):
    """The bf16 backward's arithmetic: P = 2^(s - lse log2 e) and dS = P
    (dP - D) scale (1 - tanh^2) in float32, each rounded once to bf16 for
    the products dV = P^T dO, dQ = dS K and dK = dS^T Q (float32 sums).
    Returns (dq, dk, dv) in bf16."""
    B, Sq, H, dh = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    s2, f, mask = _scores2(q, k, causal, window, softcap)
    p = torch.where(mask, torch.exp2(s2 - lse[..., None] * LOG2E), 0.0)
    do = dout.float()
    delta = (do * out.float()).sum(-1).transpose(1, 2)[..., None]
    dp = torch.einsum("bqhd,bkhd->bhqk", do,
                      torch.repeat_interleave(v, G, dim=2).float())
    ds = _bf16(p * f * (dp - delta))
    dq = torch.einsum("bhqk,bkhd->bqhd", ds,
                      torch.repeat_interleave(k, G, dim=2).float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    dv = torch.einsum("bhqk,bqhd->bkhd", _bf16(p), do)
    dk, dv = (g.reshape(B, k.shape[1], Hkv, G, dh).sum(3) for g in (dk, dv))
    return dq.bfloat16(), dk.bfloat16(), dv.bfloat16()


ROUNDING_CASES = [
    # (B, Sq, Skv, H, Hkv, dh), causal, window, softcap
    ((1, 128, 128, 4, 2, 64), True, 0, 0.0),
    ((1, 128, 128, 4, 2, 64), True, 48, 50.0),
    ((2, 96, 160, 2, 1, 64), False, 0, 0.0),        # Sq != Skv
    ((1, 128, 128, 2, 1, 256), True, 0, 50.0),
    ((1, 64, 192, 4, 2, 256), False, 0, 50.0),      # Sq != Skv
    ((1, 192, 128, 2, 2, 256), True, 96, 0.0),      # Sq > Skv, a window
]


def _bf16_inputs(seed, shape):
    """Seeded inputs rounded to bf16: (torch bf16 tensors, numpy float32
    arrays of the same values for the JAX package)."""
    t = tuple(torch.tensor(x).bfloat16() for x in _inputs(seed, *shape))
    return t, tuple(x.float().numpy() for x in t)


@pytest.mark.parametrize("shape,causal,window,cap", ROUNDING_CASES)
def test_split_p_forward_meets_the_chip_bound(shape, causal, window, cap):
    (q, k, v), arrays = _bf16_inputs(sum(shape) + 5, shape)
    kw = dict(causal=causal, window=window, softcap=cap)
    want = torch.tensor(np.asarray(ref_flash.flash_attention(
        *map(jnp.asarray, arrays), **kw, q_block=32, kv_block=32)))
    out, lse = emulate_fwd(q, k, v, causal, window, cap)
    chip_smoke.must_be_close_bf16("split-P forward", out, want)
    chip_smoke.must_be_close(
        "split-P log-sum-exp", lse,
        torch.tensor(_lse_numpy(*arrays[:2], causal, window, cap)),
        chip_smoke.FLASH_TOL)


@pytest.mark.parametrize("shape,causal,window,cap", ROUNDING_CASES[:3])
def test_p_rounded_once_misses_the_chip_bound(shape, causal, window, cap):
    """bf16(P) alone in the product (what a forward without the split
    does) puts a share of the outputs outside `must_be_close_bf16`."""
    (q, k, v), arrays = _bf16_inputs(sum(shape) + 5, shape)
    kw = dict(causal=causal, window=window, softcap=cap)
    want = torch.tensor(np.asarray(ref_flash.flash_attention(
        *map(jnp.asarray, arrays), **kw, q_block=32, kv_block=32)))
    out, _ = emulate_fwd(q, k, v, causal, window, cap, split=False)
    with pytest.raises(AssertionError, match="bf16 output differs"):
        chip_smoke.must_be_close_bf16("P rounded once", out, want)
    bound = chip_smoke.BF16_OUT_ATOL + chip_smoke.BF16_OUT_RTOL * want.abs()
    assert float(((out.float() - want).abs() > bound).float().mean()) > 0.01


@pytest.mark.parametrize("shape,causal,window,cap", ROUNDING_CASES)
def test_rounded_p_and_ds_backward_meets_the_chip_bound(shape, causal,
                                                        window, cap):
    (q, k, v), arrays = _bf16_inputs(sum(shape) + 6, shape)
    dout = torch.tensor(np.random.default_rng(11).normal(
        size=q.shape).astype(np.float32)).bfloat16()
    kw = dict(causal=causal, window=window, softcap=cap)

    def loss(q, k, v):
        return (ref_flash.flash_attention(q, k, v, **kw, q_block=32,
                                          kv_block=32)
                * jnp.asarray(dout.float().numpy())).sum()
    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, arrays))
    out, lse = emulate_fwd(q, k, v, causal, window, cap)
    got = emulate_bwd(q, k, v, out, lse, dout, causal, window, cap)
    # held as the card holds the kernels against their bf16 plain version
    chip_smoke.flash_bwd_check(
        "rounded-P backward", got,
        [torch.tensor(np.asarray(w)).bfloat16() for w in want])
