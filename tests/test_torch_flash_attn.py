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
