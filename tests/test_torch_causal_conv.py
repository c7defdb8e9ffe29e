"""The causal conv with its bias and SiLU (`repro_torch.kernels.causal_conv`)
on the CPU: the plain version against the chain `nn/mamba.py` ran before
the kernel (pad, shifted products, bias, ``x * sigmoid(x)``), bit for bit;
the written-out backward against autograd of the plain version; the
wrapper's GPU branch rehearsed with ``on_gpu`` patched to True and the bare
launches patched to write the plain versions' results, through
`mamba_train` and a remat train step: the autograd wiring, the launch
counts and shapes, the strided view of the in-projection it is handed;
then the constants shared with the source and the wrapper's refusals. The
kernels themselves are held against the plain versions on the card in
``tests/test_torch_gpu.py``.
"""

import dataclasses
import pathlib
import re

import numpy as np
import pytest
import torch
from torch.nn import functional as F

from repro_torch.kernels import common
from repro_torch.kernels.causal_conv import ops

torch.set_num_threads(1)

BF, F32 = torch.bfloat16, torch.float32
SOURCE = (pathlib.Path(ops.__file__).resolve().parent.parent / "csrc"
          / "causal_conv.cu")


def _inputs(B, T, D, dtype, K=4, seed=0, strided=False):
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0):
        return torch.from_numpy((rng.normal(size=shape) * scale)
                                .astype(np.float32)).to(dtype)
    if strided:        # the in-projection's first half: rows 2 D apart
        x = t(B, T, 2 * D).chunk(2, dim=-1)[0]
    else:
        x = t(B, T, D)
    return x, t(K, D, scale=K ** -0.5), t(D, scale=0.1)


def _chain_before_the_kernel(x, w, b):
    """`nn/mamba.py`'s `_causal_conv` followed by `nn.layers.silu`, as
    they were."""
    K, T = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = sum(xp[:, i:i + T, :] * w[i][None, None, :] for i in range(K))
    out = out + b[None, None, :]
    return out * torch.sigmoid(out)


@pytest.mark.parametrize("dtype", [BF, F32])
@pytest.mark.parametrize("B,T,D,strided", [(1, 1, 1, False),
                                           (2, 5, 12, True),
                                           (1, 67, 9, False),
                                           (3, 130, 40, True)])
def test_plain_version_equals_the_chain_it_replaces(B, T, D, strided,
                                                    dtype):
    x, w, b = _inputs(B, T, D, dtype, strided=strided)
    want = _chain_before_the_kernel(x, w, b)
    for got in (ops.causal_conv_silu_ref(x, w, b),
                ops.causal_conv_silu(x, w, b)):
        assert got.dtype == dtype and torch.equal(got, want)


@pytest.mark.parametrize("B,T,D", [(1, 1, 3), (2, 7, 5), (1, 70, 16)])
def test_backward_written_out_equals_autograd_of_the_plain_version(B, T, D):
    x, w, b = (t.double().requires_grad_() for t in _inputs(B, T, D, F32))
    gy = torch.from_numpy(np.random.default_rng(1).normal(size=(B, T, D)))
    want = torch.autograd.grad(ops.causal_conv_silu_ref(x, w, b), (x, w, b),
                               gy)
    got = ops.causal_conv_silu_bwd_ref(*(t.detach().float() for t in
                                         (x, w, b)), gy.float())
    for g, ref in zip(got, want):
        assert g.dtype == F32
        torch.testing.assert_close(g.double(), ref, rtol=1e-5, atol=1e-6)
    # in bf16: the float32 results rounded once
    xb, wb, bb = (t.detach().to(BF) for t in (x, w, b))
    got_bf = ops.causal_conv_silu_bwd_ref(xb, wb, bb, gy.to(BF))
    ref32 = ops.causal_conv_silu_bwd_ref(xb.float(), wb.float(), bb.float(),
                                         gy.to(BF).float())
    for g, ref in zip(got_bf, ref32):
        assert g.dtype == BF and torch.equal(g, ref.to(BF))


def fake_conv_launches(monkeypatch):
    """The GPU branch on CPU tensors: each bare launch writes its plain
    version's result as the kernel computes it (float32 from the operands,
    rounded once; the backward also checks the partials' layout). Returns
    the x each launch got, by direction."""
    seen = {"fwd": [], "bwd": []}

    def fwd(x, w, b, y):
        assert y.is_contiguous() and y.shape == x.shape
        seen["fwd"].append(x)
        y.copy_(ops.causal_conv_silu_ref(x.float(), w.float(), b.float()))

    def bwd(x, w, b, gy, dx, part, dw, db):
        B, T, D = x.shape
        assert gy.is_contiguous() and dx.is_contiguous()
        assert part.dtype == F32 and part.shape == (
            B * -(-T // ops.TILE), w.shape[0] + 1,
            -(-D // ops.CHANNELS) * ops.CHANNELS)
        seen["bwd"].append(x)
        for out, val in zip((dx, dw, db),
                            ops.causal_conv_silu_bwd_ref(x, w, b, gy)):
            out.copy_(val)

    monkeypatch.setattr(ops, "on_gpu", lambda *t: True)
    monkeypatch.setattr(ops, "launch_causal_conv", fwd)
    monkeypatch.setattr(ops, "launch_causal_conv_bwd", bwd)
    return seen


@pytest.fixture
def launches(monkeypatch):
    common.reset_kernel_launch_counts()
    yield fake_conv_launches(monkeypatch)
    common.reset_kernel_launch_counts()


def _mamba(dtype, d_model=16, d_inner=32, seed=0):
    from repro_torch.nn.mamba import init_mamba
    gen = torch.Generator().manual_seed(seed)
    p = init_mamba(gen, d_model, d_inner, 4, 4, 2, dtype=dtype)
    p["conv_b"] = torch.randn((d_inner,), generator=gen).to(dtype) * 0.1
    return p


def _grads(p, x):
    from repro_torch.nn.mamba import mamba_train
    leaves = {"x": x, "conv_w": p["conv_w"], "conv_b": p["conv_b"],
              "in_proj": p["in_proj"]["w"]}
    for t in leaves.values():
        t.requires_grad_(True)
    y = mamba_train(p, x, d_inner=32, d_state=4, d_conv=4, dt_rank=2)
    (y.float().square().sum()).backward()
    out = {k: t.grad.clone() for k, t in leaves.items()}
    for t in leaves.values():
        t.grad = None
        t.requires_grad_(False)
    return y.detach(), out


@pytest.mark.parametrize("T", [1, 9, 70])
def test_gpu_branch_through_mamba_train(launches, T):
    """The forward launch gets the in-projection's strided half, autograd
    reaches the kernel's backward once, and the gradients of the layer
    equal the plain path's (float32: the written-out backward against
    autograd's)."""
    p = _mamba(F32)
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(2, T, 16))
                         .astype(np.float32))
    y, got = _grads(p, x.clone())
    assert common.kernel_launch_counts() == {"causal_conv": 1,
                                             "causal_conv_bwd": 1}
    assert common.kernel_launch_shapes() == {
        "causal_conv": {(2, T, 32, 4): 1},
        "causal_conv_bwd": {(2, T, 32, 4): 1}}
    (xin,) = launches["fwd"]
    assert xin.shape == (2, T, 32) and xin.stride() == (T * 64, 64, 1)
    (saved,) = launches["bwd"]
    assert (saved.data_ptr(), saved.stride()) == (xin.data_ptr(),
                                                  xin.stride())
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ops, "on_gpu", lambda *t: False)
        y_plain, want = _grads(p, x.clone())
    torch.testing.assert_close(y, y_plain, rtol=0, atol=0)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=1e-4, atol=1e-5)


def test_gpu_branch_without_a_gradient_launches_the_forward_alone(launches):
    from repro_torch.nn.mamba import mamba_train
    p = _mamba(BF)
    x = torch.randn((1, 5, 16)).to(BF)
    with torch.no_grad():
        mamba_train(p, x, d_inner=32, d_state=4, d_conv=4, dt_rank=2)
    assert common.kernel_launch_counts() == {"causal_conv": 1}
    # an input that needs a gradient goes through the autograd Function
    xw = _inputs(1, 5, 8, BF)
    y = ops.causal_conv_silu(xw[0], xw[1].requires_grad_(), xw[2])
    assert y.grad_fn is not None and "CausalConvSiLU" in type(
        y.grad_fn).__name__
    (dw,) = torch.autograd.grad(y.float().sum(), xw[1])
    assert dw.dtype == BF and common.kernel_launch_counts() == {
        "causal_conv": 2, "causal_conv_bwd": 1}


def test_gpu_branch_in_a_remat_train_step_counts_two_forwards(launches):
    """falcon-mamba's smoke config with remat: the conv runs twice a layer
    (the forward and its recompute) and its backward once, as the train
    phases expect; the loss equals the plain path's."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.lm import init_lm, lm_loss
    cfg = dataclasses.replace(get_smoke_config("falcon-mamba-7b"),
                              remat=True, n_layers=2)
    model = init_lm(cfg, generator=torch.Generator().manual_seed(0),
                    device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (1, 9),
                         generator=torch.Generator().manual_seed(1),
                         dtype=torch.int32)
    model.requires_grad_(True)
    loss = lm_loss(model, toks[:, :-1], toks[:, 1:], cfg)
    loss.backward()
    assert common.kernel_launch_counts() == {"causal_conv": 2 * 2,
                                             "causal_conv_bwd": 2}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ops, "on_gpu", lambda *t: False)
        plain = lm_loss(model, toks[:, :-1], toks[:, 1:], cfg)
    assert float(loss.detach()) == float(plain.detach())


def test_empty_sequences_launch_nothing(launches):
    x, w, b = _inputs(2, 0, 8, BF)
    assert ops.causal_conv_silu(x, w, b).shape == (2, 0, 8)
    dx, dw, db = ops.causal_conv_silu_bwd(x, w, b, torch.empty_like(x))
    assert dx.shape == x.shape and not dw.any() and not db.any()
    assert common.kernel_launch_counts() == {}


def test_constants_match_the_source():
    src = SOURCE.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = ([^;]+);", src)
                   .group(1).split()[-1])
    assert const("TILE") == ops.TILE
    assert 2 * const("THREADS") == ops.CHANNELS
    assert re.search(r"constexpr int CH = 2 \* THREADS;", src)
    # one instance a type, at every K in TAPS
    for k in ops.TAPS:
        assert f"fwd<__nv_bfloat16, {k}>" in src and f"fwd<float, {k}>" in src
        assert f"bwd<__nv_bfloat16, {k}>" in src and f"bwd<float, {k}>" in src
    assert f"K != {ops.TAPS[0]}" in src and len(ops.TAPS) == 1


@pytest.mark.parametrize("case", ["taps", "float16", "mixed_types",
                                  "stride_along_d", "mixed_devices",
                                  "w_not_contiguous", "w_shape", "gy_shape",
                                  "gy_type", "rank"])
def test_gpu_branch_refuses_what_the_kernel_does_not_take(case,
                                                          monkeypatch):
    x, w, b = _inputs(2, 6, 8, BF)
    gy = None
    if case == "taps":
        w = torch.zeros((3, 8), dtype=BF)
    elif case == "float16":
        x, w, b = x.half(), w.half(), b.half()
    elif case == "mixed_types":
        w = w.float()
    elif case == "stride_along_d":
        x = torch.zeros((2, 8, 6), dtype=BF).transpose(1, 2)
    elif case == "mixed_devices":
        b = torch.zeros(8, dtype=BF, device="meta")
    elif case == "w_not_contiguous":
        w = torch.zeros((8, 4), dtype=BF).t()
    elif case == "w_shape":
        w = torch.zeros((4, 9), dtype=BF)
    elif case == "gy_shape":
        gy = torch.zeros((2, 5, 8), dtype=BF)
    elif case == "gy_type":
        gy = torch.zeros((2, 6, 8), dtype=F32)
    else:
        x = x[0]
    if case != "mixed_devices":
        monkeypatch.setattr(ops, "on_gpu", lambda *t: True)
    for name in ("launch_causal_conv", "launch_causal_conv_bwd"):
        monkeypatch.setattr(ops, name, lambda *a: pytest.fail(
            "launched what the kernel does not take"))
    with pytest.raises((TypeError, ValueError)):
        if gy is None:
            ops.causal_conv_silu(x, w, b)
        else:
            ops.causal_conv_silu_bwd(x, w, b, gy)
