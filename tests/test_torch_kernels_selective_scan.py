"""The port's selective scan (K17) on the CPU vs the JAX package's: its
Pallas kernel in interpret mode on the reference's sweep, its jnp oracle
at sizes the kernel's wrapper does not take (T or D not a multiple of the
blocks), and the decode step. float32, 3e-5 (the reference's kernel
test)."""

import pathlib
import re

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
                                        kernel_launch_shapes,
                                        reset_kernel_launch_counts)
from repro_torch.kernels.selective_scan import ops as scan_ops
from repro_torch.kernels.selective_scan import (STATE_SIZES, selective_scan,
                                                selective_scan_bwd_ref,
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


# ---------------------------------------------------------------------------
# The kernel's arithmetic (csrc/selective_scan.cu) modelled in numpy: each
# channel's N states split across LANES lanes, h rounded as the plain
# version rounds it, only y_t's sum over N in the kernel's order.
# ---------------------------------------------------------------------------

LANES = 2    # the kernel's `L`: lanes a channel's states are split across


def lane_split_scan_np(x, dt, a, b, c, d):
    """float32 model of the lane-split kernel. h: exp, then separate
    float32 multiplies and an add, as the plain version. y_t: lane l sums
    h * C_t over its states l*S .. l*S + S - 1 (a multiply, then fused
    multiply-adds, modelled as one rounding of the float64 value), the
    lane partials meet in the xor butterfly, then D * x_t is added."""
    f32, f64 = np.float32, np.float64
    B, Tn, D = x.shape
    N = a.shape[1]
    S = N // LANES
    h = np.zeros((B, D, N), f32)
    y = np.empty_like(x)
    for t in range(Tn):
        xt, dtt = x[:, t], dt[:, t]
        da = np.exp(dtt[..., None] * a[None])
        h = da * h + (dtt * xt)[..., None] * b[:, t][:, None, :]
        hc = (h.reshape(B, D, LANES, S), np.broadcast_to(
            c[:, t][:, None, :], (B, D, N)).reshape(B, D, LANES, S))
        part = hc[0][..., 0] * hc[1][..., 0]
        for i in range(1, S):
            part = (hc[0][..., i].astype(f64) * hc[1][..., i].astype(f64)
                    + part.astype(f64)).astype(f32)
        o = 1
        while o < LANES:
            part = part + part[..., np.arange(LANES) ^ o]
            o <<= 1
        y[:, t] = part[..., 0] + d[None] * xt
    return y


@pytest.mark.parametrize("N", STATE_SIZES)
def test_lane_split_order_holds_the_tolerance_at_prefill_length(rng, N):
    """The kernel's y_t order against the JAX package's oracle at T = 2048
    (falcon-mamba-7b's prefill length), for every d_state it takes."""
    args = _inputs(rng, 2, 2048, 6, N)
    want = np.asarray(ref_plain(*map(jnp.asarray, args)))
    got = lane_split_scan_np(*args)
    assert got.dtype == np.float32 and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.fixture
def gpu_branch(monkeypatch):
    """The wrapper's GPU branch on CPU tensors: the device rule patched to
    take it, the bare launch replaced by the numpy model of the kernel."""
    seen = []

    def launch(x, dt, a, b, c, d, y):
        seen.append(tuple(x.shape) + (a.shape[1],))
        y.copy_(T(lane_split_scan_np(*(t.numpy() for t in (x, dt, a, b, c,
                                                            d)))))
    monkeypatch.setattr(scan_ops, "on_gpu", lambda *tensors: True)
    monkeypatch.setattr(scan_ops, "launch_selective_scan", launch)
    reset_kernel_launch_counts()
    yield seen
    reset_kernel_launch_counts()


@pytest.mark.parametrize("B,Tn,D,N", [(1, 1, 1, 4), (2, 37, 100, 8),
                                      (3, 70, 130, 16)])
def test_selective_scan_gpu_branch(gpu_branch, rng, B, Tn, D, N):
    args = _inputs(rng, B, Tn, D, N)
    got = selective_scan(*map(T, args))
    assert gpu_branch == [(B, Tn, D, N)]
    assert kernel_launch_counts() == {"selective_scan": 1}
    assert kernel_launch_shapes() == {"selective_scan": {(B, Tn, D, N): 1}}
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(ref_plain(*map(jnp.asarray, args))),
                               **TOL)


def test_selective_scan_gpu_branch_refuses(gpu_branch, rng):
    x, dt, a, b, c, d = map(T, _inputs(rng, 1, 5, 8, 16))
    with pytest.raises(ValueError):
        selective_scan(x, dt, a[:, :12].contiguous(), b[..., :12], c, d)
    with pytest.raises(ValueError):                       # d_state 12
        selective_scan(x, dt, a[:, :12].contiguous(),
                       b[..., :12].contiguous(), c[..., :12].contiguous(), d)
    with pytest.raises(TypeError):
        selective_scan(x.double(), dt, a, b, c, d)
    with pytest.raises(ValueError):                       # not contiguous
        selective_scan(x.transpose(0, 1), dt.transpose(0, 1), a, b, c, d)
    assert gpu_branch == [] and kernel_launch_counts() == {}


# ---------------------------------------------------------------------------
# The backward (csrc/selective_scan.cu: selective_scan_bwd) and its plain
# version. Against jax.grad of the reference's oracle and torch autograd of
# the port's: within 1e-5 of each gradient's largest |value| (sums over
# T, B and D in other orders).
# ---------------------------------------------------------------------------

GRAD_TOL = 1e-5
GRAD_SHAPES = [(1, 256, 128, 8), (2, 512, 256, 16), (1, 1, 1, 4),
               (2, 37, 100, 4), (3, 300, 130, 16), (1, 17, 128, 8)]


def _assert_rel(got, want, tol=GRAD_TOL, what=""):
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape, (what, i)
        err = float(np.abs(g - w).max())
        assert err <= tol * max(float(np.abs(w).max()), 1e-30), (
            f"{what} gradient {i}: max abs err {err}")


@pytest.mark.parametrize("B,Tn,D,N", GRAD_SHAPES)
def test_selective_scan_bwd_ref_vs_jax_grad(rng, B, Tn, D, N):
    import jax
    args = _inputs(rng, B, Tn, D, N)
    gy = rng.normal(size=(B, Tn, D)).astype(np.float32)
    want = jax.grad(lambda *a: jnp.sum(ref_plain(*a) * gy),
                    argnums=tuple(range(6)))(*map(jnp.asarray, args))
    got = selective_scan_bwd_ref(*map(T, args), T(gy))
    _assert_rel([g.numpy() for g in got], want, what="vs jax.grad")
    # and torch autograd of the port's plain scan
    targs = [T(a).requires_grad_() for a in args]
    auto = torch.autograd.grad(selective_scan_ref(*targs), targs, T(gy))
    _assert_rel([g.numpy() for g in got], [a.numpy() for a in auto],
                what="vs autograd")


class _PlainScan(torch.autograd.Function):
    """`selective_scan_ref` with `selective_scan_bwd_ref` as its backward,
    for gradcheck."""

    @staticmethod
    def forward(ctx, *args):
        ctx.save_for_backward(*args)
        return selective_scan_ref(*args)

    @staticmethod
    def backward(ctx, gy):
        return scan_ops.selective_scan_bwd_ref(*ctx.saved_tensors, gy)


@pytest.mark.parametrize("B,Tn,D,N", [(1, 5, 3, 4), (2, 7, 2, 8)])
def test_selective_scan_bwd_ref_gradcheck(rng, B, Tn, D, N):
    args = [T(a).double().requires_grad_() for a in _inputs(rng, B, Tn, D,
                                                             N)]
    assert torch.autograd.gradcheck(_PlainScan.apply, args, eps=1e-6,
                                    atol=1e-7, rtol=1e-5)


def test_backward_constants_match_the_source():
    src = (pathlib.Path(scan_ops.__file__).resolve().parents[1] / "csrc"
           / "selective_scan.cu").read_text()
    consts = {m.group(1): int(m.group(2)) for m in re.finditer(
        r"constexpr int (\w+) = (\d+);", src)}
    assert consts["CH"] == scan_ops.BWD_CHANNELS
    assert consts["TT"] == scan_ops.BWD_TILE
    # the lanes a channel by d_state, and one instance for each d_state
    m = re.search(r"constexpr int bwd_lanes\(int N\) \{\s*"
                  r"return N == 4 \? (\d+) : (\d+);", src)
    assert m, "bwd_lanes not found in selective_scan.cu"
    assert {4: int(m.group(1)), 8: int(m.group(2)),
            16: int(m.group(2))} == scan_ops.BWD_LANES
    for entry in ("launch", "launch_bwd", "occupancy_bwd"):
        built = {int(n) for n in re.findall(rf"\b{entry}<(\d+)\b", src)}
        assert built == set(STATE_SIZES), entry


# ---------------------------------------------------------------------------
# The backward kernel's arithmetic modelled in numpy, float32: h and da_t as
# the forward rounds them; per (t, channel) each lane's sums over its S
# states in order (fused multiply-adds, modelled as one rounding of the
# float64 value), the channel's LB lane partials folded in half (the
# reduce-scatter and butterfly of `scatter_sum`: lanes l and l + LB/2
# first); per (t, state) the sums over a warp's 32/LB channels folded in
# half, the block's warps added in warp order, one row per block of 32
# channels (the wrapper adds the rows).
# ---------------------------------------------------------------------------

SSM_BWD_TOL = 1e-4      # chip_smoke.SSM_BWD_TOL: of each gradient's max |g|


def _fma(a, b, c):
    f64 = np.float64
    return (np.asarray(a, f64) * np.asarray(b, f64)
            + np.asarray(c, f64)).astype(np.float32)


def _fold(v):
    """Sum over the last axis, folded in half (pairs i, i + n/2 first)."""
    while v.shape[-1] > 1:
        h = v.shape[-1] // 2
        v = v[..., :h] + v[..., h:]
    return v[..., 0]


def lanes_bwd_np(x, dt, a, b, c, d, gy, lanes):
    """float32 model of the backward kernel at `lanes` lanes a channel:
    (gx, gdt, ga_part, gb_part, gc_part, gd_part), the partial sums shaped
    as `_bwd_buffers` shapes them."""
    f32 = np.float32
    B, Tn, D = x.shape
    N = a.shape[1]
    S, CH = N // lanes, scan_ops.BWD_CHANNELS
    cw = 32 // lanes                       # channels a warp
    blocks = -(-D // CH)
    h = np.zeros((B, D, N), f32)
    hs, das = [], []
    for t in range(Tn):
        da = np.exp(dt[:, t, :, None] * a[None])
        h = da * h + (dt[:, t] * x[:, t])[..., None] * b[:, t][:, None, :]
        hs.append(h)
        das.append(da)
    gx, gdt = np.empty_like(x), np.empty_like(x)
    gb_part = np.empty((blocks, B, Tn, N), f32)
    gc_part = np.empty_like(gb_part)
    P = np.zeros((B, D, N), f32)
    gacc = np.zeros((B, D, N), f32)
    gd = np.zeros((B, D), f32)
    al = a.reshape(D, lanes, S)

    def channels(v):                       # (B, D, N) -> (blocks, B, N)
        v = np.concatenate([v, np.zeros((B, blocks * CH - D, N), f32)], 1)
        v = v.reshape(B, blocks, CH // cw, cw, N).transpose(1, 0, 2, 4, 3)
        w = _fold(v)                       # (blocks, B, warps, N)
        out = w[:, :, 0]
        for q in range(1, CH // cw):
            out = out + w[:, :, q]
        return out

    for t in reversed(range(Tn)):
        xt, dtt, gyt = x[:, t], dt[:, t], gy[:, t]
        da, hc = das[t], hs[t]
        hp = hs[t - 1] if t else np.zeros_like(h)
        G = _fma(gyt[..., None], c[:, t][:, None, :], P)
        qh = (G * da) * hp
        gl, bl, ql = (G.reshape(B, D, lanes, S),
                      np.broadcast_to(b[:, t][:, None, :],
                                      (B, D, N)).reshape(B, D, lanes, S),
                      qh.reshape(B, D, lanes, S))
        gbs = np.zeros((B, D, lanes), f32)
        gds = np.zeros((B, D, lanes), f32)
        for i in range(S):
            gbs = _fma(gl[..., i], bl[..., i], gbs)
            gds = _fma(al[None, :, :, i], ql[..., i], gds)
        gacc = _fma(dtt[..., None], qh, gacc)
        gx[:, t] = _fma(dtt, _fold(gbs), d[None] * gyt)
        gdt[:, t] = _fold(_fma(xt[..., None], gbs, gds))
        gb_part[:, :, t] = channels(G * (dtt * xt)[..., None])
        gc_part[:, :, t] = channels(gyt[..., None] * hc)
        P = da * G
        gd = _fma(gyt, xt, gd)
    return gx, gdt, gacc, gb_part, gc_part, gd


_JAX_GRADS = {}


@pytest.mark.parametrize("N,lanes", scan_ops.BWD_LANES.items())
def test_lane_sums_of_the_backward_hold_the_tolerance(N, lanes):
    """The backward kernel's summation orders at its lanes for each
    d_state against jax.grad of the JAX package's oracle at T = 2048, two
    sequences and 40 channels (two blocks of channels, several warps)."""
    import jax
    rng = np.random.default_rng(N)
    args = _inputs(rng, 2, 2048, 40, N)
    gy = rng.normal(size=(2, 2048, 40)).astype(np.float32)
    if N not in _JAX_GRADS:
        _JAX_GRADS[N] = jax.grad(lambda *a: jnp.sum(ref_plain(*a) * gy),
                                 argnums=tuple(range(6)))(
            *map(jnp.asarray, args))
    gx, gdt, ga, gb, gc, gd = lanes_bwd_np(*args, gy, lanes)
    shapes = [tuple(t.shape) for t in scan_ops._bwd_buffers(
        2, 2048, 40, N, "meta")[:4]]
    assert [ga.shape, gb.shape, gc.shape, gd.shape] == shapes
    got = [gx, gdt, ga.sum(0), gb.sum(0), gc.sum(0), gd.sum(0)]
    assert all(g.dtype == np.float32 and np.isfinite(g).all() for g in got)
    _assert_rel(got, _JAX_GRADS[N], tol=SSM_BWD_TOL,
                what=f"lane model N={N} LB={lanes}")


@pytest.fixture
def bwd_gpu_branch(monkeypatch):
    """Both wrappers' GPU branch on CPU tensors: the forward's launch
    writes the plain scan, the backward's the numpy model of the kernel at
    its lanes, every partial row as the kernel writes them (the wrapper
    sums them)."""
    seen = []

    def fwd(x, dt, a, b, c, d, y):
        y.copy_(selective_scan_ref(x, dt, a, b, c, d))

    def bwd(x, dt, a, b, c, d, gy, gx, gdt, ga_part, gb_part, gc_part,
            gd_part, ckpt):
        B, Tn, D = x.shape
        N = a.shape[1]
        want = scan_ops._bwd_buffers(B, Tn, D, N, "meta")
        assert [t.shape for t in (ga_part, gb_part, gc_part, gd_part,
                                  ckpt)] == [t.shape for t in want]
        seen.append((B, Tn, D, N))
        got = lanes_bwd_np(*(t.numpy() for t in (x, dt, a, b, c, d, gy)),
                           scan_ops.BWD_LANES[N])
        for out, v in zip((gx, gdt, ga_part, gb_part, gc_part, gd_part),
                          got):
            out.copy_(T(v))

    monkeypatch.setattr(scan_ops, "on_gpu", lambda *tensors: True)
    monkeypatch.setattr(scan_ops, "launch_selective_scan", fwd)
    monkeypatch.setattr(scan_ops, "launch_selective_scan_bwd", bwd)
    reset_kernel_launch_counts()
    yield seen
    reset_kernel_launch_counts()


@pytest.mark.parametrize("B,Tn,D,N", [(1, 1, 1, 4), (2, 37, 100, 8),
                                      (3, 70, 130, 16)])
def test_selective_scan_autograd_gpu_branch(bwd_gpu_branch, rng, B, Tn, D,
                                            N):
    """`SelectiveScan` rehearsed: the same gradients as plain autograd, one
    launch of each kernel, and None where an input needs none."""
    args = _inputs(rng, B, Tn, D, N)
    gy = rng.normal(size=(B, Tn, D)).astype(np.float32)
    plain = [T(a).requires_grad_() for a in args]
    want = torch.autograd.grad(selective_scan_ref(*plain), plain, T(gy))
    targs = [T(a).requires_grad_(i != 5) for i, a in enumerate(args)]
    y = selective_scan(*targs)
    assert y.grad_fn is not None
    y.backward(T(gy))
    assert bwd_gpu_branch == [(B, Tn, D, N)]
    assert kernel_launch_counts() == {"selective_scan": 1,
                                      "selective_scan_bwd": 1}
    assert targs[5].grad is None
    _assert_rel([t.grad.numpy() for t in targs[:5]],
                [w.numpy() for w in want[:5]], what="rehearsed")
    # no gradient asked for: the plain launch, no graph
    reset_kernel_launch_counts()
    with torch.no_grad():
        assert selective_scan(*targs).grad_fn is None
    assert kernel_launch_counts() == {"selective_scan": 1}


def test_selective_scan_backward_refuses_cpu_tensors(rng):
    """The Function's backward never falls back to the plain version."""
    import types
    inputs = tuple(map(T, _inputs(rng, 1, 3, 4, 4)))
    ctx = types.SimpleNamespace(saved_tensors=inputs,
                                needs_input_grad=(True,) * 6)
    with pytest.raises(RuntimeError, match="CUDA tensors only"):
        scan_ops.SelectiveScan.backward(ctx, torch.ones(1, 3, 4))


# ---------------------------------------------------------------------------
# The gated entry (`selective_scan_gated`): dt's bias and softplus before
# the scan, the silu(z) gate after it. On the CPU it is Mamba's plain chain
# bit for bit; its GPU branch is rehearsed with each bare launch writing
# the kernel's arithmetic (`selective_scan_gated_f32`,
# `selective_scan_gated_bwd_ref`: float32 from the operands, each output
# rounded once).
# ---------------------------------------------------------------------------

BF = torch.bfloat16


def _gated_inputs(rng, B, Tn, D, N, dtype=torch.float32):
    """x, dt_raw, dt_bias, a, b, c, d, z as Mamba's block hands them: x,
    dt_raw, dt_bias of `dtype`, z the second half of a (B, T, 2 D)
    projection (a strided view), b and c slices of x_proj's output, a and
    d float32."""
    x, dt, a, b, c, d = map(T, _inputs(rng, B, Tn, D, N))
    raw = T(rng.normal(size=(B, Tn, D)).astype(np.float32)) - 2.5
    bias = T(rng.normal(size=(D,)).astype(np.float32)) * 0.3
    xz = T(rng.normal(size=(B, Tn, 2 * D)).astype(np.float32)).to(dtype)
    proj = torch.cat([b, c], -1).to(dtype)
    return (x.to(dtype), raw.to(dtype), bias.to(dtype), a,
            proj[..., :N], proj[..., N:], d, xz.chunk(2, dim=-1)[1])


def _todays_chain(x, dt_raw, dt_bias, a, b, c, d, z):
    """Mamba's block before the gated entry, written out: the biased
    softplus in the operands' type, the float32 scan on float32 copies,
    y rounded back, times silu(z)."""
    def f32(t):
        return t.to(torch.float32).contiguous()
    dt = torch.nn.functional.softplus(dt_raw + dt_bias)
    y = selective_scan(f32(x), f32(dt), f32(a), f32(b), f32(c), f32(d))
    return y.to(x.dtype) * (z * torch.sigmoid(z))


@pytest.mark.parametrize("dtype", [torch.float32, BF])
@pytest.mark.parametrize("B,Tn,D,N", [(1, 9, 6, 4), (2, 21, 10, 16)])
def test_gated_plain_version_is_todays_chain_bit_for_bit(rng, B, Tn, D, N,
                                                         dtype):
    """The CPU's gated entry against the chain it replaced, forward and
    every gradient, in float32 and bf16."""
    from repro_torch.kernels.selective_scan import selective_scan_gated
    args = _gated_inputs(rng, B, Tn, D, N, dtype)
    g = T(rng.normal(size=(B, Tn, D)).astype(np.float32)).to(dtype)
    outs = []
    for fn in (_todays_chain, selective_scan_gated):
        leaves = [t.detach().clone().requires_grad_() for t in args]
        y = fn(*leaves)
        outs.append((y, torch.autograd.grad(y, leaves, g)))
    (want, want_g), (got, got_g) = outs
    assert got.dtype == dtype and torch.equal(got, want)
    for i, (p, q) in enumerate(zip(got_g, want_g)):
        assert p.dtype == q.dtype and torch.equal(p, q), i


@pytest.mark.parametrize("B,Tn,D,N", [(1, 9, 6, 4), (2, 40, 33, 8)])
def test_gated_written_out_backward_matches_autograd(rng, B, Tn, D, N):
    """`selective_scan_gated_bwd_ref`, the kernel's backward in plain
    PyTorch, against autograd of the float32 chain (within 1e-5 of each
    gradient's largest |value|), dt_raw past softplus's threshold in a
    few places."""
    from repro_torch.kernels.selective_scan import (
        selective_scan_gated_bwd_ref, selective_scan_gated_f32,
        selective_scan_gated_ref)
    args = list(_gated_inputs(rng, B, Tn, D, N))
    args[1] = args[1].clone()
    args[1][:, ::5, ::3] = 21.0
    g = T(rng.normal(size=(B, Tn, D)).astype(np.float32))
    leaves = [t.detach().clone().requires_grad_() for t in args]
    want = torch.autograd.grad(selective_scan_gated_ref(*leaves), leaves, g)
    y, y_pre = selective_scan_gated_f32(*args)
    assert torch.equal(y, selective_scan_gated_ref(*args))
    gx, g_raw, gbias, ga, gb, gc, gd, gz = selective_scan_gated_bwd_ref(
        *args, y_pre, g)
    _assert_rel([gx, g_raw, gbias, ga, gb, gc, gd, gz],
                [w.numpy() for w in want], what="written-out gated")


def test_mamba_train_on_the_cpu_launches_nothing(rng):
    """The block on CPU tensors: the plain chain, no kernel launched and no
    ``mamba.gated_scan`` counted."""
    from repro_torch import tracing
    from repro_torch.nn.mamba import init_mamba, mamba_train
    gen = torch.Generator().manual_seed(0)
    p = init_mamba(gen, 16, 32, 4, 4, 2)
    x = T(rng.normal(size=(2, 7, 16)).astype(np.float32))
    reset_kernel_launch_counts()
    tracing.clear()
    with tracing.recording():
        y = mamba_train(p, x, d_inner=32, d_state=4, d_conv=4, dt_rank=2)
    assert y.shape == x.shape and torch.isfinite(y).all()
    assert kernel_launch_counts() == {}
    assert not any("mamba.gated_scan" in r.counts for r in tracing.records())
    tracing.clear()


def fake_gated_scan_launches(monkeypatch):
    """The gated entry's GPU branch on CPU tensors: each bare launch writes
    the kernel's arithmetic in plain PyTorch (float32 from the operands,
    each output rounded once by `copy_`; the backward's partial sums in
    their first row, as float32). Returns the y_pre each forward launch got (None
    where no backward follows)."""
    seen = []

    def fwd(x, dt_raw, dt_bias, a, b, c, d, z, y, y_pre=None):
        assert y.is_contiguous() and y.dtype == x.dtype
        seen.append(y_pre)
        out, pre = scan_ops.selective_scan_gated_f32(x, dt_raw, dt_bias, a,
                                                     b, c, d, z)
        y.copy_(out)
        if y_pre is not None:
            y_pre.copy_(pre)

    def bwd(x, dt_raw, dt_bias, a, b, c, d, z, y_pre, g, gx, g_raw, gz,
            ga_part, gb_part, gc_part, gd_part, gbias_part, ckpt):
        B, Tn, D = x.shape
        want = scan_ops._bwd_buffers(B, Tn, D, a.shape[1], "meta")
        assert [t.shape for t in (ga_part, gb_part, gc_part, gd_part,
                                  ckpt)] == [t.shape for t in want]
        assert gbias_part.shape == (B, D)
        gx_, gr_, gbias, ga, gb, gc, gd, gz_ = \
            scan_ops.selective_scan_gated_bwd_ref(x, dt_raw, dt_bias, a, b,
                                                  c, d, z, y_pre, g)
        for out, val in ((gx, gx_), (g_raw, gr_), (gz, gz_)):
            out.copy_(val)
        for part, total in ((ga_part, ga), (gb_part, gb), (gc_part, gc),
                            (gd_part, gd), (gbias_part, gbias.float())):
            part.zero_()[0] = total

    monkeypatch.setattr(scan_ops, "on_gpu", lambda *tensors: True)
    monkeypatch.setattr(scan_ops, "launch_selective_scan_gated", fwd)
    monkeypatch.setattr(scan_ops, "launch_selective_scan_gated_bwd", bwd)
    return seen


@pytest.fixture
def gated_gpu_branch(monkeypatch):
    reset_kernel_launch_counts()
    yield fake_gated_scan_launches(monkeypatch)
    reset_kernel_launch_counts()


@pytest.mark.parametrize("B,Tn,D,N", [(1, 1, 1, 4), (2, 37, 100, 8),
                                      (3, 70, 130, 16)])
def test_gated_autograd_gpu_branch(gated_gpu_branch, rng, B, Tn, D, N):
    """`SelectiveScanGated` rehearsed: the plain chain's gradients, one
    launch each way counted under the plain kernels' names and shapes, one
    ``mamba.gated_scan``, y_pre kept for the backward; None where an input
    needs no gradient; without autograd, no y_pre."""
    from repro_torch import tracing
    from repro_torch.kernels.selective_scan import (selective_scan_gated,
                                                    selective_scan_gated_ref)
    args = _gated_inputs(rng, B, Tn, D, N)
    g = T(rng.normal(size=(B, Tn, D)).astype(np.float32))
    plain = [t.detach().clone().requires_grad_() for t in args]
    want = torch.autograd.grad(selective_scan_gated_ref(*plain), plain, g)
    leaves = [t.detach().clone().requires_grad_(i != 6)
              for i, t in enumerate(args)]
    tracing.clear()
    with tracing.recording():
        y = selective_scan_gated(*leaves)
    counted = sum(r.counts.get("mamba.gated_scan", 0)
                  for r in tracing.records())
    tracing.clear()
    assert counted == 1 and y.grad_fn is not None
    y.backward(g)
    assert kernel_launch_shapes() == {
        "selective_scan": {(B, Tn, D, N): 1},
        "selective_scan_bwd": {(B, Tn, D, N): 1}}
    assert gated_gpu_branch[0] is not None and leaves[6].grad is None
    got = [t.grad for i, t in enumerate(leaves) if i != 6]
    _assert_rel([t.numpy() for t in got],
                [w.numpy() for i, w in enumerate(want) if i != 6],
                what="rehearsed gated")
    reset_kernel_launch_counts()
    with torch.no_grad():
        assert selective_scan_gated(*leaves).grad_fn is None
    assert kernel_launch_counts() == {"selective_scan": 1}
    assert gated_gpu_branch[-1] is None


def test_gated_gpu_branch_refuses(gated_gpu_branch, rng):
    from repro_torch.kernels.selective_scan import selective_scan_gated
    x, raw, bias, a, b, c, d, z = _gated_inputs(rng, 1, 5, 8, 16, BF)
    with pytest.raises(TypeError):                        # mixed types
        selective_scan_gated(x.float(), raw, bias, a, b, c, d, z)
    with pytest.raises(TypeError):
        selective_scan_gated(x.double(), raw.double(), bias.double(), a, b,
                             c, d, z.double())
    z_t = z.transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError):                       # z along T
        selective_scan_gated(x, raw, bias, a, b, c, d, z_t)
    with pytest.raises(ValueError):                       # not contiguous
        selective_scan_gated(x.transpose(0, 1), raw, bias, a, b, c, d, z)
    with pytest.raises(ValueError):                       # d_state 12
        selective_scan_gated(x, raw, bias, a[:, :12], b[..., :12],
                             c[..., :12], d, z)
    with pytest.raises(ValueError):                       # bias
        selective_scan_gated(x, raw, bias[:4], a, b, c, d, z)
    assert gated_gpu_branch == [] and kernel_launch_counts() == {}


def test_gated_backward_refuses_cpu_tensors(rng):
    """The gated Function's backward never falls back to the plain
    version."""
    import types
    args = _gated_inputs(rng, 1, 3, 4, 4)
    ctx = types.SimpleNamespace(saved_tensors=(*args, args[0]),
                                needs_input_grad=(True,) * 8)
    with pytest.raises(RuntimeError, match="CUDA tensors only"):
        scan_ops.SelectiveScanGated.backward(ctx, torch.ones(1, 3, 4))
