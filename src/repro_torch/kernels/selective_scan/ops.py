"""Selective scan (``csrc/selective_scan.cu``) and its plain versions.

Mamba-1's recurrence over a prompt: x, dt (B, T, D), a (D, N), b, c
(B, T, N), d (D,), all float32, -> y (B, T, D). The reference's wrapper
falls back to its jnp oracle when D or T is not a multiple of its blocks;
the kernel here takes any T and D. It splits each channel's N states
across two lanes of a warp (``csrc/selective_scan.cu``); its backward
across `BWD_LANES` lanes. One decode step
(``selective_scan_step_ref``) stays plain PyTorch on every device, as in
the reference.

Training differentiates the scan. The reference differentiates its plain
jnp scan; here a CUDA tensor that needs a gradient goes through
`SelectiveScan`, whose backward is the kernel ``selective_scan_bwd`` (same
file), the explicit reverse recurrence that `selective_scan_bwd_ref` is
in plain PyTorch. On the CPU autograd differentiates
`selective_scan_ref` itself.

Mamba's block calls the gated entry, `selective_scan_gated`: y =
scan(x, softplus(dt_raw + dt_bias), a, b, c, d) * silu(z) with x, dt_raw,
dt_bias, z and y of the activations' type. On CUDA tensors it is one
launch of the same kernels' gated instances forward (`SelectiveScanGated`)
and one backward, every operation in float32 and each output rounded
once; on the CPU the block's plain chain `selective_scan_gated_ref`.
"""

from __future__ import annotations

import torch
from torch.nn import functional as F

from repro_torch import tracing
from repro_torch.kernels import build
from repro_torch.kernels.common import check_tensor, count_launch, on_gpu

STATE_SIZES = (4, 8, 16)
# csrc/selective_scan.cu's CH (channels a block) and TT (steps a tile):
# the backward's partial sums have one row per block of channels, its
# scratch one state per tile
BWD_CHANNELS = 32
BWD_TILE = 16
# the backward's lanes a channel by d_state (`bwd_lanes`)
BWD_LANES = {4: 4, 8: 8, 16: 8}


def selective_scan_step_ref(h, xt, dtt, a, bt, ct, d):
    """Single decode step: h (B,D,N) -> (h', y_t (B,D))."""
    da = torch.exp(dtt[..., None] * a[None])
    h = da * h + (dtt * xt)[..., None] * bt[:, None, :]
    y = (h * ct[:, None, :]).sum(-1) + d[None] * xt
    return h, y


def selective_scan_ref(x, dt, a, b, c, d):
    """Plain PyTorch version: the recurrence one step at a time."""
    B, T, D = x.shape
    N = a.shape[1]
    h = torch.zeros((B, D, N), dtype=x.dtype, device=x.device)
    ys = []
    for t in range(T):
        h, y = selective_scan_step_ref(h, x[:, t], dt[:, t], a, b[:, t],
                                       c[:, t], d)
        ys.append(y)
    return torch.stack(ys, dim=1).to(x.dtype)


def selective_scan_bwd_ref(x, dt, a, b, c, d, gy):
    """Plain PyTorch backward of `selective_scan_ref` for the upstream
    gradient gy (B, T, D): the reverse recurrence written out (not
    autograd). With da_t = exp(dt_t a) and G_t = dL/dh_t = gy_t c_t +
    da_{t+1} G_{t+1}, returns (gx, gdt, ga, gb, gc, gd) shaped as the
    inputs."""
    B, T, D = x.shape
    N = a.shape[1]
    zeros = torch.zeros((B, D, N), dtype=x.dtype, device=x.device)
    h, hs = zeros, []
    for t in range(T):
        h, _ = selective_scan_step_ref(h, x[:, t], dt[:, t], a, b[:, t],
                                       c[:, t], d)
        hs.append(h)
    gx, gdt = torch.empty_like(x), torch.empty_like(dt)
    gb, gc = torch.empty_like(b), torch.empty_like(c)
    ga = torch.zeros_like(a)
    carry = zeros                                  # da_{t+1} G_{t+1}
    for t in reversed(range(T)):
        da = torch.exp(dt[:, t, :, None] * a[None])
        h_prev = hs[t - 1] if t else zeros
        bt, ct = b[:, t][:, None, :], c[:, t][:, None, :]
        g = gy[:, t, :, None] * ct + carry
        gx[:, t] = d * gy[:, t] + dt[:, t] * (g * bt).sum(-1)
        gdt[:, t] = (g * (a * da * h_prev + x[:, t, :, None] * bt)).sum(-1)
        ga += (g * dt[:, t, :, None] * da * h_prev).sum(0)
        gb[:, t] = (g * (dt[:, t] * x[:, t])[..., None]).sum(1)
        gc[:, t] = (gy[:, t, :, None] * hs[t]).sum(1)
        carry = da * g
    gd = (gy * x).sum((0, 1))
    return gx, gdt, ga, gb, gc, gd


def launch_selective_scan(x, dt, a, b, c, d, y) -> None:
    """The bare launch on checked GPU tensors into ``y``. No allocation, no
    synchronisation."""
    B, T, D = x.shape
    N = a.shape[1]
    build.launch("selective_scan", x.device, x.data_ptr(), dt.data_ptr(),
                 a.data_ptr(), b.data_ptr(), c.data_ptr(), d.data_ptr(),
                 y.data_ptr(), B, T, D, N)


def launch_selective_scan_bwd(x, dt, a, b, c, d, gy, gx, gdt, ga_part,
                              gb_part, gc_part, gd_part, ckpt) -> None:
    """The backward's bare launch on checked GPU tensors into the outputs,
    the partial sums and the scratch (`_bwd_buffers`). No allocation, no
    synchronisation."""
    B, T, D = x.shape
    N = a.shape[1]
    build.launch("selective_scan_bwd", x.device, *(
        t.data_ptr() for t in (x, dt, a, b, c, d, gy, gx, gdt, ga_part,
                               gb_part, gc_part, gd_part, ckpt)),
        B, T, D, N)


def _bwd_buffers(B, T, D, N, device):
    """The backward kernel's partial sums and scratch, in launch order:
    ga_part (B, D, N) and gd_part (B, D), one row per sequence; gb_part and
    gc_part (ceil(D / BWD_CHANNELS), B, T, N), one row per block of
    channels; ckpt (B, ceil(T / BWD_TILE), D, N), the state entering every
    tile. Returns (ga_part, gb_part, gc_part, gd_part, ckpt)."""
    kw = dict(dtype=torch.float32, device=device)
    blocks = -(-D // BWD_CHANNELS)
    return (torch.empty((B, D, N), **kw),
            torch.empty((blocks, B, T, N), **kw),
            torch.empty((blocks, B, T, N), **kw),
            torch.empty((B, D), **kw),
            torch.empty((B, -(-T // BWD_TILE), D, N), **kw))


def _check_state(shape, a, b, c, d) -> None:
    """a (D, N) with N in STATE_SIZES, b and c (B, T, N), d (D,) for x of
    `shape` (B, T, D); all contiguous float32."""
    B, T, D = shape
    N = a.shape[-1]
    if (a.shape != (D, N) or b.shape != (B, T, N) or c.shape != (B, T, N)
            or d.shape != (D,)):
        raise ValueError("selective_scan: shapes do not fit x "
                         f"{tuple(shape)}, a {tuple(a.shape)}")
    if N not in STATE_SIZES:
        raise ValueError(f"d_state {N} not in {STATE_SIZES}")
    for name, t in (("a", a), ("b", b), ("c", c), ("d", d)):
        check_tensor(t, torch.float32, name)


def _check(x, dt, a, b, c, d, *more) -> None:
    """What the kernels take: shapes that fit x, N in STATE_SIZES,
    contiguous float32."""
    if dt.shape != x.shape or any(t.shape != x.shape for t in more):
        raise ValueError("selective_scan: shapes do not fit x "
                         f"{tuple(x.shape)}")
    _check_state(x.shape, a, b, c, d)
    for name, t in (("x", x), ("dt", dt), *(("gy", t) for t in more)):
        check_tensor(t, torch.float32, name)


def _forward_gpu(x, dt, a, b, c, d):
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    launch_selective_scan(x, dt, a, b, c, d, y)
    count_launch("selective_scan", tuple(x.shape) + (a.shape[1],))
    return y


def selective_scan_bwd(x, dt, a, b, c, d, gy):
    """The gradients (gx, gdt, ga, gb, gc, gd) of ``sum(y * gy)`` for
    y = selective_scan(x, dt, a, b, c, d). On CUDA tensors it launches the
    kernel (float32, contiguous, N in 4/8/16) or raises; the per-block and
    per-sequence partial sums it writes are added here in a fixed order
    (deterministic). On the CPU, `selective_scan_bwd_ref`."""
    if not on_gpu(x, dt, a, b, c, d, gy):
        return selective_scan_bwd_ref(x, dt, a, b, c, d, gy)
    _check(x, dt, a, b, c, d, gy)
    B, T, D = x.shape
    N = a.shape[1]
    gx, gdt = torch.empty_like(x), torch.empty_like(x)
    if x.numel() == 0:
        return (gx, gdt, torch.zeros_like(a), torch.zeros_like(b),
                torch.zeros_like(c), torch.zeros_like(d))
    ga_part, gb_part, gc_part, gd_part, ckpt = _bwd_buffers(B, T, D, N,
                                                            x.device)
    launch_selective_scan_bwd(x, dt, a, b, c, d, gy, gx, gdt, ga_part,
                              gb_part, gc_part, gd_part, ckpt)
    count_launch("selective_scan_bwd", (B, T, D, N))
    return (gx, gdt, ga_part.sum(0), gb_part.sum(0), gc_part.sum(0),
            gd_part.sum(0))


class SelectiveScan(torch.autograd.Function):
    """The kernel's forward with the kernel's backward, for CUDA tensors
    (`selective_scan` sends a CUDA call here when an input needs a
    gradient). Saves only the inputs; the backward recomputes the states."""

    @staticmethod
    def forward(ctx, x, dt, a, b, c, d):
        ctx.save_for_backward(x, dt, a, b, c, d)
        return _forward_gpu(x, dt, a, b, c, d)

    @staticmethod
    def backward(ctx, gy):
        inputs = ctx.saved_tensors
        gy = gy.contiguous()
        if not on_gpu(*inputs, gy):
            raise RuntimeError("SelectiveScan's backward runs on CUDA "
                               "tensors only; on the CPU autograd "
                               "differentiates selective_scan_ref")
        grads = selective_scan_bwd(*inputs, gy)
        return tuple(g if need else None
                     for g, need in zip(grads, ctx.needs_input_grad))


def selective_scan(x, dt, a, b, c, d):
    """x, dt: (B,T,D); a: (D,N); b, c: (B,T,N); d: (D,), float32 ->
    y (B,T,D). On CUDA tensors it launches the kernel (N in 4/8/16) or
    raises, through `SelectiveScan` where autograd records and an input
    needs a gradient."""
    if not on_gpu(x, dt, a, b, c, d):
        return selective_scan_ref(x, dt, a, b, c, d)
    _check(x, dt, a, b, c, d)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dt, a, b, c, d)):
        return SelectiveScan.apply(x, dt, a, b, c, d)
    return _forward_gpu(x, dt, a, b, c, d)


# ---------------------------------------------------------------------------
# The gated entry: dt's bias and softplus before the scan, the silu(z) gate
# after it (the gated instances of both kernels)
# ---------------------------------------------------------------------------

GATED_DTYPES = (torch.bfloat16, torch.float32)


def _silu(t):
    return t * torch.sigmoid(t)


def selective_scan_gated_ref(x, dt_raw, dt_bias, a, b, c, d, z):
    """Mamba's plain chain, each operation in its operands' type: dt =
    softplus(dt_raw + dt_bias), the float32 scan, y rounded to x's type,
    times silu(z). What the CPU runs; autograd differentiates it."""
    f32 = torch.float32
    dt = F.softplus(dt_raw + dt_bias)
    y = selective_scan_ref(*(t.to(f32).contiguous() for t in (x, dt, a, b,
                                                               c, d)))
    return y.to(x.dtype) * _silu(z)


def selective_scan_gated_f32(x, dt_raw, dt_bias, a, b, c, d, z):
    """The gated kernel's arithmetic in plain PyTorch: the chain in float32
    from the operands -> (y, y_pre), the gated output and the scan's output
    before the gate, float32 (the kernel rounds each once to x's type)."""
    xf, rf, bf, af, bm, cm, df, zf = (t.float() for t in (
        x, dt_raw, dt_bias, a, b, c, d, z))
    y_pre = selective_scan_ref(xf, F.softplus(rf + bf), af, bm, cm, df)
    return y_pre * _silu(zf), y_pre


def selective_scan_gated_bwd_ref(x, dt_raw, dt_bias, a, b, c, d, z, y_pre,
                                 g):
    """The gradients (gx, g_raw, gbias, ga, gb, gc, gd, gz) of ``sum(y *
    g)`` for the gated y, written out (not autograd) in float32 from the
    operands: v = dt_raw + dt_bias, dt = softplus(v), gy = g silu(z), the
    scan's gradients (`selective_scan_bwd_ref`), g_raw = gdt sigmoid(v) (gdt
    where v > 20, F.softplus's threshold), gbias = the sum of g_raw, gz = g
    y_pre silu'(z) with y_pre as given (the forward's, rounded to x's
    type). gx, g_raw, gz rounded once to x's type, gbias to the bias's; the
    others float32."""
    xf, rf, bf, zf, yf, gf = (t.float() for t in (x, dt_raw, dt_bias, z,
                                                  y_pre, g))
    v = rf + bf
    s = torch.sigmoid(zf)
    gx, gdt, ga, gb, gc, gd = selective_scan_bwd_ref(
        xf, F.softplus(v), a.float(), b.float(), c.float(), d.float(),
        gf * zf * s)
    g_raw = torch.where(v > 20, gdt, gdt * torch.sigmoid(v))
    gz = gf * yf * s * (1 + zf * (1 - s))
    return (gx.to(x.dtype), g_raw.to(x.dtype),
            g_raw.sum((0, 1)).to(dt_bias.dtype), ga, gb, gc, gd,
            gz.to(x.dtype))


def launch_selective_scan_gated(x, dt_raw, dt_bias, a, b, c, d, z, y,
                                y_pre=None) -> None:
    """The gated forward's bare launch on checked GPU tensors into ``y``
    and, unless None, ``y_pre`` (both (B, T, D) contiguous, x's type). No
    allocation, no synchronisation."""
    B, T, D = x.shape
    build.launch("selective_scan_gated", x.device, x.data_ptr(),
                 dt_raw.data_ptr(), dt_bias.data_ptr(), z.data_ptr(),
                 *z.stride()[:2], a.data_ptr(), b.data_ptr(), c.data_ptr(),
                 d.data_ptr(), y.data_ptr(),
                 0 if y_pre is None else y_pre.data_ptr(), B, T, D,
                 a.shape[1], int(x.dtype == torch.bfloat16))


def launch_selective_scan_gated_bwd(x, dt_raw, dt_bias, a, b, c, d, z,
                                    y_pre, g, gx, g_raw, gz, ga_part,
                                    gb_part, gc_part, gd_part, gbias_part,
                                    ckpt) -> None:
    """The gated backward's bare launch on checked GPU tensors into gx,
    g_raw, gz ((B, T, D) contiguous, x's type), the partial sums and the
    scratch of `_bwd_buffers`, and gbias_part (B, D) float32. No
    allocation, no synchronisation."""
    B, T, D = x.shape
    build.launch("selective_scan_gated_bwd", x.device, x.data_ptr(),
                 dt_raw.data_ptr(), dt_bias.data_ptr(), z.data_ptr(),
                 *z.stride()[:2], y_pre.data_ptr(), *(
                     t.data_ptr() for t in (a, b, c, d, g, gx, g_raw, gz,
                                            ga_part, gb_part, gc_part,
                                            gd_part, gbias_part, ckpt)),
                 B, T, D, a.shape[1], int(x.dtype == torch.bfloat16))


def _check_gated(x, dt_raw, dt_bias, a, b, c, d, z, *more) -> None:
    """What the gated kernels take: x, dt_raw and each of `more` (B, T, D)
    contiguous, dt_bias (D,) contiguous and z (B, T, D) with unit stride
    along D, all bf16 or all float32; a, b, c, d as `_check` takes
    them."""
    if x.dim() != 3:
        raise ValueError(f"selective_scan_gated: x must be (B, T, D), got "
                         f"{tuple(x.shape)}")
    B, T, D = x.shape
    if x.dtype not in GATED_DTYPES:
        raise TypeError(f"selective_scan_gated: x is {x.dtype}; the kernel "
                        "takes bfloat16 or float32")
    if (tuple(dt_bias.shape) != (D,) or z.shape != x.shape
            or any(t.shape != x.shape for t in (dt_raw, *more))):
        raise ValueError("selective_scan_gated: shapes do not fit x "
                         f"{tuple(x.shape)}")
    if D > 1 and z.numel() and z.stride(2) != 1:
        raise ValueError("selective_scan_gated: z must have unit stride "
                         f"along D, got strides {z.stride()}")
    if z.dtype != x.dtype:
        raise TypeError(f"z: expected {x.dtype}, got {z.dtype}")
    _check_state(x.shape, a, b, c, d)
    for name, t in (("x", x), ("dt_raw", dt_raw), ("dt_bias", dt_bias),
                    *zip(("y_pre", "g"), more)):
        check_tensor(t, x.dtype, name)


def _gated_forward_gpu(x, dt_raw, dt_bias, a, b, c, d, z, keep_pre):
    """-> (y, y_pre or None): one launch, counted as ``selective_scan``
    with the shape (B, T, D, N), and as a ``mamba.gated_scan``."""
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    y_pre = torch.empty_like(y) if keep_pre else None
    if x.numel() == 0:
        return y, y_pre
    launch_selective_scan_gated(x, dt_raw, dt_bias, a, b, c, d, z, y, y_pre)
    count_launch("selective_scan", tuple(x.shape) + (a.shape[1],))
    tracing.count("mamba.gated_scan", 1)
    return y, y_pre


def selective_scan_gated_bwd(x, dt_raw, dt_bias, a, b, c, d, z, y_pre, g):
    """The gradients (gx, g_raw, gbias, ga, gb, gc, gd, gz) of ``sum(y *
    g)`` for y = selective_scan_gated(x, dt_raw, dt_bias, a, b, c, d, z),
    y_pre the forward's output before the gate. On CUDA tensors it
    launches the gated backward kernel (as `selective_scan_gated` checks
    its operands; y_pre and g contiguous of x's type), counted as
    ``selective_scan_bwd`` with the shape (B, T, D, N); the partial sums
    are added here in a fixed order (deterministic), gbias rounded once to
    the bias's type. On the CPU, `selective_scan_gated_bwd_ref`."""
    if not on_gpu(x, dt_raw, dt_bias, a, b, c, d, z, y_pre, g):
        return selective_scan_gated_bwd_ref(x, dt_raw, dt_bias, a, b, c, d,
                                            z, y_pre, g)
    _check_gated(x, dt_raw, dt_bias, a, b, c, d, z, y_pre, g)
    B, T, D = x.shape
    N = a.shape[1]
    gx, g_raw, gz = (torch.empty(x.shape, dtype=x.dtype, device=x.device)
                     for _ in range(3))
    if x.numel() == 0:
        return (gx, g_raw, torch.zeros_like(dt_bias), torch.zeros_like(a),
                torch.zeros_like(b), torch.zeros_like(c),
                torch.zeros_like(d), gz)
    ga_part, gb_part, gc_part, gd_part, ckpt = _bwd_buffers(B, T, D, N,
                                                            x.device)
    gbias_part = torch.empty((B, D), dtype=torch.float32, device=x.device)
    launch_selective_scan_gated_bwd(x, dt_raw, dt_bias, a, b, c, d, z, y_pre,
                                    g, gx, g_raw, gz, ga_part, gb_part,
                                    gc_part, gd_part, gbias_part, ckpt)
    count_launch("selective_scan_bwd", (B, T, D, N))
    return (gx, g_raw, gbias_part.sum(0).to(dt_bias.dtype), ga_part.sum(0),
            gb_part.sum(0), gc_part.sum(0), gd_part.sum(0), gz)


class SelectiveScanGated(torch.autograd.Function):
    """The gated kernels forward and backward, for CUDA tensors
    (`selective_scan_gated` sends a CUDA call here when an input needs a
    gradient). Saves the inputs and y_pre, the forward's output before the
    gate; the backward recomputes the states."""

    @staticmethod
    def forward(ctx, x, dt_raw, dt_bias, a, b, c, d, z):
        y, y_pre = _gated_forward_gpu(x, dt_raw, dt_bias, a, b, c, d, z,
                                      True)
        ctx.save_for_backward(x, dt_raw, dt_bias, a, b, c, d, z, y_pre)
        return y

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        g = g.contiguous()
        if not on_gpu(*saved, g):
            raise RuntimeError("SelectiveScanGated's backward runs on CUDA "
                               "tensors only; on the CPU autograd "
                               "differentiates selective_scan_gated_ref")
        gx, g_raw, gbias, ga, gb, gc, gd, gz = selective_scan_gated_bwd(
            *saved, g)
        grads = (gx, g_raw, gbias, ga, gb, gc, gd, gz)
        return tuple(t if need else None
                     for t, need in zip(grads, ctx.needs_input_grad))


def selective_scan_gated(x, dt_raw, dt_bias, a, b, c, d, z):
    """Mamba's scan with its neighbours: x, dt_raw (B, T, D) (dt's
    projection without its bias), dt_bias (D,), z (B, T, D) with unit
    stride along D (the in-projection's second half, a strided view),
    bf16 or float32 alike; a (D, N); b, c (B, T, N); d (D,) ->
    scan(x, softplus(dt_raw + dt_bias), a, b, c, d) * silu(z), (B, T, D)
    of x's type. On CUDA tensors the gated kernel (a, b, c, d as float32
    copies where they are not), through `SelectiveScanGated` where autograd
    records and an input needs a gradient; on the CPU the plain chain
    `selective_scan_gated_ref`."""
    if not on_gpu(x, dt_raw, dt_bias, a, b, c, d, z):
        return selective_scan_gated_ref(x, dt_raw, dt_bias, a, b, c, d, z)
    a, b, c, d = (t.to(torch.float32).contiguous() for t in (a, b, c, d))
    _check_gated(x, dt_raw, dt_bias, a, b, c, d, z)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dt_raw, dt_bias, a, b, c, d, z)):
        return SelectiveScanGated.apply(x, dt_raw, dt_bias, a, b, c, d, z)
    return _gated_forward_gpu(x, dt_raw, dt_bias, a, b, c, d, z, False)[0]
