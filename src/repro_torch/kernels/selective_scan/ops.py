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
"""

from __future__ import annotations

import torch

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


def _check(x, dt, a, b, c, d, *more) -> None:
    """What the kernels take: shapes that fit x, N in STATE_SIZES,
    contiguous float32."""
    B, T, D = x.shape
    N = a.shape[1]
    if (dt.shape != x.shape or a.shape != (D, N) or b.shape != (B, T, N)
            or c.shape != (B, T, N) or d.shape != (D,)
            or any(t.shape != x.shape for t in more)):
        raise ValueError("selective_scan: shapes do not fit x "
                         f"{tuple(x.shape)}, a {tuple(a.shape)}")
    if N not in STATE_SIZES:
        raise ValueError(f"d_state {N} not in {STATE_SIZES}")
    for name, t in (("x", x), ("dt", dt), ("a", a), ("b", b), ("c", c),
                    ("d", d), *(("gy", t) for t in more)):
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
