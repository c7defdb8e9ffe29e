"""Mamba-1's causal depthwise conv with its bias and SiLU
(``csrc/causal_conv.cu``) and its plain versions.

x (B, T, D) -> silu(b + sum_k w[k] * x[t - K + 1 + k]), zero before the
sequence's start, for w (K, D) and b (D,) of x's type. x may be a strided
view with unit stride along D (the in-projection's first half). On CUDA
tensors the kernel computes in float32 from the operands and rounds once;
its backward is a kernel too (`CausalConvSiLU`). On the CPU the plain
chain `causal_conv_silu_ref`, which autograd differentiates.
"""

from __future__ import annotations

import torch
from torch.nn import functional as F

from repro_torch.kernels import build
from repro_torch.kernels.common import check_tensor, count_launch, on_gpu

TAPS = (4,)                        # the kernel's instances of K
DTYPES = (torch.bfloat16, torch.float32)
# csrc/causal_conv.cu's TILE (time steps a block) and CH (channels a
# block): the backward's partial sums have a row a tile, D rounded up to CH
TILE = 64
CHANNELS = 256
MAX_GRID = 65535                   # B and ceil(T / TILE)


def causal_conv_silu_ref(x, w, b):
    """Plain PyTorch version: left-pad K - 1 steps, the K shifted products
    summed, the bias, then x * sigmoid(x), each in x's type."""
    K, T = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    y = sum(xp[:, i:i + T, :] * w[i][None, None, :] for i in range(K))
    y = y + b[None, None, :]
    return y * torch.sigmoid(y)


def causal_conv_silu_bwd_ref(x, w, b, gy):
    """The gradients (dx, dw, db) of ``sum(y * gy)`` for y =
    causal_conv_silu(x, w, b), written out (not autograd) in float32 from
    the operands, each rounded once to its input's type: with gp = gy *
    silu'(pre), dx[t] = sum_k w[k] gp[t + K - 1 - k], dw[k] = sum gp[t]
    x[t - K + 1 + k], db = sum gp."""
    K, T = w.shape[0], x.shape[1]
    xf, wf, bf, gf = (t.float() for t in (x, w, b, gy))
    xp = F.pad(xf, (0, 0, K - 1, 0))
    pre = bf + sum(xp[:, k:k + T] * wf[k] for k in range(K))
    s = torch.sigmoid(pre)
    gp = gf * s * (1 + pre * (1 - s))
    gpp = F.pad(gp, (0, 0, 0, K - 1))
    dx = sum(gpp[:, K - 1 - k:K - 1 - k + T] * wf[k] for k in range(K))
    dw = torch.stack([(gp * xp[:, k:k + T]).sum((0, 1)) for k in range(K)])
    return dx.to(x.dtype), dw.to(w.dtype), gp.sum((0, 1)).to(b.dtype)


def launch_causal_conv(x, w, b, y) -> None:
    """The bare launch on checked GPU tensors into ``y`` (B, T, D),
    contiguous. No allocation, no synchronisation."""
    B, T, D = x.shape
    build.launch("causal_conv_fwd", x.device, x.data_ptr(), *x.stride()[:2],
                 w.data_ptr(), b.data_ptr(), y.data_ptr(), B, T, D,
                 w.shape[0], int(x.dtype == torch.bfloat16))


def launch_causal_conv_bwd(x, w, b, gy, dx, part, dw, db) -> None:
    """The backward's two bare launches on checked GPU tensors: dx (B, T,
    D) contiguous, the tiles' partial sums into ``part`` (`_bwd_partials`),
    their sum into dw and db. No allocation, no synchronisation."""
    B, T, D = x.shape
    build.launch("causal_conv_bwd", x.device, x.data_ptr(), *x.stride()[:2],
                 w.data_ptr(), b.data_ptr(), gy.data_ptr(), dx.data_ptr(),
                 part.data_ptr(), dw.data_ptr(), db.data_ptr(), B, T, D,
                 w.shape[0], int(x.dtype == torch.bfloat16))


def _bwd_partials(B, T, D, K, device):
    """The backward's float32 partial sums: a row a tile of TILE steps of
    a sequence, each dw[0 .. K) and db over D rounded up to CHANNELS."""
    return torch.empty((B * -(-T // TILE), K + 1, -(-D // CHANNELS)
                        * CHANNELS), dtype=torch.float32, device=device)


def _check(x, w, b, gy=None) -> None:
    """What the kernels take: x (B, T, D) of bf16 or float32 with unit
    stride along D, w (K, D) with K in TAPS and b (D,) contiguous of x's
    type, gy contiguous of x's shape and type, within the grid's limits."""
    if x.dim() != 3:
        raise ValueError(f"causal_conv: x must be (B, T, D), got "
                         f"{tuple(x.shape)}")
    B, T, D = x.shape
    if w.dim() != 2 or w.shape[1] != D or tuple(b.shape) != (D,):
        raise ValueError(f"causal_conv: w {tuple(w.shape)} and b "
                         f"{tuple(b.shape)} do not fit x {tuple(x.shape)}")
    if w.shape[0] not in TAPS:
        raise ValueError(f"causal_conv: d_conv {w.shape[0]}; the kernel is "
                         f"built for {TAPS}")
    if x.dtype not in DTYPES:
        raise TypeError(f"causal_conv: x is {x.dtype}; the kernel takes "
                        "bfloat16 or float32")
    if D > 1 and x.numel() and x.stride(2) != 1:
        raise ValueError("causal_conv: x must have unit stride along D, got "
                         f"strides {x.stride()}")
    if B > MAX_GRID or -(-T // TILE) > MAX_GRID:
        raise ValueError(f"causal_conv: x {tuple(x.shape)} exceeds the "
                         "kernel's grid")
    check_tensor(w, x.dtype, "w", 2)
    check_tensor(b, x.dtype, "b", 1)
    if gy is not None:
        check_tensor(gy, x.dtype, "gy", 3)
        if gy.shape != x.shape:
            raise ValueError(f"causal_conv: gy {tuple(gy.shape)} is not x's "
                             f"shape {tuple(x.shape)}")


def _forward_gpu(x, w, b):
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if x.numel() == 0:
        return y
    launch_causal_conv(x, w, b, y)
    count_launch("causal_conv", tuple(x.shape) + (w.shape[0],))
    return y


def causal_conv_silu_bwd(x, w, b, gy):
    """The gradients (dx, dw, db) of ``sum(y * gy)`` for y =
    causal_conv_silu(x, w, b). On CUDA tensors the kernel's two launches
    (checked as `causal_conv_silu`; gy contiguous), counted once as
    ``causal_conv_bwd`` with the shape (B, T, D, K); on the CPU,
    `causal_conv_silu_bwd_ref`."""
    if not on_gpu(x, w, b, gy):
        return causal_conv_silu_bwd_ref(x, w, b, gy)
    _check(x, w, b, gy)
    B, T, D = x.shape
    K = w.shape[0]
    dx = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if x.numel() == 0:
        return dx, torch.zeros_like(w), torch.zeros_like(b)
    dw, db = torch.empty_like(w), torch.empty_like(b)
    launch_causal_conv_bwd(x, w, b, gy, dx,
                           _bwd_partials(B, T, D, K, x.device), dw, db)
    count_launch("causal_conv_bwd", (B, T, D, K))
    return dx, dw, db


class CausalConvSiLU(torch.autograd.Function):
    """The kernel's forward with the kernel's backward, for CUDA tensors
    (`causal_conv_silu` sends a CUDA call here when an input needs a
    gradient). Saves only the inputs; the backward recomputes the
    pre-activation."""

    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w, b)
        return _forward_gpu(x, w, b)

    @staticmethod
    def backward(ctx, gy):
        grads = causal_conv_silu_bwd(*ctx.saved_tensors, gy.contiguous())
        return tuple(g if need else None
                     for g, need in zip(grads, ctx.needs_input_grad))


def causal_conv_silu(x, w, b):
    """x: (B, T, D), unit stride along D; w: (K, D); b: (D,), of x's type
    -> silu(causal depthwise conv(x) + b), (B, T, D) contiguous. On CUDA
    tensors it launches the kernel (bf16 or float32, K in TAPS) or raises,
    counted as ``causal_conv`` with the shape (B, T, D, K), through
    `CausalConvSiLU` where autograd records and an input needs a gradient;
    on the CPU `causal_conv_silu_ref`."""
    if not on_gpu(x, w, b):
        return causal_conv_silu_ref(x, w, b)
    _check(x, w, b)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, w, b)):
        return CausalConvSiLU.apply(x, w, b)
    return _forward_gpu(x, w, b)
