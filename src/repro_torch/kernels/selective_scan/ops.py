"""Selective scan (``csrc/selective_scan.cu``) and its plain versions.

Mamba-1's recurrence over a prompt: x, dt (B, T, D), a (D, N), b, c
(B, T, N), d (D,), all float32, -> y (B, T, D). The reference's wrapper
falls back to its jnp oracle when D or T is not a multiple of its blocks;
the kernel here takes any T and D. It splits each channel's N states
across two lanes of a warp (``csrc/selective_scan.cu``). One decode step
(``selective_scan_step_ref``) stays plain PyTorch on every device, as in
the reference.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import check_tensor, count_launch, on_gpu

STATE_SIZES = (4, 8, 16)


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
    h = torch.zeros((B, D, N), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(T):
        h, y = selective_scan_step_ref(h, x[:, t], dt[:, t], a, b[:, t],
                                       c[:, t], d)
        ys.append(y)
    return torch.stack(ys, dim=1).to(x.dtype)


def launch_selective_scan(x, dt, a, b, c, d, y) -> None:
    """The bare launch on checked GPU tensors into ``y``. No allocation, no
    synchronisation."""
    B, T, D = x.shape
    N = a.shape[1]
    build.launch("selective_scan", x.device, x.data_ptr(), dt.data_ptr(),
                 a.data_ptr(), b.data_ptr(), c.data_ptr(), d.data_ptr(),
                 y.data_ptr(), B, T, D, N)


def selective_scan(x, dt, a, b, c, d):
    """x, dt: (B,T,D); a: (D,N); b, c: (B,T,N); d: (D,), float32 ->
    y (B,T,D). On CUDA tensors it launches the kernel (N in 4/8/16) or
    raises."""
    B, T, D = x.shape
    N = a.shape[1]
    if not on_gpu(x, dt, a, b, c, d):
        return selective_scan_ref(x, dt, a, b, c, d)
    if (dt.shape != x.shape or a.shape != (D, N) or b.shape != (B, T, N)
            or c.shape != (B, T, N) or d.shape != (D,)):
        raise ValueError("selective_scan: shapes do not fit x "
                         f"{tuple(x.shape)}, a {tuple(a.shape)}")
    if N not in STATE_SIZES:
        raise ValueError(f"d_state {N} not in {STATE_SIZES}")
    for name, t in (("x", x), ("dt", dt), ("a", a), ("b", b), ("c", c),
                    ("d", d)):
        check_tensor(t, torch.float32, name)
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    launch_selective_scan(x, dt, a, b, c, d, y)
    count_launch("selective_scan", (B, T, D, N))
    return y
