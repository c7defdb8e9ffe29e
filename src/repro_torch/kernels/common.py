"""Shared kernel utilities: shape buckets, launch counters, device rule.

There is one execution rule and no mode switch: a wrapper launches its CUDA
kernel when its tensors lie on the GPU and takes the plain PyTorch version
when they lie on the CPU. Each wrapper bumps its launch counter exactly
where it launches its kernel, with the shape it launched at, so a run can
show that it went through the kernels (``kernel_launch_counts``) and at
which sizes (``kernel_launch_shapes``).
"""

from __future__ import annotations

import numpy as np
import torch

I32_MAX = 2**31 - 1
I64_MAX = 2**63 - 1


def next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def width_bucket(n: int, floor: int = 8) -> int:
    """Pow2 shape bucket with a small floor for tiny widths."""
    return max(floor, next_pow2(max(int(n), 1)))


# ---------------------------------------------------------------------------
# Launch accounting
# ---------------------------------------------------------------------------

_launch_counts: dict[str, int] = {}
_launch_shapes: dict[str, dict[tuple, int]] = {}


def count_launch(name: str, shape: tuple) -> None:
    """Called by a wrapper right where it launches its CUDA kernel; `shape`
    is the tuple of sizes the launch was given (each wrapper documents its
    own)."""
    _launch_counts[name] = _launch_counts.get(name, 0) + 1
    seen = _launch_shapes.setdefault(name, {})
    shape = tuple(int(s) for s in shape)
    seen[shape] = seen.get(shape, 0) + 1


def kernel_launch_counts() -> dict[str, int]:
    """Per-kernel launch counts since the last reset (a copy)."""
    return dict(_launch_counts)


def kernel_launch_shapes() -> dict[str, dict[tuple, int]]:
    """Per kernel, how many launches each shape got since the last reset
    (a copy)."""
    return {name: dict(seen) for name, seen in _launch_shapes.items()}


def reset_kernel_launch_counts() -> None:
    _launch_counts.clear()
    _launch_shapes.clear()


# ---------------------------------------------------------------------------
# Device rule
# ---------------------------------------------------------------------------

def resolve_device(device=None) -> torch.device:
    """``None`` means the GPU; it never silently becomes the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available and no device was given; pass "
                "device='cpu' explicitly to run the plain PyTorch versions")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested but CUDA is "
                               "not available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


_sm_counts: dict[int, int] = {}


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device (asked once)."""
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _sm_counts:
        _sm_counts[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _sm_counts[idx]


def from_host(values, dtype=None) -> torch.Tensor:
    """Host numpy (any strides - a field of a packed record array has an
    odd one, which `torch.from_numpy` refuses) -> a CPU tensor. Copies, so
    it is for the small arrays of a ship batch, not for whole columns."""
    return torch.from_numpy(np.array(values, dtype=dtype, order="C",
                                     copy=True))


def on_gpu(*tensors: torch.Tensor) -> bool:
    """True when the tensors lie on one GPU, False when all lie on the CPU;
    a mix is an error (a wrapper never moves data by itself)."""
    kinds = {t.device for t in tensors}
    if len(kinds) != 1:
        raise ValueError(f"tensors lie on different devices: {sorted(map(str, kinds))}")
    return next(iter(kinds)).type == "cuda"


def check_tensor(t: torch.Tensor, dtype: torch.dtype, name: str,
                 ndim: int | None = None) -> None:
    """What every CUDA entry requires of an argument."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if ndim is not None and t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def as_u8(mask: torch.Tensor) -> torch.Tensor:
    """A 1-byte mask as uint8 without a copy (bool and uint8 share storage
    layout; the kernels read any non-zero byte as true)."""
    if mask.dtype == torch.bool:
        return mask.view(torch.uint8)
    if mask.dtype == torch.uint8:
        return mask
    raise TypeError(f"mask must be bool or uint8, got {mask.dtype}")
