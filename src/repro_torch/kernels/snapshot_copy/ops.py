"""Public wrapper for the copy unit (``csrc/snapshot_copy.cu``)."""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import (as_u8, check_tensor, count_launch,
                                        on_gpu)


def snapshot_copy_ref(src, prev, dirty, block: int = 8192) -> torch.Tensor:
    """Plain PyTorch version: element-wise select on the chunk flags."""
    n = src.shape[0]
    mask = torch.repeat_interleave(dirty != 0, block)[:n]
    return torch.where(mask, src, prev)


def launch_snapshot_copy(src, prev, flags_u8, out, block: int = 8192) -> None:
    """The bare launch on checked GPU tensors: `flags_u8` one byte per
    chunk, `out` preallocated. No allocation, no synchronisation."""
    build.launch("snapshot_copy", src.device, src.data_ptr(), prev.data_ptr(),
                 flags_u8.data_ptr(), out.data_ptr(), src.shape[0], int(block))


def snapshot_copy(src, prev, dirty, block: int = 8192) -> torch.Tensor:
    """Copy dirty chunks from `src`, carry clean chunks from `prev`.

    src, prev: (n,) int32 on one device; dirty: (ceil(n / block),) flags
    (bool, uint8 or int32, non-zero = dirty). Returns a new (n,) tensor.
    """
    (n,) = src.shape
    n_chunks = (n + block - 1) // block
    if prev.shape != src.shape:
        raise ValueError("src and prev must have one shape")
    if dirty.shape[0] != n_chunks:
        raise ValueError(f"dirty has {dirty.shape[0]} flags for {n_chunks} "
                         f"chunks of {block} rows")
    if not on_gpu(src, prev, dirty):
        return snapshot_copy_ref(src, prev, dirty, block)
    check_tensor(src, torch.int32, "src", 1)
    check_tensor(prev, torch.int32, "prev", 1)
    flags = (dirty if dirty.dtype in (torch.bool, torch.uint8)
             else dirty != 0)
    flags = as_u8(flags.contiguous())
    out = torch.empty_like(src)
    if n == 0:
        return out
    launch_snapshot_copy(src, prev, flags, out, block)
    count_launch("snapshot_copy", (n, block))
    return out
