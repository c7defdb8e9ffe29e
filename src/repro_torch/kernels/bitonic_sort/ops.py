"""Public wrappers for the sort unit and the fused ship-batch pipeline
(``csrc/bitonic.cu``): `sort_rows` / `sort_1024`, and
`apply_pipeline_batch` (sort the update values, merge them with the old
dictionary), with their plain PyTorch versions.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import (I32_MAX, check_tensor, count_launch,
                                        next_pow2, on_gpu)

# values one thread block sorts in shared memory (128 KB of int32)
MAX_TILE = 32768


def sort_rows_ref(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of `sort_rows`."""
    return torch.sort(x, dim=1).values


def _merge_rows_launch(lib, a_ptr, a_stride, wa, b_ptr, b_stride, wb, out,
                       out_stride, w_out, rows, stream) -> None:
    code = lib.bitonic_merge_rows(a_ptr, a_stride, wa, b_ptr, b_stride, wb,
                                  out.data_ptr(), out_stride, w_out, rows,
                                  stream)
    build.check(code, "bitonic_merge_rows")


def launch_sort_tiles(x, buf, tile: int) -> None:
    """The bare launch of the tile sort on checked GPU tensors: every
    `tile`-wide slice of each row of x (rows, width) sorted into buf (rows,
    width_pad). No allocation, no synchronisation."""
    lib = build.load_library()
    with torch.cuda.device(x.device):
        code = lib.bitonic_sort_tiles(x.data_ptr(), buf.data_ptr(),
                                      x.shape[0], x.shape[1], tile,
                                      buf.shape[1],
                                      torch.cuda.current_stream().cuda_stream)
    build.check(code, "bitonic_sort_tiles")


def launch_bitonic_apply(old_rows, val_rows, svals, merged) -> None:
    """The bare launch of the fused sort + merge on checked GPU tensors
    with preallocated outputs. No allocation, no synchronisation."""
    lib = build.load_library()
    with torch.cuda.device(old_rows.device):
        code = lib.bitonic_apply(old_rows.data_ptr(), old_rows.shape[1],
                                 val_rows.data_ptr(), val_rows.shape[1],
                                 svals.data_ptr(), merged.data_ptr(),
                                 merged.shape[1], old_rows.shape[0],
                                 torch.cuda.current_stream().cuda_stream)
    build.check(code, "bitonic_apply")


def _sort_rows_gpu(x: torch.Tensor) -> torch.Tensor:
    """Tile sort in shared memory, then pairwise merges of the sorted tiles
    for rows wider than one tile. Returns (rows, next_pow2(width)) with
    int32.max in the padded tail."""
    rows, width = x.shape
    width_pad = next_pow2(max(width, 1))
    tile = min(width_pad, MAX_TILE)
    buf = torch.empty((rows, width_pad), dtype=torch.int32, device=x.device)
    launch_sort_tiles(x, buf, tile)
    lib = build.load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        run = tile
        while run < width_pad:
            # every adjacent pair of sorted runs of `run` values -> 2 * run
            nxt = torch.empty_like(buf)
            pairs = width_pad // (2 * run)
            _merge_rows_launch(lib, buf.data_ptr(), 2 * run, run,
                               buf.data_ptr() + 4 * run, 2 * run, run, nxt,
                               2 * run, 2 * run, rows * pairs, stream)
            buf, run = nxt, 2 * run
    return buf


def sort_rows(x: torch.Tensor) -> torch.Tensor:
    """Sort each row of a (rows, width) int32 tensor ascending."""
    if not on_gpu(x):
        return sort_rows_ref(x)
    check_tensor(x, torch.int32, "x", 2)
    rows, width = x.shape
    if rows == 0 or width == 0:
        return x.clone()
    if rows > 65535:
        raise ValueError("sort_rows takes at most 65535 rows per call")
    out = _sort_rows_gpu(x)
    count_launch("bitonic_sort", (rows, width))
    return out[:, :width]


def sort_1024(values: torch.Tensor) -> torch.Tensor:
    """The paper's sort-unit entry point: sort <= 1024 values (§5.2)."""
    assert values.shape[0] <= 1024, "sort unit is sized for 1024 values"
    return sort_rows(values[None, :])[0]


def apply_pipeline_batch_ref(old_rows, val_rows):
    """Plain PyTorch version of `apply_pipeline_batch`."""
    rows, w_old = old_rows.shape
    w_val = val_rows.shape[1]
    w_merge = next_pow2(w_old + w_val)
    svals = torch.sort(val_rows, dim=1).values
    gap = torch.full((rows, w_merge - w_old - w_val), I32_MAX,
                     dtype=old_rows.dtype, device=old_rows.device)
    merged = torch.sort(torch.cat([old_rows, gap, svals], dim=1),
                        dim=1).values
    return svals, merged


def apply_pipeline_batch(old_rows, val_rows):
    """Fused ship-batch dictionary pipeline: ONE launch for a whole batch.

    old_rows: (rows, w_old) int32 - each row one column's OLD dictionary,
    sorted ascending, int32.max sentinel pad. val_rows: (rows, w_val) raw
    update values, sentinel pad, w_val a power of two (callers use
    `common.width_bucket`). Per row: sort the values, then merge them with
    the old dictionary. Returns (sorted_vals (rows, w_val), merged (rows,
    next_pow2(w_old + w_val))) on the inputs' device; sentinels sort to the
    tails, callers slice real entries by length. Sentinel-valued REAL
    entries are the caller's problem: columns whose values reach int32.max
    must take the compositional path.
    """
    if not on_gpu(old_rows, val_rows):
        return apply_pipeline_batch_ref(old_rows, val_rows)
    check_tensor(old_rows, torch.int32, "old_rows", 2)
    check_tensor(val_rows, torch.int32, "val_rows", 2)
    rows, w_old = old_rows.shape
    w_val = val_rows.shape[1]
    if val_rows.shape[0] != rows:
        raise ValueError("old_rows and val_rows must have one row count")
    if w_val != next_pow2(w_val):
        raise ValueError(f"w_val must be a power of two, got {w_val}")
    w_merge = next_pow2(w_old + w_val)
    merged = torch.empty((rows, w_merge), dtype=torch.int32,
                         device=old_rows.device)
    if rows == 0:
        return val_rows.clone(), merged
    if w_val <= MAX_TILE:
        svals = torch.empty_like(val_rows)
        launch_bitonic_apply(old_rows, val_rows, svals, merged)
    else:
        # more update values than one block's shared memory sorts: the
        # tiled sort, then the same merge against global memory
        svals = _sort_rows_gpu(val_rows)
        lib = build.load_library()
        with torch.cuda.device(old_rows.device):
            stream = torch.cuda.current_stream().cuda_stream
            _merge_rows_launch(lib, old_rows.data_ptr(), w_old, w_old,
                               svals.data_ptr(), w_val, w_val, merged,
                               w_merge, w_merge, rows, stream)
    count_launch("bitonic_apply", (rows, w_old, w_val))
    return svals, merged
