"""The float32 scan's error bound (K18, ``csrc/scan_float.cu``).

The card holds the kernel's sum to ``float_scan_error_bound`` of the exact
int64 sum. Here, on the CPU, that bound is held against a numpy float32
model of the kernel's own summation order (a thread's grid-stride sum,
the warp-shuffle and per-warp trees of each block, the one-block final
pass): the model stays inside it on data chosen to round badly, and
models of wrong kernels (a bf16 accumulator, a dropped block partial,
partials lost in the final pass) fall outside it, so the bound can fail a
wrong kernel.
"""

import numpy as np
import pytest

from repro_torch.kernels.dict_ops.ops import (FLOAT_SCAN_THREADS,
                                              float_scan_error_bound)

T = FLOAT_SCAN_THREADS


def f32(x):
    return np.asarray(x, dtype=np.float32)


def bf16(x):
    """float32 -> the nearest bfloat16 (ties to even), kept as float32."""
    b = f32(x).view(np.uint32).astype(np.uint64)
    b = (b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000
    return b.astype(np.uint32).view(np.float32)


def block_sum(x):
    """(R, 256) -> (R,): each warp's shuffle-down tree, then warp 0's tree
    over the 8 warp sums padded to 32 lanes, as ``block_sum`` in
    scan_float.cu (lane 0's value)."""
    w = x.reshape(x.shape[0], T // 32, 32)
    for o in (16, 8, 4, 2, 1):
        w = f32(w[..., :o] + w[..., o:2 * o])
    lanes = np.zeros((x.shape[0], 32), np.float32)
    lanes[:, :T // 32] = w[..., 0]
    for o in (16, 8, 4, 2, 1):
        lanes = f32(lanes[:, :o] + lanes[:, o:2 * o])
    return lanes[:, 0]


def kernel_order_sum(vals, parts, *, acc=f32, drop_block=None,
                     final_parts=None):
    """The two passes of scan_float.cu over the selected values (others are
    0) in float32; the keywords model wrong kernels."""
    n = vals.shape[0]
    per_thread = -(-n // (parts * T))
    x = np.zeros(per_thread * parts * T, np.float32)
    x[:n] = vals
    s = np.zeros((parts, T), np.float32)
    for row in x.reshape(per_thread, parts, T):
        s = acc(s + row)
    psum = block_sum(s)
    if drop_block is not None:
        psum[drop_block] = 0.0
    if final_parts is not None:
        psum = psum[:final_parts]
    p = np.zeros(-(-psum.shape[0] // T) * T, np.float32)
    p[:psum.shape[0]] = psum
    t = np.zeros(T, np.float32)
    for row in p.reshape(-1, T):
        t = f32(t + row)
    return float(block_sum(t[None])[0])


def selected_values(n, seed, *, signed=True):
    """int32 dictionary values of the selected rows (0 elsewhere), with a
    wide spread of magnitudes so that float32 rounds at every step."""
    rng = np.random.default_rng(seed)
    mag = rng.integers(1, 2**31 - 1, n) >> rng.integers(0, 24, n)
    sign = rng.choice((-1, 1), n) if signed else 1
    keep = rng.random(n) < 0.3
    return np.where(keep, mag * sign, 0).astype(np.int64)


# (n, parts): one row; a ragged single block; a few blocks each summing
# many rows; the main path's 10M rows over 4 blocks a SM of an H100 (132
# SMs), where the final pass also sums several partials a thread.
SHAPES = [(1, 1), (255, 1), (100_003, 4), (10_000_000, 528)]


@pytest.mark.parametrize("n,parts", SHAPES)
def test_kernel_summation_order_stays_inside_the_bound(n, parts):
    v = selected_values(n, n)
    exact, abs_sum = int(v.sum()), int(np.abs(v).sum())
    got = kernel_order_sum(f32(v), parts)
    assert abs(got - exact) <= float_scan_error_bound(n, parts, abs_sum)


def test_bound_at_the_main_path_size_is_a_few_ulps_of_the_magnitude():
    # 10M rows, 528 blocks: 74 rows a thread, 3 partials a final thread,
    # 16 tree levels, one conversion: 94 roundings of 2**-24.
    rel = float_scan_error_bound(10_000_000, 528, 1.0)
    assert 94 * 2.0**-24 < rel < 95 * 2.0**-24


@pytest.mark.parametrize("wrong", ["bf16 accumulator", "drop a block",
                                   "final pass reads 256 partials"])
def test_wrong_kernels_fall_outside_the_bound(wrong):
    n, parts = 10_000_000, 528
    v = selected_values(n, 1, signed=False)
    exact, abs_sum = int(v.sum()), int(np.abs(v).sum())
    kw = {"bf16 accumulator": dict(acc=bf16),
          "drop a block": dict(drop_block=parts // 2),
          "final pass reads 256 partials": dict(final_parts=256)}[wrong]
    got = kernel_order_sum(f32(v), parts, **kw)
    assert abs(got - exact) > float_scan_error_bound(n, parts, abs_sum)
