"""The float32 scan's error bound (K18, ``csrc/scan_float.cu``).

The card holds the kernel's sum to ``float_scan_error_bound`` of the exact
int64 sum. Here, on the CPU, that bound is held against a numpy float32
model of the kernel's own summation order (a view's head rows, then each
thread's groups of four rows summed as (r0 + r1) + (r2 + r3) and added in
grid-stride order, its tail row; the warp-shuffle and per-warp trees of
each block; the last block's pass over the partials in index order): the
model stays inside it on data chosen to round badly, and models of wrong
kernels (a bf16 accumulator, a dropped block partial, partials lost in the
last block's pass) fall outside it, so the bound can fail a wrong kernel.
"""

import pathlib
import re

import numpy as np
import pytest

from repro_torch.kernels.dict_ops import ops as dict_ops
from repro_torch.kernels.dict_ops.ops import (FLOAT_SCAN_GROUP,
                                              FLOAT_SCAN_THREADS,
                                              float_scan_error_bound)

T = FLOAT_SCAN_THREADS
G = FLOAT_SCAN_GROUP
SOURCE = (pathlib.Path(dict_ops.__file__).resolve().parents[1] / "csrc"
          / "scan_float.cu")


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


def thread_sums(vals, parts, head, acc=f32):
    """Each of the grid's parts * 256 threads' sum, in the kernel's order:
    thread i adds head row i (i < head), then groups i, i + T, i + 2T, ...
    of the rows after the head (four rows each, (r0 + r1) + (r2 + r3)),
    then tail row i; `acc` rounds the thread's sum after each add."""
    n = vals.shape[0]
    nt = parts * T
    head = min(head, n)
    n4 = (n - head) // G
    s = np.zeros(nt, np.float32)
    s[:head] = acc(s[:head] + vals[:head])
    rows = vals[head:head + G * n4].reshape(n4, G)
    groups = f32(f32(rows[:, 0] + rows[:, 1]) + f32(rows[:, 2] + rows[:, 3]))
    steps = -(-n4 // nt)
    padded = np.zeros(steps * nt, np.float32)
    padded[:n4] = groups
    for row in padded.reshape(steps, nt):
        s = acc(s + row)
    tail = vals[head + G * n4:]
    s[:tail.shape[0]] = acc(s[:tail.shape[0]] + tail)
    return s


def kernel_order_sum(vals, parts, *, head=0, acc=f32, drop_block=None,
                     final_parts=None):
    """scan_float.cu's sum over the selected values (others are 0) in
    float32, for a view whose first `head` rows precede its first 16-byte
    boundary; the keywords model wrong kernels."""
    psum = block_sum(thread_sums(vals, parts, head, acc).reshape(parts, T))
    if drop_block is not None:
        psum[drop_block] = 0.0
    if final_parts is not None:
        psum = psum[:final_parts]
    # the last block: thread i adds partials i, i + 256, ... in order
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
# many rows; 10M rows over the 4 blocks a SM of an H100 (132 SMs) of the
# two-pass kernel, and over the 8 of the one-launch kernel (the main path's
# parts), where the last block's pass also sums several partials a thread.
MAIN_PARTS = 8 * 132
SHAPES = [(1, 1), (255, 1), (100_003, 4), (10_000_000, 528),
          (10_000_000, MAIN_PARTS)]


@pytest.mark.parametrize("n,parts", SHAPES)
def test_kernel_summation_order_stays_inside_the_bound(n, parts):
    v = selected_values(n, n)
    exact, abs_sum = int(v.sum()), int(np.abs(v).sum())
    got = kernel_order_sum(f32(v), parts)
    assert abs(got - exact) <= float_scan_error_bound(n, parts, abs_sum)


@pytest.mark.parametrize("n,parts", [(1, 1), (3, 1), (255, 1), (257, 1),
                                     (1_000_003, 977), (1_000_003, 132)])
@pytest.mark.parametrize("offset", [0, 1, 2, 3])
def test_kernel_order_at_view_offsets_stays_inside_the_bound(n, parts,
                                                             offset):
    """A view at `offset` rows from an aligned column reads (4 - offset) % 4
    head rows one at a time before its 16-byte groups."""
    v = selected_values(n, n + offset)
    exact, abs_sum = int(v.sum()), int(np.abs(v).sum())
    got = kernel_order_sum(f32(v), parts, head=(4 - offset) % 4)
    assert abs(got - exact) <= float_scan_error_bound(n, parts, abs_sum)


def test_bound_at_the_main_path_size_is_a_few_ulps_of_the_magnitude():
    # 10M rows, 1,056 blocks (8 a SM, 132 SMs): 10 groups a thread plus a
    # head and a tail row, a group's 2 levels, a conversion, 16 block-tree
    # levels and 5 partials a thread of the last block: 36 roundings of
    # 2**-24 (the two-pass kernel's 528 blocks: 94).
    rel = float_scan_error_bound(10_000_000, MAIN_PARTS, 1.0)
    assert 36 * 2.0**-24 < rel < 37 * 2.0**-24
    assert rel <= 95 * 2.0**-24


@pytest.mark.parametrize("wrong", ["bf16 accumulator", "drop a block",
                                   "final pass reads 256 partials"])
def test_wrong_kernels_fall_outside_the_bound(wrong):
    n, parts = 10_000_000, MAIN_PARTS
    v = selected_values(n, 1, signed=False)
    exact, abs_sum = int(v.sum()), int(np.abs(v).sum())
    kw = {"bf16 accumulator": dict(acc=bf16),
          "drop a block": dict(drop_block=parts // 2),
          "final pass reads 256 partials": dict(final_parts=256)}[wrong]
    got = kernel_order_sum(f32(v), parts, **kw)
    assert abs(got - exact) > float_scan_error_bound(n, parts, abs_sum)


def test_model_constants_match_the_kernel_source():
    src = SOURCE.read_text()
    assert re.search(rf"constexpr int THREADS = {T};", src)
    # a group is one int4 of codes: four rows
    assert "int4 f, a;" in src and G == 4


@pytest.mark.parametrize("n,want", [(1, 1), (1024, 1), (1025, 2),
                                    (1_000_003, 977),
                                    (10_000_000, MAIN_PARTS)])
def test_parts_are_a_block_per_1024_rows_up_to_the_resident_blocks(
        monkeypatch, n, want):
    """`float_scan_parts` on a card of 132 SMs holding 8 blocks each."""
    monkeypatch.setattr(dict_ops, "float_scan_blocks_per_sm", lambda d: 8)
    monkeypatch.setattr(dict_ops, "sm_count", lambda d: 132)
    assert dict_ops.float_scan_parts(None, n) == want
