"""Kernel checks that need the card: each CUDA kernel against its plain
PyTorch version on CUDA tensors - the HTAP kernels with tolerance 0, the
LM serving kernels (flash-decode attention, selective scan) at the float32
tolerances of the reference's kernel tests (2e-5, 3e-5; a bf16 output one
bf16 rounding more, 2**-8 relative), the selective scan's backward within
1e-4 of each gradient's largest |value| and bit for bit repeatable, the
blocked attention and its backward (2e-4 in float32, the reference's own
flash-vs-SDPA tolerance; 1e-4 of each gradient's largest |value|; bf16
one bf16 step more), the float32 scan with an exact count
and its sum within ``float_scan_error_bound`` of the exact sum and 1e-5 *
sum(|v|) of the plain version's, AdamW's update bit for bit, the causal
conv and its backward within one rounding of the float32 plain version
(dw and db bit for bit repeatable), the gated selective scan (dt's bias
and softplus, the silu(z) gate) and its backward against the same chain
in float32 from the same operands: y within the scan's 3e-5 and one ulp
of its type, each gradient within 1e-4 of its largest |value|
and one ulp of its type (z's, which sums nothing, 1e-6), bit for bit
repeatable; and Jamba2-3B's Mamba mixer with its dt, B and C norms at its
widths, card against CPU in float32 (the output 1e-4, each gradient 1e-3
of its largest |value|).

Marked ``gpu``; every test skips when no GPU is present (decided when the
test runs, never at import). This file imports nothing of the JAX package,
so it runs where only the port is installed:

    python -m pytest -q -m gpu tests/test_torch_gpu.py
"""

import copy

import numpy as np
import pytest
import torch

from repro_torch.kernels.bitonic_sort import (apply_pipeline_batch,
                                              apply_pipeline_batch_ref,
                                              sort_rows, sort_rows_ref)
from repro_torch.kernels.common import (kernel_launch_counts,
                                        kernel_launch_shapes,
                                        reset_kernel_launch_counts)
from repro_torch.kernels.dict_ops import (MAX_ISLANDS, scan_exact,
                                          scan_exact_group,
                                          scan_exact_group_ref,
                                          scan_exact_mesh,
                                          scan_exact_mesh_ref,
                                          scan_exact_ref, scan_values_exact,
                                          scan_values_exact_ref)
from repro_torch.kernels.decode_attn import (decode_attention,
                                             decode_attention_ref)
from repro_torch.kernels.dict_ops import (scan_filter_agg,
                                          scan_filter_agg_float_ref)
from repro_torch.kernels.dict_ops.ops import (float_scan_error_bound,
                                              float_scan_parts)
from repro_torch.kernels.hash_probe import (EMPTY, build_table, probe,
                                            probe_ref, probe_sharded)
from repro_torch.kernels.merge_runs import (MAX_RUNS, merge_runs_ref,
                                            merge_sorted_runs)
from repro_torch.kernels.selective_scan import (STATE_SIZES,
                                                launch_selective_scan,
                                                launch_selective_scan_bwd,
                                                selective_scan,
                                                selective_scan_bwd,
                                                selective_scan_bwd_ref,
                                                selective_scan_ref)
from repro_torch.kernels.selective_scan.ops import _bwd_buffers

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (on the card: "
                    "python -m pytest -m gpu tests/test_torch_gpu.py)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("rows,width", [(1, 7), (3, 1000), (2, 70_000)])
def test_sort_rows_float32_kernel_matches_its_plain_version(cuda, rows,
                                                            width):
    """The CUDA sort takes float32 keys (NaN last, +-inf, -0.0), in one tile
    and across tiles merged pairwise by the tile merge (one K6 pass per
    doubling past 32,768, in the same call)."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn((rows, width), generator=gen, device=cuda) * 1e6
    x[:, 0], x[:, 1], x[:, 2] = float("nan"), float("inf"), -0.0
    x[:, -1] = float("-inf")
    reset_kernel_launch_counts()
    got = sort_rows(x)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, sort_rows_ref(x), rtol=0, atol=0,
                               equal_nan=True)
    passes = max(0, (width - 1).bit_length() - 15)
    assert kernel_launch_counts() == dict(
        bitonic_sort=1, **({"bitonic_merge_rows": passes} if passes else {}))


# (rows, n_old, w_old, n_val, w_val, case): the fused entry's in-block sort
# up to 2,048 values (w_val 1, 2,048, the path's 256), the separate sort
# above it (4,096; 65,536 with pairwise merges), a dictionary width that is
# not a multiple of a merge tile, a row of sentinels only, values all equal
# to an old key, int32.min, 1 and 65 rows
APPLY_SHAPES = [(8, 24_000, 32768, 200, 256, None),
                (3, 40, 64, 1, 1, None), (2, 5000, 8192, 2000, 2048, None),
                (2, 6000, 8192, 3000, 4096, None),
                (2, 1000, 1024, 40_000, 65536, None),
                (3, 4500, 5003, 200, 256, None),
                (3, 300, 512, 50, 64, "old_sentinels_only"),
                (4, 300, 512, 60, 64, "values_equal_an_old_key"),
                (2, 300, 512, 70, 128, "int32_min"),
                (1, 9000, 16384, 100, 128, None),
                (65, 90, 128, 20, 32, None)]


@pytest.mark.parametrize("rows,n_old,w_old,n_val,w_val,case", APPLY_SHAPES)
def test_apply_kernel_matches_its_plain_version(cuda, rows, n_old, w_old,
                                                n_val, w_val, case):
    """The fused sort + tile merge, bit for bit; one launch a call."""
    gen = torch.Generator(device=cuda).manual_seed(rows * 7 + w_val)

    def rand(shape):
        return torch.randint(-2**31, 2**31 - 1, shape, generator=gen,
                             device=cuda, dtype=torch.int64).to(torch.int32)

    old = torch.full((rows, w_old), I32_MAX, dtype=torch.int32, device=cuda)
    old[:, :n_old] = torch.sort(rand((rows, n_old)), dim=1).values
    val = torch.full((rows, w_val), I32_MAX, dtype=torch.int32, device=cuda)
    val[:, :n_val] = rand((rows, n_val))
    if case == "old_sentinels_only":
        old[0] = I32_MAX
    elif case == "values_equal_an_old_key":
        val[:, :n_val] = old[:, n_old // 2:n_old // 2 + 1]
    elif case == "int32_min":
        val[:, 1] = I32_MIN
        old[:, 0] = I32_MIN
    reset_kernel_launch_counts()
    svals, merged = apply_pipeline_batch(old, val)
    torch.cuda.synchronize()
    want_s, want_m = apply_pipeline_batch_ref(old, val)
    assert torch.equal(svals, want_s) and torch.equal(merged, want_m)
    assert kernel_launch_counts() == {"bitonic_apply": 1}


@pytest.mark.parametrize("sizes", [(0, 40, 41), (1, 1, 0, 0, 0),
                                   (1001, 1000), (5000, 5000, 5000, 4999)])
@pytest.mark.parametrize("join", [False, True])
def test_sharded_scan_kernel_matches_its_plain_version(cuda, sizes, join):
    gen = torch.Generator(device=cuda).manual_seed(1)
    s, w, k = len(sizes), max(sizes), 300
    f = torch.randint(0, k, (s, w), generator=gen, device=cuda,
                      dtype=torch.int32)
    a = torch.randint(0, k, (s, w), generator=gen, device=cuda,
                      dtype=torch.int32)
    real = (torch.arange(w, device=cuda)[None, :]
            < torch.tensor(sizes, device=cuda)[:, None])
    fv = real & (torch.rand((s, w), generator=gen, device=cuda) < 0.9)
    d = torch.sort(torch.randint(-2**31, 2**31 - 1, (k,), generator=gen,
                                 device=cuda, dtype=torch.int64)
                   ).values.to(torch.int32)
    bounds = [(0, k), (k // 4, k // 2), (7, 7)] + [(i, i + 9)
                                                   for i in range(8)]
    extra = ()
    if join:
        j = torch.randint(0, 50, (s, w), generator=gen, device=cuda,
                          dtype=torch.int32)
        jv = real & (torch.rand((s, w), generator=gen, device=cuda) < 0.8)
        rc = torch.randint(0, 10_000, (50,), generator=gen, device=cuda,
                           dtype=torch.int32)
        extra = (j, jv, rc)
    got = scan_exact(f, a, fv, d, bounds, *extra)
    torch.cuda.synchronize()
    assert torch.equal(got, scan_exact_ref(f, a, fv, d, bounds, *extra))


@pytest.mark.parametrize("sizes", [(0, 40, 41), (1, 1, 0, 0),
                                   (5000, 4999, 5000, 5000), (777,),
                                   (7,) * 17, tuple(range(1, 34)),
                                   tuple((i * 37) % 101 for i in range(100))])
@pytest.mark.parametrize("join", [False, True])
def test_mesh_scan_kernel_matches_its_plain_version(cuda, sizes, join):
    """Islands on the one card, as chip_smoke's mesh phase runs them (uneven
    slices of one column at any offset, empty islands among them): one
    island-table launch per 16 non-empty islands into one partial; equal
    to the plain version and to the flat scan."""
    gen = torch.Generator(device=cuda).manual_seed(2)
    n, k = sum(sizes), 300
    f = torch.randint(0, k, (n,), generator=gen, device=cuda,
                      dtype=torch.int32)
    a = torch.randint(0, k, (n,), generator=gen, device=cuda,
                      dtype=torch.int32)
    fv = torch.rand(n, generator=gen, device=cuda) < 0.9
    d = torch.sort(torch.randint(-2**31, 2**31 - 1, (k,), generator=gen,
                                 device=cuda, dtype=torch.int64)
                   ).values.to(torch.int32)
    j = torch.randint(0, 50, (n,), generator=gen, device=cuda,
                      dtype=torch.int32)
    jv = torch.rand(n, generator=gen, device=cuda) < 0.8
    rc = torch.randint(0, 10_000, (50,), generator=gen, device=cuda,
                       dtype=torch.int32)
    bounds = [(0, k), (k // 4, k // 2), (7, 7)] + [(i, i + 9)
                                                   for i in range(30)]
    cuts = np.cumsum([0, *sizes]).tolist()

    def split(t):
        return [t[lo:hi] for lo, hi in zip(cuts, cuts[1:])]

    isl = len(sizes)
    args = (split(f), split(a), split(fv), [d] * isl, bounds)
    extra = (split(j), split(jv), [rc] * isl) if join else ()
    reset_kernel_launch_counts()
    got = scan_exact_mesh(*args, *extra)
    torch.cuda.synchronize()
    name = "scan_exact_join_mesh" if join else "scan_exact_mesh"
    assert kernel_launch_counts() == {name: -(-sum(1 for s in sizes if s)
                                              // MAX_ISLANDS)}
    assert torch.equal(got, scan_exact_mesh_ref(*args, *extra))
    flat = (j, jv, rc) if join else ()
    assert torch.equal(got, scan_exact_ref(f, a, fv, d, bounds, *flat))


@pytest.mark.parametrize("n_keys", [1, 37, 25_000])
def test_probe_kernel_matches_its_plain_version(cuda, n_keys):
    rng = np.random.default_rng(n_keys)
    keys = rng.choice(np.arange(-(1 << 24), 1 << 24), size=n_keys,
                      replace=False).astype(np.int32)
    keys[0] = 2**31 - 1
    table = build_table(keys, rng.integers(0, 1 << 20, n_keys)
                        .astype(np.int32))
    q = torch.from_numpy(np.concatenate([
        keys, rng.integers(-(1 << 24), 1 << 24, 999).astype(np.int32),
        np.asarray([EMPTY, -1, 0], np.int32)])).to(cuda)
    kt, vt = table.on(cuda)
    got = probe(table, q, default=-5)
    torch.cuda.synchronize()
    assert torch.equal(got, probe_ref(kt, vt, q, -5))
    parts = [q[:0], q[:3], q, q[5:70]]
    for g, p in zip(probe_sharded(table, parts, default=-5), parts):
        assert torch.equal(g, probe_ref(kt, vt, p, -5))


I32_MIN, I32_MAX = -2**31, 2**31 - 1
VBOUNDS = [(I32_MIN, I32_MAX), (5, -5), (0, I32_MAX), (-1000, 1000),
           (I32_MIN, I32_MIN), (-7, 7), (100, 900), (-900, -100), (0, 0)]


def _stack(gen, cuda, rows, nr):
    """A (rows, nr) int32 correction stack with int32-extreme values."""
    x = torch.randint(-1000, 1000, (rows, nr), generator=gen, device=cuda,
                      dtype=torch.int32)
    if nr:
        x[0, 0], x[1, 0] = I32_MIN, I32_MAX
    for r in (2, 5)[:rows // 3]:
        x[r] = torch.rand(nr, generator=gen, device=cuda) < 0.8
    return x


@pytest.mark.parametrize("nr", [0, 1, 3, 4097, 300_001])
@pytest.mark.parametrize("rows,nq", [(3, 1), (6, 3), (6, 9)])
def test_values_lane_kernel_matches_its_plain_version(cuda, nr, rows, nq):
    """The correction lane alone (its own kernel): the raw-value scan
    (3-row stack) and the values delta (6 rows); 9 predicates take two
    slices, 300,001 rows more than one pass of the grid."""
    gen = torch.Generator(device=cuda).manual_seed(nr)
    stack = _stack(gen, cuda, rows, nr)
    reset_kernel_launch_counts()
    got = scan_values_exact(stack, VBOUNDS[:nq])
    torch.cuda.synchronize()
    assert torch.equal(got, scan_values_exact_ref(stack, VBOUNDS[:nq]))
    name = "scan_values" if rows == 3 else "scan_values_delta"
    assert kernel_launch_counts() == ({name: 1} if nr else {})


@pytest.mark.parametrize("nr", [0, 1, 3, 4097])
@pytest.mark.parametrize("sizes,join", [((5003,), False), ((5003,), True),
                                        ((400, 399, 399), False),
                                        ((250,) * 4, False),
                                        ((1000, 999, 999, 999), True)])
def test_group_kernel_matches_its_plain_version(cuda, nr, sizes, join):
    """The base scan (flat or stacked, with or without the join lane) and
    the correction lane in one launch."""
    gen = torch.Generator(device=cuda).manual_seed(nr + len(sizes))
    s, w, k = len(sizes), max(sizes), 300
    shape = (w,) if s == 1 else (s, w)
    f = torch.randint(0, k, shape, generator=gen, device=cuda,
                      dtype=torch.int32)
    a = torch.randint(0, k, shape, generator=gen, device=cuda,
                      dtype=torch.int32)
    real = (torch.arange(w, device=cuda)[None, :]
            < torch.tensor(sizes, device=cuda)[:, None]).reshape(shape)
    fv = real & (torch.rand(shape, generator=gen, device=cuda) < 0.9)
    d = torch.sort(torch.randint(I32_MIN, I32_MAX, (k,), generator=gen,
                                 device=cuda, dtype=torch.int64)
                   ).values.to(torch.int32)
    nq = 9 if nr == 4097 else 3
    bounds = [(0, k), (k // 4, k // 2), (7, 7)] + [(i, i + 9)
                                                   for i in range(6)]
    args = (f, a, fv, d, bounds[:nq], _stack(gen, cuda, 6, nr),
            VBOUNDS[:nq])
    extra = ()
    if join:
        j = torch.randint(0, 50, shape, generator=gen, device=cuda,
                          dtype=torch.int32)
        jv = real & (torch.rand(shape, generator=gen, device=cuda) < 0.8)
        rc = torch.randint(0, 10_000, (50,), generator=gen, device=cuda,
                           dtype=torch.int32)
        cj = _stack(gen, cuda, 6, nr + 2).abs()
        extra = (j, jv, rc, cj)
    got = scan_exact_group(*args, *extra)
    torch.cuda.synchronize()
    assert torch.equal(got, scan_exact_group_ref(*args, *extra))


@pytest.mark.parametrize("nr", [1, 4097])
@pytest.mark.parametrize("nq", [1, 3, 70])
@pytest.mark.parametrize("sizes", [(0, 40, 41), (0, 0), (5000, 4999, 5000),
                                   (7,) * 17])
@pytest.mark.parametrize("join", [False, True])
def test_mesh_group_kernel_matches_its_plain_version(cuda, sizes, join, nq,
                                                     nr):
    """The mesh scans with the correction slice, islands on the one card:
    one island-table launch per 16 non-empty islands (the slice alone where
    none holds rows), the slice riding the first, its stacks' rows in that
    launch's shape; 70 predicates take two launches of at most 64."""
    gen = torch.Generator(device=cuda).manual_seed(nr + nq)
    n, k = sum(sizes), 300
    f, a = (torch.randint(0, k, (n,), generator=gen, device=cuda,
                          dtype=torch.int32) for _ in range(2))
    fv = torch.rand(n, generator=gen, device=cuda) < 0.9
    d = torch.sort(torch.randint(I32_MIN, I32_MAX, (k,), generator=gen,
                                 device=cuda, dtype=torch.int64)
                   ).values.to(torch.int32)
    j = torch.randint(0, 50, (n,), generator=gen, device=cuda,
                      dtype=torch.int32)
    jv = torch.rand(n, generator=gen, device=cuda) < 0.8
    rc = torch.randint(0, 10_000, (50,), generator=gen, device=cuda,
                       dtype=torch.int32)
    bounds = [(i % k, i % k + 1 + i % 7) for i in range(nq)]
    vb = (VBOUNDS * 8)[:nq]
    cuts = np.cumsum([0, *sizes]).tolist()

    def split(t):
        return [t[lo:hi] for lo, hi in zip(cuts, cuts[1:])]

    isl = len(sizes)
    ca, cj = _stack(gen, cuda, 6, nr), _stack(gen, cuda, 6, nr + 2).abs()
    args = (split(f), split(a), split(fv), [d] * isl, bounds)
    extra = (split(j), split(jv), [rc] * isl) if join else ()
    corr = dict(corr_a=ca, corr_j=cj if join else None, vbounds=vb)
    reset_kernel_launch_counts()
    got = scan_exact_mesh(*args, *extra, **corr)
    torch.cuda.synchronize()
    assert torch.equal(got, scan_exact_mesh_ref(*args, *extra, **corr))
    name = "scan_exact_join_mesh" if join else "scan_exact_mesh"
    slices = -(-nq // 64)
    groups = max(1, -(-sum(1 for s in sizes if s) // MAX_ISLANDS))
    assert kernel_launch_counts() == {name: slices * groups}
    rows = (nr, nr + 2) if join else (nr,)
    carried = [sh for sh in kernel_launch_shapes()[name]
               if sh[-len(rows):] == rows]
    assert sum(kernel_launch_shapes()[name][sh] for sh in carried) == slices


@pytest.mark.parametrize("B,S,H,Hkv,d,length,cap,kv", [
    (2, 1000, 8, 8, 128, 1, 0.0, torch.float32),       # G 1, one slot
    (3, 777, 10, 2, 128, 777, 50.0, torch.float32),    # G 5, full cache
    (1, 4097, 56, 8, 128, 3001, 0.0, torch.bfloat16),  # G 7 (deepseek)
    (4, 4096, 16, 8, 256, 287, 50.0, torch.bfloat16),  # gemma2's decode
    (2, 9, 4, 2, 64, 5, 30.0, torch.float32),
    (1, 33000, 16, 8, 256, 32999, 50.0, torch.bfloat16),
    (2, 1000, 64, 8, 112, 777, 50.0, torch.bfloat16),  # kimi-k2's heads
    (1, 4096, 64, 8, 112, 4096, 0.0, torch.float32),
    (3, 300, 4, 2, 16, 123, 30.0, torch.float32),      # the smoke configs'
    (2, 70, 12, 4, 48, 1, 0.0, torch.bfloat16),
])
def test_decode_attention_kernel_matches_its_plain_version(
        cuda, B, S, H, Hkv, d, length, cap, kv):
    """float32 queries; a bf16 cache is compared after up-casting (both
    versions read it as float32)."""
    gen = torch.Generator(device=cuda).manual_seed(S + H)
    q = torch.randn((B, H, d), generator=gen, device=cuda)
    k = torch.randn((B, S, Hkv, d), generator=gen, device=cuda).to(kv)
    v = torch.randn((B, S, Hkv, d), generator=gen, device=cuda).to(kv)
    reset_kernel_launch_counts()
    got = decode_attention(q, k, v, length, softcap=cap)
    torch.cuda.synchronize()
    assert kernel_launch_counts() == {"decode_attn": 1}
    want = decode_attention_ref(q, k, v, length, d ** -0.5, cap)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


def test_decode_attention_kernel_in_bf16_and_with_a_tensor_length(cuda):
    gen = torch.Generator(device=cuda).manual_seed(7)
    q = torch.randn((2, 16, 256), generator=gen, device=cuda).bfloat16()
    k = torch.randn((2, 300, 8, 256), generator=gen,
                    device=cuda).bfloat16()
    v = torch.randn((2, 300, 8, 256), generator=gen,
                    device=cuda).bfloat16()
    length = torch.tensor(123, device=cuda)
    got = decode_attention(q, k, v, length, softcap=50.0)
    # the plain version's float32 answer on the same bf16 values: 2e-5 for
    # the float32 work, then one round-to-nearest to bf16 (2**-8 relative)
    want = decode_attention_ref(q.float(), k, v, 123, 256 ** -0.5, 50.0)
    assert got.dtype == torch.bfloat16
    atol = 2e-5 * (1 + 2**-8)
    torch.testing.assert_close(got.float(), want, rtol=2**-8 + atol,
                               atol=atol)


@pytest.mark.parametrize("B,T,D,N", [(1, 1, 1, 4), (2, 257, 100, 8),
                                     (3, 1000, 130, 16), (1, 64, 8192, 16),
                                     (4, 2048, 512, 16)])
def test_selective_scan_kernel_matches_its_plain_version(cuda, B, T, D, N):
    gen = torch.Generator(device=cuda).manual_seed(T + D)
    x = torch.randn((B, T, D), generator=gen, device=cuda)
    dt = torch.randn((B, T, D), generator=gen, device=cuda).abs() * 0.1
    a = -torch.randn((D, N), generator=gen, device=cuda).abs()
    b = torch.randn((B, T, N), generator=gen, device=cuda)
    c = torch.randn((B, T, N), generator=gen, device=cuda)
    d = torch.randn((D,), generator=gen, device=cuda)
    reset_kernel_launch_counts()
    got = selective_scan(x, dt, a, b, c, d)
    torch.cuda.synchronize()
    assert kernel_launch_counts() == {"selective_scan": 1}
    torch.testing.assert_close(got, selective_scan_ref(x, dt, a, b, c, d),
                               rtol=3e-5, atol=3e-5)


@pytest.mark.parametrize("B,T,D,N", [(2, 300, 8200, 16), (2, 129, 4101, 8),
                                     (1, 40, 70, 4)])
def test_selective_scan_ragged_channels(cuda, B, T, D, N):
    """The bare launch with D not a multiple of a block's 32 channels, and
    D % 4 != 0 (4-byte staging); every output written."""
    gen = torch.Generator(device=cuda).manual_seed(D)
    x = torch.randn((B, T, D), generator=gen, device=cuda)
    dt = torch.randn((B, T, D), generator=gen, device=cuda).abs() * 0.1
    a = -torch.randn((D, N), generator=gen, device=cuda).abs()
    b = torch.randn((B, T, N), generator=gen, device=cuda)
    c = torch.randn((B, T, N), generator=gen, device=cuda)
    d = torch.randn((D,), generator=gen, device=cuda)
    y = torch.full_like(x, float("nan"))
    launch_selective_scan(x, dt, a, b, c, d, y)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, selective_scan_ref(x, dt, a, b, c, d),
                               rtol=3e-5, atol=3e-5)


def _scan_inputs(cuda, B, T, D, N, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn((B, T, D), generator=gen, device=cuda)
    dt = torch.randn((B, T, D), generator=gen, device=cuda).abs() * 0.1
    a = -torch.randn((D, N), generator=gen, device=cuda).abs()
    b = torch.randn((B, T, N), generator=gen, device=cuda)
    c = torch.randn((B, T, N), generator=gen, device=cuda)
    d = torch.randn((D,), generator=gen, device=cuda)
    gy = torch.randn((B, T, D), generator=gen, device=cuda)
    return x, dt, a, b, c, d, gy


def _grads_close(got, want, tol=1e-4):
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, i
        scale = float(w.abs().max())
        assert float((g - w).abs().max()) <= tol * scale, i


@pytest.mark.parametrize("B,T,D,N", [(1, 1, 1, 4), (2, 257, 100, 8),
                                     (3, 1000, 130, 16), (2, 300, 8200, 16),
                                     (2, 129, 4101, 8), (1, 40, 70, 4)])
def test_selective_scan_backward_kernel_matches_its_plain_version(
        cuda, B, T, D, N):
    *args, gy = _scan_inputs(cuda, B, T, D, N, T + D)
    reset_kernel_launch_counts()
    got = selective_scan_bwd(*args, gy)
    torch.cuda.synchronize()
    assert kernel_launch_counts() == {"selective_scan_bwd": 1}
    _grads_close(got, selective_scan_bwd_ref(*args, gy))
    again = selective_scan_bwd(*args, gy)
    assert all(torch.equal(p, q) for p, q in zip(got, again))


@pytest.mark.parametrize("N", STATE_SIZES)
@pytest.mark.parametrize("B,T,D", [(1, 1, 1), (2, 257, 100), (1, 33, 4101)])
def test_selective_scan_backward_bare_launch_into_its_buffers(cuda, B, T, D,
                                                              N):
    """The backward's instance for each d_state, launched bare into
    `_bwd_buffers`' partials and summed as the wrapper sums them, against
    the plain backward."""
    *args, gy = _scan_inputs(cuda, B, T, D, N, T + D + N)
    gx, gdt = torch.empty_like(gy), torch.empty_like(gy)
    parts = _bwd_buffers(B, T, D, N, cuda)
    launch_selective_scan_bwd(*args, gy, gx, gdt, *parts)
    torch.cuda.synchronize()
    _grads_close((gx, gdt) + tuple(p.sum(0) for p in parts[:4]),
                 selective_scan_bwd_ref(*args, gy))


def test_selective_scan_autograd_runs_both_kernels(cuda):
    """An input that needs a gradient: the forward kernel, then the
    backward kernel from `loss.backward()`, the plain backward's
    gradients."""
    *args, gy = _scan_inputs(cuda, 2, 77, 96, 16, 5)
    leaves = [t.clone().requires_grad_() for t in args]
    reset_kernel_launch_counts()
    y = selective_scan(*leaves)
    (y * gy).sum().backward()
    torch.cuda.synchronize()
    assert kernel_launch_counts() == {"selective_scan": 1,
                                      "selective_scan_bwd": 1}
    _grads_close([t.grad for t in leaves], selective_scan_bwd_ref(*args, gy))


@pytest.mark.parametrize("lens", [(1000,), (0, 1), (256, 256, 255, 257),
                                  (0, 9, 1, 64, 0, 33, 2), (1300,) * 8,
                                  (3000, 2000, 1, 0), (5,) * 70])
def test_kway_merge_kernel_matches_its_plain_version(cuda, lens):
    """Bit for bit, ties across runs in run order, int64.max and int64.min,
    inputs past shared memory, more runs than one launch takes; one launch
    for up to MAX_RUNS runs."""
    gen = torch.Generator(device=cuda).manual_seed(len(lens))
    runs = [torch.sort(torch.randint(-30, 30, (n,), generator=gen,
                                     device=cuda)).values for n in lens]
    for r in runs:
        if r.numel() > 1:
            r[0], r[-1] = -2**63, 2**63 - 1
    reset_kernel_launch_counts()
    keys, src = merge_sorted_runs(runs)
    torch.cuda.synchronize()
    want_keys, want_src = merge_runs_ref(runs)
    assert torch.equal(keys, want_keys) and torch.equal(src, want_src)
    launches = kernel_launch_counts().get("merge_runs", 0)
    n_runs = len(lens)
    assert launches == (0 if n_runs == 1 else 1 if n_runs <= MAX_RUNS
                        else -(-n_runs // MAX_RUNS) + 1)


@pytest.mark.parametrize("n", [1, 255, 257, 1_000_003])
def test_float_scan_kernel_matches_its_plain_version(cuda, n):
    gen = torch.Generator(device=cuda).manual_seed(n)
    k = 5000
    f = torch.randint(0, k, (n,), generator=gen, device=cuda,
                      dtype=torch.int32)
    a = torch.randint(0, k, (n,), generator=gen, device=cuda,
                      dtype=torch.int32)
    fv = torch.rand(n, generator=gen, device=cuda) < 0.9
    dic = torch.sort(torch.randint(-2**24, 2**24, (k,), generator=gen,
                                   device=cuda, dtype=torch.int32)).values
    for lo, hi in ((0, k), (k // 4, k // 2), (7, 7)):
        s, c = scan_filter_agg(f, a, fv, dic, lo, hi, exact=False)
        ws, wc = scan_filter_agg_float_ref(f, a, fv, dic, lo, hi)
        mask = (f >= lo) & (f < hi) & fv
        vals = dic[a.long()].long()
        exact = int(torch.where(mask, vals, 0).sum())
        assert (s.dtype, c.dtype) == (torch.float32, torch.int32)
        assert int(c) == int(wc) == int(mask.sum())
        abs_sum = int(torch.where(mask, vals, 0).abs().sum())
        bound = float_scan_error_bound(n, float_scan_parts(cuda, n), abs_sum)
        assert abs(float(s) - exact) <= bound
        assert abs(float(s) - float(ws)) <= 1e-5 * abs_sum


@pytest.mark.parametrize("n", [1, 3, 255, 257, 1_000_003])
@pytest.mark.parametrize("offsets", [(0, 0, 0), (1, 1, 1), (2, 2, 2),
                                     (3, 3, 3), (1, 2, 0)])
def test_float_scan_kernel_at_view_offsets_is_right_and_repeatable(
        cuda, n, offsets):
    """Views 1 - 3 rows into their columns read 3 - 1 head rows before
    their 16-byte groups; columns at different offsets are read a row at a
    time. Two calls give the same bits."""
    gen = torch.Generator(device=cuda).manual_seed(n + sum(offsets))
    k = 5000
    cols = [torch.randint(0, k, (n + 3,), generator=gen, device=cuda,
                          dtype=torch.int32) for _ in range(2)]
    cols.append(torch.rand(n + 3, generator=gen, device=cuda) < 0.9)
    f, a, fv = (c[o:o + n] for c, o in zip(cols, offsets))
    dic = torch.randint(-2**31, 2**31 - 1, (k,), generator=gen, device=cuda,
                        dtype=torch.int32)
    for lo, hi in ((0, k), (k // 4, k // 2), (7, 7)):
        s, c = scan_filter_agg(f, a, fv, dic, lo, hi, exact=False)
        s2, c2 = scan_filter_agg(f, a, fv, dic, lo, hi, exact=False)
        assert torch.equal(s.view(torch.int32), s2.view(torch.int32))
        assert int(c) == int(c2)
        ws, wc = scan_filter_agg_float_ref(f, a, fv, dic, lo, hi)
        mask = (f >= lo) & (f < hi) & fv
        vals = dic[a.long()].long()
        exact = int(torch.where(mask, vals, 0).sum())
        abs_sum = int(torch.where(mask, vals, 0).abs().sum())
        assert int(c) == int(wc) == int(mask.sum())
        bound = float_scan_error_bound(n, float_scan_parts(cuda, n), abs_sum)
        assert abs(float(s) - exact) <= bound
        assert abs(float(s) - float(ws)) <= 1e-5 * abs_sum


def _join_columns(gen, cuda, n, k):
    f, a, j = (torch.randint(0, k, (n,), generator=gen, device=cuda,
                             dtype=torch.int32) for _ in range(3))
    fv = torch.rand(n, generator=gen, device=cuda) < 0.9
    jv = torch.rand(n, generator=gen, device=cuda) < 0.8   # some fv, not jv
    d = torch.randint(I32_MIN, I32_MAX, (k,), generator=gen, device=cuda,
                      dtype=torch.int32)
    rc = torch.randint(0, 10_000, (k,), generator=gen, device=cuda,
                       dtype=torch.int32)
    return f, a, fv, j, jv, d, rc


@pytest.mark.parametrize("nq", [1, 2, 8, 9, 17])
@pytest.mark.parametrize("offsets", [(0,) * 5, (1,) * 5, (2,) * 5, (3,) * 5,
                                     (1, 2, 3, 0, 1)])
def test_join_lane_kernel_at_every_predicate_pass(cuda, nq, offsets):
    """Q = 1 (the one-predicate pass), 2 and 8 (the wide pass), 9 and 17
    (more grid slices), bit for bit, over views 0 - 3 rows into their
    columns (head rows, then 16-byte groups) and columns at different
    offsets (a row at a time); the join group with empty and one-row
    stacks."""
    gen = torch.Generator(device=cuda).manual_seed(nq + 10 * sum(offsets))
    n, k = 100_003, 700
    cols = _join_columns(gen, cuda, n + 3, k)
    f, a, fv, j, jv = (c[o:o + n] for c, o in zip(cols[:5], offsets))
    d, rc = cols[5:]
    lows = torch.randint(0, k, (nq,), generator=gen, device=cuda).tolist()
    bounds = ([(0, k), (7, 7)] + [(lo, lo + 1 + 37 * i % k)
                                  for i, lo in enumerate(lows)])[:nq]
    got = scan_exact(f, a, fv, d, bounds, j, jv, rc)
    torch.cuda.synchronize()
    assert torch.equal(got, scan_exact_ref(f, a, fv, d, bounds, j, jv, rc))
    for nr in (0, 1):
        args = (f, a, fv, d, bounds, _stack(gen, cuda, 6, nr),
                (VBOUNDS * 2)[:nq], j, jv, rc, _stack(gen, cuda, 6, nr).abs())
        got = scan_exact_group(*args)
        torch.cuda.synchronize()
        assert torch.equal(got, scan_exact_group_ref(*args))


@pytest.mark.parametrize("nq", [1, 9])
def test_join_lane_kernel_over_shards_off_16_byte_boundaries(cuda, nq):
    """Shards 1,001 wide: each after the first starts off a 16-byte
    boundary and reads its head rows one at a time."""
    gen = torch.Generator(device=cuda).manual_seed(nq)
    s, w, k = 3, 1001, 300
    f, a, fv, j, jv, d, rc = _join_columns(gen, cuda, s * w, k)
    f, a, fv, j, jv = (t.reshape(s, w) for t in (f, a, fv, j, jv))
    fv[2, 999:] = False                  # a padded tail
    bounds = [(0, k)] + [(i, i + 9) for i in range(nq - 1)]
    got = scan_exact(f, a, fv, d, bounds, j, jv, rc)
    torch.cuda.synchronize()
    assert torch.equal(got, scan_exact_ref(f, a, fv, d, bounds, j, jv, rc))


@pytest.mark.parametrize("name", ["gemma2-9b", "falcon-mamba-7b",
                                  "qwen2.5-14b"])
def test_lm_decode_matches_prefill_on_the_card(cuda, name):
    """A smoke-size model as configured (head_dim 16, which the decode
    kernel takes): token-by-token decode (the decode-attention kernel, or
    the plain Mamba step) against the parallel prefill (plain attention,
    or the scan kernel), 2e-3 as the reference's own test; float32."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.lm import (init_lm, init_lm_cache, lm_apply,
                                       lm_decode_step)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_smoke_config(name)
    gen = torch.Generator(device=cuda).manual_seed(0)
    model = init_lm(cfg, generator=gen, device=cuda)
    toks = torch.randint(0, cfg.vocab_size, (2, 12), generator=gen,
                         device=cuda, dtype=torch.int32)
    reset_kernel_launch_counts()
    want, _ = lm_apply(model, toks, cfg)
    cache = init_lm_cache(cfg, 2, 12, dtype=torch.float32, device=cuda)
    for i in range(12):
        got, cache = lm_decode_step(model, cache, toks[:, i:i + 1], i, cfg)
        torch.testing.assert_close(got[:, 0], want[:, i], rtol=2e-3,
                                   atol=2e-3)
    n_mamba = sum(s.mixer == "mamba" for s in cfg.blocks) * cfg.n_periods
    want_counts = {}
    if n_mamba:
        want_counts["selective_scan"] = n_mamba
        want_counts["causal_conv"] = n_mamba
    if cfg.n_layers - n_mamba:
        want_counts["decode_attn"] = (cfg.n_layers - n_mamba) * 12
    assert kernel_launch_counts() == want_counts


@pytest.mark.parametrize("shape", [
    (2, 300, 300, 8, 8, 64, True, 0, 0.0),        # ragged tiles
    (1, 200, 333, 5, 1, 128, False, 0, 30.0),     # Sq != Skv, G 5
    (1, 1024, 1024, 8, 1, 112, True, 100, 50.0),  # d 112, G 8, a window
    (1, 512, 512, 16, 8, 256, True, 64, 50.0),    # gemma2's heads
    # Jamba2-3B's attention: 20 query heads of 128 over one KV head; one
    # query row (against 65 keys: a causal row of length 1 has one key, and
    # its dq and dk are 0), and causal lengths that leave the 64- and
    # 128-row tiles tails
    (1, 1, 65, 20, 1, 128, False, 0, 0.0),
    *[(1, s, s, 20, 1, 128, True, 0, 0.0) for s in (63, 65, 4097)]])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernels_match_their_plain_versions(cuda, shape,
                                                            dtype):
    """The blocked attention's forward (output and log-sum-exp, 2e-4 in
    float32 as the reference's flash-vs-SDPA test; a bf16 output one bf16
    step more) and its two backward launches (1e-4 of each gradient's
    largest |value|, bf16 one bf16 step more) against the plain versions;
    a second forward and backward equal to the first bit for bit."""
    from repro_torch.kernels.flash_attn import (flash_attention_bwd,
                                                flash_attention_bwd_ref,
                                                flash_attention_fwd,
                                                flash_attention_fwd_ref)
    B, Sq, Skv, H, Hkv, dh, causal, window, cap = shape
    kw = dict(causal=causal, window=window, softcap=cap)
    blocks = dict(q_block=Sq, kv_block=Skv)
    gen = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn((B, Sq, H, dh), generator=gen, device=cuda)
    k, v = (torch.randn((B, Skv, Hkv, dh), generator=gen, device=cuda)
            for _ in range(2))
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    reset_kernel_launch_counts()
    out, lse = flash_attention_fwd(q, k, v, **kw)
    want, want_lse = flash_attention_fwd_ref(q.float(), k.float(), v.float(),
                                             **kw, **blocks)
    step = 2**-7 if dtype == torch.bfloat16 else 0.0
    torch.testing.assert_close(out.float(), want, rtol=2e-4 + step,
                               atol=2e-4)
    torch.testing.assert_close(lse, want_lse, rtol=2e-4, atol=2e-4)
    out2, lse2 = flash_attention_fwd(q, k, v, **kw)
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    dout = torch.randn(out.shape, generator=gen, device=cuda).to(dtype)
    got = flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    torch.cuda.synchronize()
    for g, w in zip(got, flash_attention_bwd_ref(q, k, v, out, lse, dout,
                                                 **kw, **blocks)):
        assert g.dtype == dtype
        scale = float(w.float().abs().max())
        assert float((g.float() - w.float()).abs().max()) <= \
            (1e-4 + step) * scale
    again = flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert kernel_launch_counts() == {"flash_attention": 2,
                                      "flash_attention_bwd": 4}


def test_flash_attention_refuses_what_its_kernel_does_not_take(cuda):
    """head_dim 96 and a row without a key in its band raise, naming the
    plain version; nothing launches."""
    from repro_torch.nn.flash import flash_attention
    q = torch.randn((1, 64, 2, 96), device=cuda)
    reset_kernel_launch_counts()
    with pytest.raises(ValueError, match="flash_attention_fwd_ref"):
        flash_attention(q, q, q)
    q = torch.randn((1, 64, 2, 64), device=cuda)
    with pytest.raises(ValueError, match="flash_attention_fwd_ref"):
        flash_attention(q, q[:, :8], q[:, :8], causal=False, window=4,
                        q_block=64, kv_block=8)
    assert kernel_launch_counts() == {}


# falcon-mamba-7b's leaves in the benchmark's training cell: in_proj,
# x_proj, dt_proj's bias, a_log (float32) and the 65,024 x 4,096 embedding
ADAMW_FM7B = [((4096, 16384), torch.bfloat16), ((8192, 288), torch.bfloat16),
              ((8192,), torch.bfloat16), ((8192, 16), torch.float32),
              ((65024, 4096), torch.bfloat16)]
ADAMW_EDGES = ([((n,), torch.bfloat16) for n in (1, 7, 8, 9, 2047, 2049)]
               + [((0,), torch.bfloat16), ((3, 5), torch.float32)]
               + [((17,), torch.bfloat16)] * 90)


def _adamw_leaves(cuda, shapes, masters, offset, gen):
    """Leaves drawn on the card; with `offset` each tensor is a view one
    element into a buffer of its own (not 16-byte aligned)."""
    def put(x):
        if not offset:
            return x.contiguous()
        buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=cuda)
        view = buf[1:].view(x.shape)
        view.copy_(x)
        return view
    leaves = []
    for shape, dt in shapes:
        p = (torch.randn(shape, generator=gen, device=cuda) * 0.05).to(dt)
        w = p.float() + torch.randn(shape, generator=gen, device=cuda) * 1e-4
        leaves.append((put(w.to(dt) if masters else p),
                       None, put(torch.zeros(shape, device=cuda)),
                       put(torch.zeros(shape, device=cuda)),
                       put(w) if masters else None))
    return leaves


@pytest.mark.parametrize("shapes,masters,offset", [
    (ADAMW_FM7B, True, False), (ADAMW_EDGES, True, False),
    (ADAMW_EDGES, False, False), (ADAMW_EDGES, True, True),
    (ADAMW_EDGES[:8], False, True)],
    ids=["fm7b", "edges", "edges_plain", "edges_unaligned",
         "plain_unaligned"])
def test_adamw_kernel_equals_its_plain_version_bit_for_bit(cuda, shapes,
                                                            masters, offset):
    """Three steps of the fused update against the plain version on copies
    of the same leaves, with weight decay and the bf16 cast: parameters, m,
    v and masters equal bit for bit after every step; one launch a group
    of up to MAX_LEAVES leaves of one instance."""
    from repro_torch.kernels.adamw import (adamw_update, adamw_update_ref,
                                           launch_groups)
    from repro_torch.optim.adamw import f32_step
    hyper = dict(lr=1e-3, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.01)
    gen = torch.Generator(device=cuda).manual_seed(32)
    fused = _adamw_leaves(cuda, shapes, masters, offset, gen)
    plain = [tuple(None if t is None else t.clone() for t in leaf)
             for leaf in fused]
    for step in range(3):
        grads = [(torch.randn(leaf[0].shape, generator=gen, device=cuda)
                  * 1e-2).to(leaf[0].dtype) for leaf in fused]
        t = f32_step(step, cuda)
        bc1, bc2 = 1.0 - hyper["b1"] ** t, 1.0 - hyper["b2"] ** t
        with_g = [(p, g, m, v, w) for (p, _, m, v, w), g in zip(fused, grads)]
        reset_kernel_launch_counts()
        adamw_update(with_g, bc1, bc2, **hyper)
        n_launches = kernel_launch_counts().get("adamw", 0)
        adamw_update_ref([(p, g.clone(), m, v, w) for (p, _, m, v, w), g
                          in zip(plain, grads)], bc1, bc2, *hyper.values())
        torch.cuda.synchronize()
        for a, b in zip(fused, plain):
            for x, y in zip(a, b):
                if x is not None:
                    assert x.dtype == y.dtype and torch.equal(x, y), step
        groups = [g for g in launch_groups(with_g)
                  if sum(with_g[i][0].numel() for i in g)]
        assert n_launches == len(groups)


# The causal conv: x the in-projection's first half (rows 2 D apart), a
# contiguous copy, or a view one element off a 16-byte boundary; ragged T
# (tiles of 64 steps) and D (slabs of 256 channels, vectors of 8)
CONV_CASES = [(1, 4096, 8192, "strided"), (1, 4096, 5120, "strided"),
              (1, 1, 100, "strided"),
              (2, 3, 4101, "contiguous"), (1, 5, 264, "strided"),
              (3, 4097, 8, "strided"), (2, 65, 257, "offset"),
              (1, 130, 512, "offset"), (2, 64, 1, "contiguous")]


def _conv_inputs(cuda, B, T, D, dtype, layout, seed=34):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    full = torch.randn((B, T, 2 * D), generator=gen,
                       device=cuda).to(dtype)
    x = {"strided": full[..., :D], "contiguous": full[..., :D].contiguous(),
         "offset": full[..., 1:D + 1]}[layout]
    w = (torch.randn((4, D), generator=gen, device=cuda) * 0.5).to(dtype)
    b = (torch.randn((D,), generator=gen, device=cuda) * 0.1).to(dtype)
    gy = torch.randn((B, T, D), generator=gen, device=cuda).to(dtype)
    return x, w, b, gy


def _conv_close(got, want):
    """`got` in its type against the float32 plain result rounded to that
    type: one rounding apart (2**-7 of the value in bf16; 1e-5 in float32
    for the sums' order) plus 1e-5 of the largest |value| (sums that
    cancel)."""
    rtol = 2**-7 if got.dtype == torch.bfloat16 else 1e-5
    scale = float(want.abs().max()) if want.numel() else 0.0
    torch.testing.assert_close(got.float(), want.to(got.dtype).float(),
                               rtol=rtol, atol=1e-5 * scale + 1e-7)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,T,D,layout", CONV_CASES)
def test_causal_conv_kernels_match_their_plain_version(cuda, B, T, D, layout,
                                                       dtype):
    """The forward and the backward's dx, dw and db against the float32
    plain versions on the same operands; one launch each, counted with
    (B, T, D, K); dw and db bit for bit the same from a second call."""
    from repro_torch.kernels.causal_conv import (causal_conv_silu,
                                                 causal_conv_silu_bwd,
                                                 causal_conv_silu_bwd_ref,
                                                 causal_conv_silu_ref)
    x, w, b, gy = _conv_inputs(cuda, B, T, D, dtype, layout)
    reset_kernel_launch_counts()
    y = causal_conv_silu(x, w, b)
    grads = causal_conv_silu_bwd(x, w, b, gy)
    again = causal_conv_silu_bwd(x, w, b, gy)
    torch.cuda.synchronize()
    assert kernel_launch_shapes() == {"causal_conv": {(B, T, D, 4): 1},
                                      "causal_conv_bwd": {(B, T, D, 4): 2}}
    f32 = [t.float() for t in (x, w, b)]
    _conv_close(y, causal_conv_silu_ref(*f32))
    assert y.is_contiguous() and grads[0].is_contiguous()
    for got, want, twice in zip(grads, causal_conv_silu_bwd_ref(
            *f32, gy.float()), again):
        assert got.dtype == dtype and got.shape == want.shape
        _conv_close(got, want)
        assert torch.equal(got, twice)


def test_causal_conv_autograd_runs_both_kernels(cuda):
    """Through `causal_conv_silu` on the in-projection's half with
    gradients on: the forward and backward kernels once each, the
    gradient reaching the projection's first half only."""
    from repro_torch.kernels.causal_conv import (causal_conv_silu,
                                                 causal_conv_silu_bwd_ref)
    _, w, b, gy = _conv_inputs(cuda, 1, 300, 264, torch.bfloat16, "strided")
    xz = torch.randn((1, 300, 528), device=cuda).to(torch.bfloat16)
    leaves = [t.requires_grad_() for t in (xz, w, b)]
    reset_kernel_launch_counts()
    y = causal_conv_silu(xz.chunk(2, dim=-1)[0], w, b)
    (y.float() * gy.float()).sum().backward()
    torch.cuda.synchronize()
    assert kernel_launch_counts() == {"causal_conv": 1, "causal_conv_bwd": 1}
    want = causal_conv_silu_bwd_ref(xz[..., :264].detach().float(),
                                    w.detach().float(), b.detach().float(),
                                    gy.float())
    for got, ref in zip((xz.grad[..., :264], w.grad, b.grad), want):
        _conv_close(got, ref)
    assert not xz.grad[..., 264:].any()
    del leaves


# The gated selective scan: Mamba's x, dt's raw projection, its bias and
# z (the in-projection's second half, a strided view) in bf16 or float32;
# training's shape sliced along D and T (falcon-mamba's D 8,192, Jamba's
# 5,120), ragged T and D, every d_state.
GATED_CASES = [(1, 4096, 256, 16), (1, 257, 8192, 16),
               (1, 2049, 5120, 16), (1, 1, 1, 4), (2, 257, 100, 8), (3, 1000, 130, 16), (2, 129, 4101, 8),
               (1, 40, 70, 4), (4, 2048, 96, 16)]


def _gated_inputs(cuda, B, T, D, N, dtype, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    x, _, a, b, c, d, _ = _scan_inputs(cuda, B, T, D, N, seed)
    raw = torch.randn((B, T, D), generator=gen, device=cuda) - 2.5
    bias = torch.randn((D,), generator=gen, device=cuda) * 0.3
    xz = torch.randn((B, T, 2 * D), generator=gen, device=cuda).to(dtype)
    g = torch.randn((B, T, D), generator=gen, device=cuda).to(dtype)
    return (x.to(dtype), raw.to(dtype), bias.to(dtype), a, b, c, d,
            xz.chunk(2, dim=-1)[1]), g


def _rounding(dtype):
    """One ulp of `dtype`, relative: 2**-7 in bf16; float32 a few ulps."""
    return 2**-7 if dtype == torch.bfloat16 else 1e-6


def _gated_forward_close(args, y, y_pre):
    """y_pre within the scan's 3e-5 (relative plus absolute) and one ulp of
    the float32 chain's; y the same, the scan's part carried through the
    gate (|silu(z)|)."""
    from repro_torch.kernels.selective_scan import selective_scan_gated_f32
    want, pre = selective_scan_gated_f32(*args)
    z = args[7].float()
    silu = z * torch.sigmoid(z)
    r = _rounding(y.dtype)
    for got, w, tol in (
            (y_pre, pre, r * pre.abs() + 3e-5 * (1 + pre.abs())),
            (y, want, r * want.abs() + 3e-5 * (1 + pre.abs()) * silu.abs())):
        assert got.dtype == args[0].dtype and got.is_contiguous()
        assert bool(((got.float() - w).abs() <= tol + 1e-30).all())


def _gated_grads_close(got, want):
    """The eight gradients, each within 1e-4 of its largest |value| (gz
    1e-6) plus an ulp of its type (both sides rounded once)."""
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and g.dtype == w.dtype, i
        if not g.numel():
            continue
        wf = w.float()
        tol = (1e-6 if i == 7 else 1e-4) * float(wf.abs().max()) \
            + _rounding(g.dtype) * wf.abs()
        assert bool(((g.float() - wf).abs() <= tol + 1e-30).all()), i


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,T,D,N", GATED_CASES)
def test_gated_scan_kernels_match_the_float32_chain(cuda, B, T, D, N, dtype):
    """The gated forward (y and y_pre) and backward against the chain in
    float32 from the same operands; one launch each, counted under the
    plain kernels' names and shapes; two backward calls equal bit for
    bit."""
    from repro_torch.kernels.selective_scan import (
        selective_scan_gated_bwd, selective_scan_gated_bwd_ref)
    from repro_torch.kernels.selective_scan.ops import _gated_forward_gpu
    args, g = _gated_inputs(cuda, B, T, D, N, dtype, B + T + D)
    reset_kernel_launch_counts()
    y, y_pre = _gated_forward_gpu(*args, True)
    got = selective_scan_gated_bwd(*args, y_pre, g)
    torch.cuda.synchronize()
    assert kernel_launch_shapes() == {
        "selective_scan": {(B, T, D, N): 1},
        "selective_scan_bwd": {(B, T, D, N): 1}}
    _gated_forward_close(args, y, y_pre)
    _gated_grads_close(got, selective_scan_gated_bwd_ref(*args, y_pre, g))
    again = selective_scan_gated_bwd(*args, y_pre, g)
    assert all(torch.equal(p, q) for p, q in zip(got, again))


@pytest.mark.parametrize("layout", ["contiguous", "offset"])
def test_gated_scan_with_z_off_the_in_projection(cuda, layout):
    """z a contiguous tensor, or a view one element off a 4-byte boundary
    (the element-wise staging), in bf16."""
    from repro_torch.kernels.selective_scan import (
        selective_scan_gated_bwd, selective_scan_gated_bwd_ref)
    from repro_torch.kernels.selective_scan.ops import _gated_forward_gpu
    args, g = _gated_inputs(cuda, 2, 131, 264, 16, torch.bfloat16, 9)
    wide = torch.randn((2, 131, 265), device=cuda).to(torch.bfloat16)
    z = args[7].contiguous() if layout == "contiguous" else wide[..., 1:]
    args = (*args[:7], z)
    y, y_pre = _gated_forward_gpu(*args, True)
    _gated_forward_close(args, y, y_pre)
    _gated_grads_close(selective_scan_gated_bwd(*args, y_pre, g),
                       selective_scan_gated_bwd_ref(*args, y_pre, g))


def test_gated_scan_autograd_through_the_in_projection(cuda):
    """`selective_scan_gated` on the in-projection's halves with gradients
    on: both gated kernels once, one ``mamba.gated_scan``, the gradient of
    z reaching the projection's second half, and without autograd no
    y_pre and the same y."""
    from repro_torch import tracing
    from repro_torch.kernels.selective_scan import (
        selective_scan_gated, selective_scan_gated_bwd_ref)
    from repro_torch.kernels.selective_scan.ops import _gated_forward_gpu
    args, g = _gated_inputs(cuda, 1, 300, 264, 16, torch.bfloat16, 3)
    xz = torch.randn((1, 300, 528), device=cuda).to(torch.bfloat16)
    leaves = [t.clone().requires_grad_() for t in (*args[:7], xz)]
    reset_kernel_launch_counts()
    tracing.clear()
    with tracing.recording():
        y = selective_scan_gated(*leaves[:7], leaves[7].chunk(2, dim=-1)[1])
    counted = sum(r.counts.get("mamba.gated_scan", 0)
                  for r in tracing.records())
    tracing.clear()
    (y.float() * g.float()).sum().backward()
    torch.cuda.synchronize()
    assert counted == 1
    assert kernel_launch_counts() == {"selective_scan": 1,
                                      "selective_scan_bwd": 1}
    z = xz[..., 264:]
    plain = (*args[:7], z)
    _, y_pre = _gated_forward_gpu(*plain, True)
    want = selective_scan_gated_bwd_ref(*plain, y_pre, g)
    grad_xz = leaves[7].grad
    _gated_grads_close([t.grad for t in leaves[:7]] + [grad_xz[..., 264:]],
                       want)
    assert not grad_xz[..., :264].any()
    with torch.no_grad():
        assert torch.equal(selective_scan_gated(*plain), y.detach())


def test_jamba_mamba_mixer_on_the_card_matches_the_cpu(cuda):
    """Jamba2-3B's Mamba mixer at its widths (d 2,560, d_inner 5,120,
    d_state 16, dt_rank 160) with its dt, B and C norms (scales away from
    1), float32, T 1,000: the card's path (the conv and the gated scan
    kernels, forward and backward) against the CPU's plain path from the
    same weights. The output within 1e-4 of its largest |value|, each
    leaf's gradient within 1e-3 of its largest |value| (`chip_smoke`'s
    card-against-CPU gradient check); one ``mamba.mixer_norms``, each
    kernel launched once. TF32 is off for the test alone."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        _jamba_mixer_card_against_cpu(cuda)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def _jamba_mixer_card_against_cpu(cuda):
    from repro_torch import tracing
    from repro_torch.nn.mamba import init_mamba, mamba_train
    gen = torch.Generator().manual_seed(37)
    kw = dict(d_inner=5120, d_state=16, d_conv=4, dt_rank=160)
    cpu = init_mamba(gen, 2560, 5120, 16, 4, 160, device="cpu",
                     mixer_norms=True)
    for name in ("dt_norm", "b_norm", "c_norm"):
        n = cpu[name]["scale"].shape
        cpu[name]["scale"] = 1 + 0.2 * torch.randn(n, generator=gen)
    x = torch.randn((1, 1000, 2560), generator=gen)
    gy = torch.randn((1, 1000, 2560), generator=gen)
    out = {}
    for dev in ("cpu", cuda):
        p = copy.deepcopy(cpu).to(dev).requires_grad_(True)
        reset_kernel_launch_counts()
        tracing.clear()
        with tracing.recording():
            y = mamba_train(p, x.to(dev), **kw)
        norms = sum(r.counts.get("mamba.mixer_norms", 0)
                    for r in tracing.records())
        tracing.clear()
        (y * gy.to(dev)).sum().backward()
        out[str(dev)] = (y.detach().cpu(), {k: v.grad.cpu() for k, v in
                                            p.named_parameters()}, norms)
    torch.cuda.synchronize()
    assert kernel_launch_counts() == {"causal_conv": 1, "causal_conv_bwd": 1,
                                      "selective_scan": 1,
                                      "selective_scan_bwd": 1}
    (y_cpu, g_cpu, n_cpu), (y_gpu, g_gpu, n_gpu) = out["cpu"], out[str(cuda)]
    assert n_cpu == n_gpu == 1
    assert float((y_gpu - y_cpu).abs().max()) <= \
        1e-4 * float(y_cpu.abs().max())
    assert g_gpu.keys() == g_cpu.keys() and {"dt_norm.scale", "b_norm.scale",
                                             "c_norm.scale"} <= g_cpu.keys()
    for k, want in g_cpu.items():
        assert float((g_gpu[k] - want).abs().max()) <= \
            1e-3 * float(want.abs().max()), k
