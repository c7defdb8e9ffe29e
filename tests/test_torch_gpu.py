"""Kernel checks that need the card: each CUDA kernel against its plain
PyTorch version on CUDA tensors - the HTAP kernels with tolerance 0, the
LM serving kernels (flash-decode attention, selective scan) at the float32
tolerances of the reference's kernel tests (2e-5, 3e-5; a bf16 output one
bf16 rounding more, 2**-8 relative), the float32 scan with an exact count
and its sum within ``float_scan_error_bound`` of the exact sum and 1e-5 *
sum(|v|) of the plain version's.

Marked ``gpu``; every test skips when no GPU is present (decided when the
test runs, never at import). This file imports nothing of the JAX package,
so it runs where only the port is installed:

    python -m pytest -q -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.bitonic_sort import (apply_pipeline_batch,
                                              apply_pipeline_batch_ref,
                                              sort_rows, sort_rows_ref)
from repro_torch.kernels.common import (kernel_launch_counts,
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
from repro_torch.kernels.selective_scan import (launch_selective_scan,
                                                selective_scan,
                                                selective_scan_ref)

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


@pytest.mark.parametrize("nr", [0, 1, 3, 4097])
@pytest.mark.parametrize("rows,nq", [(3, 1), (6, 3), (6, 9)])
def test_values_lane_kernel_matches_its_plain_version(cuda, nr, rows, nq):
    """The correction lane alone: the raw-value scan (3-row stack) and the
    values delta (6 rows); 9 predicates take two slices."""
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
    if cfg.n_layers - n_mamba:
        want_counts["decode_attn"] = (cfg.n_layers - n_mamba) * 12
    assert kernel_launch_counts() == want_counts
