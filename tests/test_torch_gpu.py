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

from repro_torch.kernels.bitonic_sort import sort_rows, sort_rows_ref
from repro_torch.kernels.common import (kernel_launch_counts,
                                        reset_kernel_launch_counts)
from repro_torch.kernels.dict_ops import (scan_exact, scan_exact_group,
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
from repro_torch.kernels.selective_scan import (selective_scan,
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
    and across tiles merged by the rank merge."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn((rows, width), generator=gen, device=cuda) * 1e6
    x[:, 0], x[:, 1], x[:, 2] = float("nan"), float("inf"), -0.0
    x[:, -1] = float("-inf")
    got = sort_rows(x)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, sort_rows_ref(x), rtol=0, atol=0,
                               equal_nan=True)


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
                                   (5000, 4999, 5000, 5000), (777,)])
@pytest.mark.parametrize("join", [False, True])
def test_mesh_scan_kernel_matches_its_plain_version(cuda, sizes, join):
    """Four (or fewer) islands on the one card, as chip_smoke's mesh phase
    runs them: one launch per non-empty island, partials added on island
    0's device; equal to the plain version and to the flat scan."""
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
    name = "scan_exact_join" if join else "scan_exact"
    assert kernel_launch_counts() == {name: sum(1 for s in sizes if s)}
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


@pytest.mark.parametrize("name", ["gemma2-9b", "falcon-mamba-7b",
                                  "qwen2.5-14b"])
def test_lm_decode_matches_prefill_on_the_card(cuda, name):
    """A smoke-size model with head_dim 64 (the decode kernel takes 64, 128
    and 256): token-by-token decode (the decode-attention kernel, or the
    plain Mamba step) against the parallel prefill (plain attention, or
    the scan kernel), 2e-3 as the reference's own test; float32."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.models.lm import (init_lm, init_lm_cache, lm_apply,
                                       lm_decode_step)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_smoke_config(name), head_dim=64)
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
