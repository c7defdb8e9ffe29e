"""Kernel checks that need the card: each CUDA kernel of the islands and
delta-store slices against its plain PyTorch version on CUDA tensors,
tolerance 0.

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
                                          scan_exact_ref, scan_values_exact,
                                          scan_values_exact_ref)
from repro_torch.kernels.hash_probe import (EMPTY, build_table, probe,
                                            probe_ref, probe_sharded)

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
