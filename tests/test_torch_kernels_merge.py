"""The port's merge-unit entries vs the JAX package's (tolerance 0)."""

import numpy as np
import pytest
import torch

from repro.kernels import common as ref_common
from repro.kernels.merge_runs import (merge_sorted_pair as ref_pair,
                                      merge_sorted_pairs as ref_pairs,
                                      merge_sorted_runs as ref_runs)
from repro_torch.kernels.common import (kernel_launch_counts,
                                        kernel_launch_shapes,
                                        reset_kernel_launch_counts)
from repro_torch.kernels.merge_runs import ops as merge_ops
from repro_torch.kernels.merge_runs import (merge_pair_ref, merge_runs_ref,
                                            merge_sorted_pair,
                                            merge_sorted_pairs,
                                            merge_sorted_runs)

torch.set_num_threads(1)
T = torch.from_numpy
I64_MAX = np.iinfo(np.int64).max


@pytest.fixture
def interpret_mode():
    yield ref_common.set_interpret_override
    ref_common.set_interpret_override(None)


def _check_runs(runs):
    keys, idx = merge_sorted_runs(runs)
    rk, ri = ref_runs(runs)
    np.testing.assert_array_equal(keys.numpy(), np.asarray(rk))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ri))
    assert keys.dtype == torch.int64 and idx.dtype == torch.int32
    cat = np.concatenate([np.asarray(r, np.int64).reshape(-1) for r in runs])
    np.testing.assert_array_equal(cat[idx.numpy()], keys.numpy())


@pytest.mark.parametrize("k,length", [(1, 10), (2, 128), (4, 100), (8, 333),
                                      (3, 50), (5, 1)])
def test_merge_runs_sweep(rng, k, length):
    _check_runs([np.sort(rng.integers(0, 10**6, size=length).astype(np.int32))
                 for _ in range(k)])


@pytest.mark.parametrize("span", [(0, 1 << 20),                  # int32 range
                                  (1 << 31, 1 << 40),            # > 2^31
                                  (-(1 << 40), 1 << 40)])        # negative too
def test_merge_runs_int64_keys(rng, span):
    lo, hi = span
    keys = np.unique(rng.integers(lo, hi, size=512, dtype=np.int64))
    rng.shuffle(keys)
    _check_runs([np.sort(keys[t::3]) for t in range(3)])


@pytest.mark.parametrize("runs", [
    [[5, I64_MAX], [7]],                       # a real int64.max key
    [[I64_MAX], [I64_MAX, I64_MAX]],
    [[], [1, 2, 3]],                           # an empty run
    [[], []],
    [[4, 4, 4], [4, 4], [4]],                  # ties across runs: stable
    [[np.iinfo(np.int64).min, 0], [-1, 1]],
], ids=["max_key", "only_max", "empty_side", "all_empty", "ties", "min_key"])
def test_merge_runs_edge_keys(runs):
    _check_runs([np.asarray(r, dtype=np.int64) for r in runs])


def test_merge_runs_of_tensors_and_of_nothing(rng):
    runs = [np.sort(rng.integers(0, 99, size=s)) for s in (7, 0, 12)]
    keys, idx = merge_sorted_runs([T(r) for r in runs])
    rk, ri = ref_runs(runs)
    np.testing.assert_array_equal(keys.numpy(), np.asarray(rk))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ri))
    keys, idx = merge_sorted_runs([])
    assert keys.shape == (0,) and idx.shape == (0,)
    k2, i2 = merge_runs_ref([T(runs[0]), T(runs[2])])
    assert torch.equal(k2, torch.sort(torch.cat([T(runs[0]), T(runs[2])])).values)


@pytest.mark.parametrize("rows,wa,wb", [(1, 1, 1), (3, 24, 17), (8, 128, 128),
                                        (2, 300, 5)])
def test_merge_pair_matches_reference(rng, rows, wa, wb):
    a = np.sort(rng.integers(-10**12, 10**12, size=(rows, wa)), axis=1)
    b = np.sort(rng.integers(-10**12, 10**12, size=(rows, wb)), axis=1)
    ai = np.tile(np.arange(wa, dtype=np.int32), (rows, 1))
    bi = np.tile(np.arange(wb, dtype=np.int32) + wa, (rows, 1))
    keys, idx = merge_sorted_pair(T(a), T(b), T(ai), T(bi))
    rk, ri = ref_pair(a, b, ai, bi)
    # keys are unique with overwhelming probability: order is pinned
    np.testing.assert_array_equal(keys.numpy(), np.asarray(rk))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ri))
    pk, pi = merge_pair_ref(T(a), T(b), T(ai), T(bi))
    assert torch.equal(pk, keys) and torch.equal(pi, idx)


@pytest.mark.parametrize("sizes", [[(24, 17)] * 3, [(5, 0), (0, 9), (3, 3)],
                                   [(1, 1)], [(200, 130), (7, 300)]])
def test_merge_pairs_matches_reference(rng, sizes):
    a_list = [np.sort(rng.integers(0, 1000, size=na).astype(np.int64))
              for na, _ in sizes]
    b_list = [np.sort(rng.integers(0, 1000, size=nb).astype(np.int64))
              for _, nb in sizes]
    got = merge_sorted_pairs(a_list, b_list)
    want = ref_pairs(a_list, b_list)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_merge_pairs_with_the_max_key_and_with_no_pairs():
    a_list = [np.array([1, I64_MAX], dtype=np.int64), np.array([2], np.int64)]
    b_list = [np.array([0], dtype=np.int64), np.array([I64_MAX], np.int64)]
    got = merge_sorted_pairs(a_list, b_list)
    for g, w in zip(got, ref_pairs(a_list, b_list)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert merge_sorted_pairs([], []) == []


def test_merge_vs_pallas_interpret_kernel(interpret_mode):
    """Against the reference's Pallas comparator network itself (interpret
    mode); keys are unique, so the (key, source) order is pinned."""
    rng = np.random.default_rng(7)
    keys = rng.permutation(np.arange(10**6, 10**6 + 168, dtype=np.int64))
    runs = [np.sort(keys[:40]), np.sort(keys[40:88]), np.sort(keys[88:])]
    interpret_mode("1")
    rk, ri = ref_runs(runs)
    interpret_mode(None)
    got_k, got_i = merge_sorted_runs(runs)
    np.testing.assert_array_equal(got_k.numpy(), np.asarray(rk))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(ri))


# ---------------------------------------------------------------------------
# The GPU branch of `merge_sorted_runs` rehearsed on the CPU: the device rule
# patched to take it, and the bare k-way launch replaced by a plain-torch
# evaluation of the kernel's slot formula.
# ---------------------------------------------------------------------------

def slot_formula_launch(keys, offsets, out_keys, out_idx):
    """Entry i of run r goes to slot i + sum over s < r of
    upper_bound(run_s, key) + sum over s > r of lower_bound(run_s, key),
    carrying its position in `keys` (what csrc/merge_runs.cu computes)."""
    offs = list(offsets)
    k = len(offs) - 1
    slots = []
    for r in range(k):
        run = keys[offs[r]:offs[r + 1]]
        pos = torch.arange(run.shape[0], dtype=torch.int64)
        for s in range(k):
            if s != r:
                pos += torch.searchsorted(keys[offs[s]:offs[s + 1]], run,
                                          right=s < r)
        out_keys[pos] = run
        out_idx[pos] = torch.arange(offs[r], offs[r + 1], dtype=torch.int32)
        slots.append(pos)
    # every slot written exactly once
    assert torch.equal(torch.sort(torch.cat(slots)).values,
                       torch.arange(offs[-1]))


@pytest.fixture
def gpu_branch(monkeypatch):
    monkeypatch.setattr(merge_ops, "on_gpu", lambda *tensors: True)
    monkeypatch.setattr(merge_ops, "launch_merge_kway", slot_formula_launch)
    reset_kernel_launch_counts()
    yield
    reset_kernel_launch_counts()


def _tie_runs(rng, k):
    """k ascending int64 runs: empty ones, one-entry ones, keys drawn from
    a narrow range (ties within and across runs), int64.max and int64.min."""
    runs = []
    for r in range(k):
        size = (0, 1, int(rng.integers(2, 300)))[r % 3]
        run = rng.integers(-40, 40, size=size).astype(np.int64)
        if size > 1:
            run[-1] = I64_MAX
            run[0] = np.iinfo(np.int64).min if r % 2 else run[0]
        runs.append(np.sort(run))
    return runs


@pytest.mark.parametrize("k", [1, 2, 3, 4, 7, 8])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merge_runs_gpu_branch_is_one_launch_and_the_reference(gpu_branch, k,
                                                               seed):
    runs = _tie_runs(np.random.default_rng(seed), k)
    keys, idx = merge_sorted_runs([T(r) for r in runs])
    rk, ri = ref_runs(runs)
    np.testing.assert_array_equal(keys.numpy(), np.asarray(rk))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ri))
    assert keys.dtype == torch.int64 and idx.dtype == torch.int32
    n = sum(len(r) for r in runs)
    want = {"merge_runs": 1} if k > 1 and n else {}
    assert kernel_launch_counts() == want
    if want:
        assert kernel_launch_shapes() == {"merge_runs": {(k, n): 1}}


def test_merge_runs_gpu_branch_ship_batch_of_commit_ids(gpu_branch, rng):
    """A ship batch: four thread logs of about 256 distinct commit ids beyond
    2^31 - one launch, as the reference's merge."""
    ids = rng.permutation(np.arange(2**33, 2**33 + 1024, dtype=np.int64))
    runs = [np.sort(ids[t::4]) for t in range(4)]
    keys, idx = merge_sorted_runs(runs)
    rk, ri = ref_runs(runs)
    np.testing.assert_array_equal(keys.numpy(), np.asarray(rk))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ri))
    assert kernel_launch_counts() == {"merge_runs": 1}


def test_merge_runs_gpu_branch_beyond_one_launch(gpu_branch):
    """More runs than one launch takes: groups of MAX_RUNS, a launch each,
    then one over the groups' results."""
    k = merge_ops.MAX_RUNS + 6
    runs = _tie_runs(np.random.default_rng(5), k)
    keys, idx = merge_sorted_runs(runs)
    rk, ri = ref_runs(runs)
    np.testing.assert_array_equal(keys.numpy(), np.asarray(rk))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ri))
    assert kernel_launch_counts() == {"merge_runs": 3}


def test_run_offsets():
    assert list(merge_ops.run_offsets([3, 0, 5])) == [0, 3, 3, 8]
    assert list(merge_ops.run_offsets([])) == [0]
