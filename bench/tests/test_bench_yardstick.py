"""The benchmark's own byte, operation and flop counts on hand-worked
shapes, and the reduction of a device trace."""

from __future__ import annotations

import json
import types

import pytest

from bench import harness, yardstick
from bench.trace import Trace


def test_scan_cost_plain():
    # n 10, k 4, nq 2: codes, codes, validity (9 B a row), the dictionary,
    # the bounds, two int64 lanes a predicate
    assert yardstick.scan_cost((10, 4, 2)) == (
        10 * 9 + 4 * 4 + 2 * 8 + 2 * 2 * 8, 10 * (2 * 2 + 2))


def test_scan_cost_join():
    # join lane: join codes and validity (5 B a row), the join counts
    assert yardstick.scan_cost((10, 4, 3, 2)) == (
        10 * 9 + 4 * 4 + 2 * 8 + 3 * 2 * 8 + 10 * 5 + 3 * 4,
        10 * (2 * 2 + 2) * 2)


def test_ssm_costs():
    assert yardstick.ssm_cost((1, 2, 3, 4)) == (
        12 * 6 + 8 * 2 * 4 + 4 * 3 * 5, 6 * (7 * 4 + 3))
    assert yardstick.ssm_bwd_cost((1, 2, 3, 4)) == (
        20 * 6 + 16 * 2 * 4 + 8 * 3 * 5, 6 * (24 * 4 + 4))


def test_ssm_bound_picks_the_larger():
    shape = (1, 4096, 8192, 16)
    # 132 SMs at 1.98 GHz: 16 x 132 x 1.98e9 exponentials a second
    sfu = 4096 * 8192 * 16 / (16 * 132 * 1.98e9)
    nbytes = yardstick.ssm_cost(shape)[0] / yardstick.HBM_BYTES_PER_S
    assert sfu > nbytes
    assert yardstick.ssm_bound_s(shape, False, 132, 1.98e9) == (
        pytest.approx(sfu), "sfu")
    # the backward takes the same exponentials, and its bytes bind
    bwd = yardstick.ssm_bwd_cost(shape)[0] / yardstick.HBM_BYTES_PER_S
    assert bwd == pytest.approx((20 * 4096 * 8192 + 16 * 4096 * 16
                                 + 8 * 8192 * 17) / 3.35e12)
    assert bwd > sfu
    assert yardstick.ssm_bound_s(shape, True, 132, 1.98e9) == (
        pytest.approx(bwd), "bytes")
    # a card with a thousand times the SFUs is bound by its bytes
    assert yardstick.ssm_bound_s(shape, False, 132000, 1.98e9)[1] == "bytes"


def test_mamba_flops_at_the_cell():
    cfg = json.loads((harness.ROOT / "bench/configs/"
                      "falcon-mamba-7b-train-16l.json").read_text())
    layer = 4096 * 16384 + 8192 * (256 + 32) + 256 * 8192 + 8192 * 4096
    params = 16 * layer + 4096 * 65024
    assert yardstick.mamba_matmul_params(cfg) == params == 1_948_254_208
    tokens = 8192
    scan = tokens * 8192 * (7 * 16 + 3) + tokens * 8192 * (24 * 16 + 4)
    conv = 3 * 2 * 4 * 8192 * tokens
    assert yardstick.mamba_train_flops(cfg, tokens) == \
        6 * params * tokens + 16 * (scan + conv)


def _trace():
    # two kernels, a gap of 2 us held by "propagate", then 1 us by "step"
    ops = [("scan_exact_kernel<1>", 0, 4000), ("gemm", 6000, 7000),
           ("selective_scan_kernel<16>", 8000, 9000)]
    ranges = [("step", 0, 10000), ("propagate", 3500, 6500)]
    return Trace(ops, ranges, window_s=1e-5,
                 launch_shapes={"scan_exact": {(1000, 32, 1): 2}})


def test_trace_busy_gaps_and_top():
    t = _trace()
    assert t.busy_s == pytest.approx(6e-6)
    assert t.idle_gaps() == [["propagate", pytest.approx(2e-6)],
                             ["step", pytest.approx(1e-6)]]
    assert t.top_ops()[0] == ["scan_exact_kernel<1>", pytest.approx(4e-6)]


def test_readers_on_a_synthetic_trace():
    run = types.SimpleNamespace(trace=_trace(), extra={}, cell=None)
    idle = harness.load_module(harness.ROOT / "bench/metrics/idle_share.train.py",
                               "idle")
    assert idle.read(run) == pytest.approx(40.0)
    roof = harness.load_module(harness.ROOT / "bench/metrics/scan_roofline.ana.py",
                               "roof")
    bound = 2 * yardstick.scan_bound_s((1000, 32, 1))
    assert roof.read(run) == pytest.approx(100 * bound / 4e-6)
    ssm = harness.load_module(harness.ROOT / "bench/metrics/ssm_roofline.train.py",
                              "ssm")
    assert ssm.read(run) is None      # no clock read: nothing to report


def test_a_reader_with_nothing_to_read_returns_none():
    run = types.SimpleNamespace(trace=None, extra={}, cell=None,
                                spans=types.SimpleNamespace(
                                    median_ms=lambda k: None))
    for name in ("idle_share.train", "ssm_roofline.train",
                 "pipeline_ms.train", "scan_roofline.ana", "flush_ms.ana"):
        mod = harness.load_module(harness.ROOT / f"bench/metrics/{name}.py",
                                  "m")
        assert mod.read(run) is None, name
