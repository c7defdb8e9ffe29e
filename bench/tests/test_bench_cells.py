"""Each cell's traffic at a tiny size on the CPU (the port with
device="cpu") agrees with the benchmark's reference, and a run's result
line has the keys the contract names, the checks last."""

from __future__ import annotations

import pytest

from bench import harness
from bench.tests import tiny

CELLS = ["fm7b-train", "micro-ana", "micro-write"]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_agrees_with_the_reference(cell):
    run = tiny.run(cell, seconds=1.0)
    assert run.correct, [(c.name, c.value, c.limit) for c in run.checks]
    assert run.window_s >= 1.0 and run.setup_s > 0
    assert run.attempted > 0 and run.failed == 0


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reads_its_spans(cell):
    run = tiny.run(cell, seconds=1.5, trace=True)
    assert run.correct
    key = {"fm7b-train": "pipeline", "micro-ana": "flush_updates",
           "micro-write": "execute"}[cell]
    assert run.spans.median_ms(key) > 0
    assert run.trace is not None and run.trace.window_s > 0


def test_result_line_keys_and_order():
    bench = tiny.benchmark()
    run = tiny.run("fm7b-train", seconds=0.5, bench=bench)
    line = harness.result_line(bench, run, traced=False)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert set(line["metrics"]) == {"train_tokens_per_s", "setup_s"}
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    assert line["device"]["memory_peak_bytes"] == 0     # the CPU has no card


def test_main_refuses_without_a_card(monkeypatch, capsys):
    import torch
    for var in ("TORCH_EXTENSIONS_DIR", "TRITON_CACHE_DIR", "USE_FLAX",
                "USE_JAX"):
        monkeypatch.setenv(var, "unset")      # restored after the test
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = harness.main(["--workload", "fm7b-train", "--seed", "1",
                       "--seconds", "1"], 0.0)
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""
