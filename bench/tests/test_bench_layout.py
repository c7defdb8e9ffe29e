"""The harness finds every configuration, cell and metric by name, and
picks up a new cell from new files alone."""

from __future__ import annotations

import json
import pathlib
import shutil

import pytest

from bench import harness
from bench.tests import tiny

ROOT = harness.ROOT


def test_every_cell_resolves_to_its_files():
    bench = tiny.benchmark()
    for wl in bench["workloads"]:
        _, config, traffic = harness.load_cell(bench, wl["name"])
        assert (ROOT / "bench" / "drivers" / f"{config['driver']}.py").exists()
        assert (ROOT / "bench" / "reference" / f"{config['reference']}.py").exists()
        assert harness.driver_of(config).run
        assert traffic


def test_every_metric_has_a_reader():
    bench = harness.load_benchmark()
    for m in bench["end_to_end"] + bench["per_layer"]:
        mod = harness.load_module(ROOT / "bench" / "metrics" / f"{m['name']}.py",
                                  "probe")
        assert callable(mod.read), m["name"]


@pytest.mark.parametrize("traced", [False, True])
def test_metrics_of_a_cell(traced):
    """Untraced: the end-to-end metrics that list the cell or list none;
    traced: the per-layer metrics that list it, each moving one of those."""
    bench = harness.load_benchmark()
    for wl in bench["workloads"]:
        cell = wl["name"]
        e2e = {m["name"] for m in bench["end_to_end"]
               if cell in m.get("workloads", [cell])}
        got = {m["name"] for m in harness.metrics_of(bench, cell, traced)}
        if not traced:
            assert got == e2e and "setup_s" in got and len(got) >= 2
        else:
            assert got
            assert all(m["moves"] in e2e for m in bench["per_layer"]
                       if m["name"] in got)


def test_benchmark_json_keeps_to_the_contract():
    bench = harness.load_benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "bench/run.py"]
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    for m in bench["per_layer"]:
        assert set(m["workloads"]) <= cells
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}
    for c in bench["configs"]:
        assert (ROOT / c["file"]).exists()


def _copy_checkout(tmp_path: pathlib.Path) -> pathlib.Path:
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "bench", root / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    return root


def test_a_new_training_cell_from_a_new_file_alone(tmp_path):
    root = _copy_checkout(tmp_path)
    traffic = json.loads((root / "bench/traffic/fm7b-train.json").read_text())
    traffic["seq_len"] = 64
    (root / "bench/traffic/fm7b-train-short.json").write_text(
        json.dumps(traffic))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "fm7b-train-short",
                               "config": "falcon-mamba-7b-train-16l",
                               "traffic": "fm7b-train-short", "chips": 1,
                               "why": "shorter sequences"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    bench = tiny.benchmark(root)
    wl, _, tr = harness.load_cell(bench, "fm7b-train-short", root)
    assert tr["seq_len"] == 64
    run = harness.run_cell(
        "fm7b-train-short", tiny.SEED, 0.5, False, 0.0, device="cpu",
        root=root, config_overrides=tiny.TRAIN_CONFIG,
        traffic_overrides={k: v for k, v in tiny.TRAIN_TRAFFIC.items()
                           if k != "seq_len"}, bench=bench)
    assert run.correct
    assert run.counts["tokens_per_step"] == 2 * 64


def test_a_new_htap_cell_from_a_new_file_alone(tmp_path):
    root = _copy_checkout(tmp_path)
    traffic = json.loads((root / "bench/traffic/micro-ana.json").read_text())
    traffic["write_ratio"] = 0.8
    (root / "bench/traffic/micro-ana-80.json").write_text(json.dumps(traffic))
    bench = tiny.benchmark(root)
    bench["workloads"].append({"name": "micro-ana-80",
                               "config": "polynesia-micro-1isl",
                               "traffic": "micro-ana-80", "chips": 1})
    _, _, tr = harness.load_cell(bench, "micro-ana-80", root)
    assert tr["write_ratio"] == 0.8
    run = harness.run_cell(
        "micro-ana-80", tiny.SEED, 0.5, False, 0.0, device="cpu", root=root,
        config_overrides=tiny.HTAP_CONFIG,
        traffic_overrides=tiny.HTAP_TRAFFIC["micro-ana"], bench=bench)
    assert run.correct and run.counts["rounds"] >= 1
