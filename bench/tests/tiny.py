"""Tiny sizes of the benchmark's cells, run on the CPU with the program's
plain versions, for the tests. The HTAP cells are listed here beside the
checkout's BENCHMARK.json: their configuration and traffic files are in
the benchmark, their cells are not (see PERF.md)."""

from __future__ import annotations

import copy
import time

import torch

from bench import harness

SEED = 2**31 + 1234

TRAIN_CONFIG = dict(hidden_size=64, intermediate_size=128, state_size=4,
                    time_step_rank=4, vocab_size=512, num_hidden_layers=2)
TRAIN_TRAFFIC = dict(seq_len=128, batch=2, initial_tokens=4096,
                     ingest_per_step=256, trace_seconds=0.3)
HTAP_CONFIG = dict(rows=20_000)
HTAP_TRAFFIC = {
    "micro-ana": dict(txns_per_round=512, queries_per_round=16,
                      trace_seconds=0.3),
    "micro-write": dict(txns_per_round=4096, queries_per_round=4,
                        trace_seconds=0.3),
}

HTAP_CELLS = [
    {"name": "micro-ana", "config": "polynesia-micro-1isl",
     "traffic": "micro-ana", "chips": 1},
    {"name": "micro-write", "config": "polynesia-micro-1isl",
     "traffic": "micro-write", "chips": 1},
]


def benchmark(root=harness.ROOT) -> dict:
    """The checkout's BENCHMARK.json with the HTAP cells added."""
    bench = copy.deepcopy(harness.load_benchmark(root))
    if not any(c["name"] == "polynesia-micro-1isl" for c in bench["configs"]):
        bench["configs"].append({
            "name": "polynesia-micro-1isl",
            "file": "bench/configs/polynesia-micro-1isl.json"})
    have = {w["name"] for w in bench["workloads"]}
    bench["workloads"] += [c for c in HTAP_CELLS if c["name"] not in have]
    return bench


def overrides(cell: str) -> tuple[dict, dict]:
    if cell in HTAP_TRAFFIC:
        return dict(HTAP_CONFIG), dict(HTAP_TRAFFIC[cell])
    return dict(TRAIN_CONFIG), dict(TRAIN_TRAFFIC)


def run(cell: str, seconds: float = 1.0, trace: bool = False, hooks=None,
        seed: int = SEED, bench: dict | None = None, root=harness.ROOT,
        traffic: dict | None = None):
    cfg, tr = overrides(cell)
    tr.update(traffic or {})
    return harness.run_cell(cell, seed, seconds, trace, time.perf_counter(),
                            device=torch.device("cpu"), hooks=hooks,
                            root=root, config_overrides=cfg,
                            traffic_overrides=tr,
                            bench=benchmark(root) if bench is None else bench)
