"""Runs one cell of `BENCHMARK.json` once and prints its result line.

Everything that belongs to one configuration, traffic mix or metric is
found by name:

- the cell's entry in ``workloads`` names its configuration and traffic;
- the configuration's entry gives its file (``bench/configs/<name>.json``),
  which names the driver that runs it (``bench/drivers/<driver>.py``) and
  the plain reference that judges it (``bench/reference/<ref>.py``);
- the traffic is ``bench/traffic/<traffic>.json``, parameters that the
  driver's generator reads;
- each metric, end-to-end or per-layer, is read by
  ``bench/metrics/<metric name>.py``, whose ``read(run)`` returns a number
  or None where it finds nothing to read.

A driver's ``run(cell)`` does the set-up, the measured window, the read
of the peak memory and then the reference's check, and returns a
`Measured`.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os
import pathlib
import sys

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Cell:
    """What a driver is given: the cell's names, its configuration and
    traffic as loaded from their files, the run's arguments, and the
    device."""

    name: str
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    chips: int
    seed: int
    seconds: float
    trace: bool
    device: object            # torch.device
    t_start: float            # perf_counter at process start
    hooks: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Check:
    """One number compared with its limit; it passes at or under it."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


@dataclasses.dataclass
class Measured:
    """A driver's run: host-clock readings of the window, the harness's
    spans, the device trace (traced runs), the peak device memory, and
    the reference's checks."""

    setup_s: float
    window_s: float
    counts: dict                      # work done in the window, by kind
    latencies_s: dict                 # per request kind, every request
    spans: object                     # trace.Spans
    trace: object                     # trace.Trace or None
    memory_peak_bytes: int
    checks: list
    attempted: int
    failed: int
    extra: dict = dataclasses.field(default_factory=dict)
    cell: Cell | None = None

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(c.ok for c in self.checks)


def load_benchmark(root: pathlib.Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _entry(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def load_cell(bench: dict, name: str, root: pathlib.Path = ROOT):
    """(workload entry, configuration file's dict, traffic dict)."""
    wl = _entry(bench["workloads"], name, "workload")
    cfg_entry = _entry(bench["configs"], wl["config"], "configuration")
    with open(root / cfg_entry["file"]) as f:
        config = json.load(f)
    with open(root / "bench" / "traffic" / f"{wl['traffic']}.json") as f:
        traffic = json.load(f)
    return wl, config, traffic


def metrics_of(bench: dict, cell: str, traced: bool) -> list[dict]:
    """The metrics a run of `cell` reports: the end-to-end metrics whose
    ``workloads`` list it (or that have none) untraced; traced, the
    per-layer metrics whose ``workloads`` list it or, without the key,
    whose ``moves`` metric the cell reports."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not traced:
        return e2e
    reported = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in reported)]


def load_module(path: pathlib.Path, name: str):
    """A module from a file whose name need not be an identifier."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_metric(name: str, run: Measured, root: pathlib.Path = ROOT):
    mod = load_module(root / "bench" / "metrics" / f"{name}.py",
                      f"bench_metric_{name.replace('.', '_')}")
    return mod.read(run)


def driver_of(config: dict):
    return importlib.import_module(f"bench.drivers.{config['driver']}")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole: ``repro_torch`` is not ``repro``."""
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def result_line(bench: dict, run: Measured, traced: bool,
                root: pathlib.Path = ROOT) -> dict:
    metrics = {}
    for m in metrics_of(bench, run.cell.name, traced):
        value = read_metric(m["name"], run, root)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    device = dict(run.extra.get("device", {}))
    device["memory_peak_bytes"] = int(run.memory_peak_bytes)
    line = {"correct": run.correct, "attempted": int(run.attempted),
            "failed": int(run.failed), "metrics": metrics, "device": device}
    if traced and run.trace is not None:
        device["busy_s"] = run.trace.busy_s
        device["window_s"] = run.trace.window_s
        line["breakdown"] = run.trace.breakdown()
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                      for c in run.checks}
    return line


def run_cell(name: str, seed: int, seconds: float, trace: bool, t_start: float,
             device=None, hooks: dict | None = None,
             root: pathlib.Path = ROOT, config_overrides: dict | None = None,
             traffic_overrides: dict | None = None,
             bench: dict | None = None) -> Measured:
    """Set up and run one cell of `bench` (None: the checkout's
    BENCHMARK.json); `device` None means the first card. `hooks` and the
    overrides are for the tests: they plant faults and shrink the sizes."""
    import torch
    bench = load_benchmark(root) if bench is None else bench
    wl, config, traffic = load_cell(bench, name, root)
    config.update(config_overrides or {})
    traffic.update(traffic_overrides or {})
    if device is None:
        device = torch.device("cuda", 0)
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.zeros(1, device=device)    # the allocator exists from here
    cell = Cell(name=name, config_name=wl["config"], config=config,
                traffic_name=wl["traffic"], traffic=traffic,
                chips=int(wl["chips"]), seed=int(seed), seconds=float(seconds),
                trace=bool(trace), device=torch.device(device),
                t_start=t_start, hooks=dict(hooks or {}))
    run = driver_of(config).run(cell)
    run.cell = cell
    return run


def card_fields(chips: int) -> dict:
    import torch
    from bench import yardstick
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "power_limit_w": yardstick.power_limit_w()}


def main(argv: list[str], t_start: float) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # every cache a run makes stays in the checkout, at a fixed path
    build = ROOT / "build"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(build / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    os.environ["USE_FLAX"] = "0"     # a library that would load JAX by itself
    bench = load_benchmark()
    wl = _entry(bench["workloads"], args.workload, "workload")
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(wl["chips"]):
        print(f"bench: the cell needs {wl['chips']} CUDA device(s); "
              f"available: {torch.cuda.is_available()}, count "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    run = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                   t_start)
    run.extra["device"] = card_fields(run.cell.chips)
    found = forbidden_modules()
    if found:
        print(f"bench: the process loaded {found} (JAX or the JAX package); "
              "no result", file=sys.stderr)
        return 4
    line = result_line(bench, run, bool(args.trace))
    for name, value in run.extra.get("readings", {}).items():
        print(f"reading {name} {value!r} (not compared)", file=sys.stderr)
    for c in run.checks:
        print(f"check {c.name} {c.value!r} limit {c.limit!r} "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(line), flush=True)
    return 0
