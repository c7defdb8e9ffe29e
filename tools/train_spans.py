#!/usr/bin/env python3
"""The program's spans in the benchmark's training cell, on a card.

    python3 tools/train_spans.py report --seed 7 [--steps 5]
    python3 tools/train_spans.py cost --seed 7 --recording 1

``report`` builds the cell's training object (`bench/drivers/lm_train.py`
at the cell's own sizes) and, after three warm steps, runs

- `--steps` steps under `repro_torch.tracing.recording()` with no
  profiler: each span's host ms and, for the spans that time their stream
  between two CUDA events, its stream ms (medians a step);
- `--steps` steps under `torch.profiler` (the harness's ranges on): the
  same spans' host ms there; the idle split by harness range and program
  span (`bench/program_trace.py`), the share of the idle under the
  harness's `train_step` and `propagate` that a program span holds, and
  the ten device operations that took most time, each with the share of
  its device seconds launched under each program span (a kernel goes to
  the innermost span open, on any thread, when its launch was issued).

``cost`` runs the cell once, untraced, through `bench/run.py`'s own entry
point, with `recording()` on or off for the whole run, and prints the
benchmark's result line.

``report`` prints one JSON line and writes it to
``chiprun_out/train_spans_report_<seed>.json``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import statistics
import sys
import time
import types

T_START = time.perf_counter()
ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

CELL = "fm7b-train"


def _medians(records, key) -> dict:
    by: dict = {}
    for r in records:
        v = key(r)
        if v is not None:
            by.setdefault(r.name, []).append(v)
    return {k: statistics.median(v) for k, v in sorted(by.items())}


def _host_ms(r):
    return (r.end_ns - r.start_ns) / 1e6


def _launch_owners(prof, records):
    """(device op name, device ns, owner span name) for each device
    operation of the profile whose launch the profile links to it."""
    from bench import program_trace
    from bench.trace import _on_device
    events = prof.profiler.kineto_results.events()
    launches = {}
    for e in events:
        if (str(e.device_type()).endswith("CPU") and e.name().startswith("cu")
                and e.correlation_id()):
            launches[e.correlation_id()] = e.start_ns()
    ops, linked = [], []
    for e in events:
        if not _on_device(e):
            continue
        t = launches.get(e.correlation_id()) or \
            launches.get(e.linked_correlation_id())
        ops.append((e.name(), e.end_ns() - e.start_ns()))
        linked.append(t)
    got = program_trace.owners(records, [t or 0 for t in linked])
    return [(n, ns, (o.name if o is not None else "-") if t else "unlinked")
            for (n, ns), t, o in zip(ops, linked, got)]


def report(seed: int, n_steps: int) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from bench import harness, program_trace
    from bench.drivers import lm_train
    from bench.trace import RANGES, Trace, Spans, _on_device
    from repro_torch import tracing
    if not torch.cuda.is_available():
        raise SystemExit("train_spans: needs a CUDA device")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    bench = harness.load_benchmark()
    wl, config, traffic = harness.load_cell(bench, CELL)
    cell = harness.Cell(name=CELL, config_name=wl["config"], config=config,
                        traffic_name=wl["traffic"], traffic=traffic, chips=1,
                        seed=seed, seconds=0.0, trace=False, device=dev,
                        t_start=T_START)
    prog = lm_train.Program(cell, Spans(dev, traced=False))
    s = 0
    for _ in range(3):
        prog.step(s)
        s += 1
    torch.cuda.synchronize(dev)

    tracing.clear()
    with tracing.recording():
        for _ in range(n_steps):
            prog.step(s)
            s += 1
    torch.cuda.synchronize(dev)
    quiet = tracing.records()
    out = {"cell": CELL, "seed": seed, "steps": n_steps,
           "device": torch.cuda.get_device_name(dev),
           "recording": {"host_ms": _medians(quiet, _host_ms),
                         "stream_ms": _medians(quiet,
                                               lambda r: r.device_ms)}}

    tracing.clear()
    prog.spans = Spans(dev, traced=True)
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n_steps):
            with prog.spans.range("step"):
                prog.step(s)
            s += 1
        torch.cuda.synchronize(dev)
    window_s = time.perf_counter() - t0
    traced = tracing.records()
    events = prof.profiler.kineto_results.events()
    ops = [(e.name(), e.start_ns(), e.end_ns()) for e in events
           if _on_device(e)]
    ranges = [(e.name(), e.start_ns(), e.end_ns()) for e in events
              if e.is_user_annotation() and e.name() in RANGES
              and str(e.device_type()).endswith("CPU")]
    trace = Trace(ops, ranges, window_s, {})

    run = types.SimpleNamespace(trace=trace, extra={})
    split = program_trace.idle_split(run) or {}
    held = {lab: sum(v for k, v in by.items() if k != "-")
            for lab, by in split.items()}
    total = {lab: sum(by.values()) for lab, by in split.items()}
    both = ("train_step", "propagate")
    covered = sum(held.get(k, 0) for k in both)
    whole = sum(total.get(k, 0) for k in both)

    owned = _launch_owners(prof, traced)
    by_op: dict = {}
    for name, ns, owner in owned:
        d = by_op.setdefault(name, {})
        d[owner] = d.get(owner, 0) + ns
    top = sorted(by_op.items(), key=lambda kv: -sum(kv[1].values()))[:10]
    out["traced"] = {
        "window_s": window_s, "busy_s": trace.busy_s,
        "idle_share": 100 * (1 - trace.busy_s / window_s),
        "host_ms": _medians(traced, _host_ms),
        "stream_ms": _medians(traced, lambda r: r.device_ms),
        "idle_by_span": split,
        "span_coverage_of_train_step_and_propagate":
            covered / whole if whole else None,
        "propagate_idle_ms": program_trace.idle_ms_per_step(
            run, "pipeline.propagate"),
        "optimizer_idle_ms": program_trace.idle_ms_per_step(
            run, "train.optimizer"),
        "ops_linked": sum(o != "unlinked" for _, _, o in owned) / max(
            len(owned), 1),
        "top_ops": [{"name": n[:100], "s": sum(d.values()) / 1e9,
                     "by_span": {k: v / sum(d.values())
                                 for k, v in sorted(d.items(),
                                                    key=lambda kv: -kv[1])}}
                    for n, d in top],
        "counts": program_trace.counts(program_trace.in_stretch(
            trace, traced)),
    }
    return out


def cost(seed: int, rec: bool) -> int:
    from bench import harness
    from repro_torch import tracing
    seconds = harness.load_benchmark()["run_seconds"]
    print(f"train_spans: recording {int(rec)}", file=sys.stderr)
    with (tracing.recording() if rec else contextlib.nullcontext()):
        return harness.main(["--workload", CELL, "--seed", str(seed),
                             "--seconds", str(seconds), "--trace", "0"],
                            T_START)


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("command", choices=("report", "cost"))
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--recording", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.command == "cost":
        return cost(args.seed, bool(args.recording))
    line = json.dumps(report(args.seed, args.steps))
    dest = ROOT / "chiprun_out"
    dest.mkdir(exist_ok=True)
    (dest / f"train_spans_report_{args.seed}.json").write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
