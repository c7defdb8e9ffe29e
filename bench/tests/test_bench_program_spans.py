"""The per-layer metrics that read the program's own spans and counts
(`bench/program_trace.py`): the reduction on a synthetic trace and
records, and a tiny traced training run on the CPU."""

from __future__ import annotations

import dataclasses
import types

import pytest

from bench import harness, program_trace
from bench.tests import tiny
from bench.trace import RANGES, Trace


@dataclasses.dataclass
class Rec:
    id: int
    name: str
    start_ns: int
    end_ns: int
    parent: int | None = None
    thread: int = 1
    step: int | None = None
    counts: dict = dataclasses.field(default_factory=dict)
    device_ms: float | None = None


def _trace(ops, ranges):
    return Trace(ops, ranges, 1.0, {})


def _run(trace, records, monkeypatch):
    monkeypatch.setattr(program_trace, "program_records", lambda: records)
    return types.SimpleNamespace(trace=trace, extra={})


# device busy [0, 10], [20, 30], [50, 60], [80, 90]: gaps at 10, 30, 60
OPS = [("k", 0, 10), ("k", 20, 30), ("k", 50, 60), ("k", 80, 90)]
STEP = [("step", 0, 100)]


def test_a_gap_goes_to_the_innermost_span(monkeypatch):
    recs = [Rec(0, "train.step", 1, 99, step=5),
            Rec(1, "pipeline.propagate", 5, 40, parent=0),
            Rec(2, "apply.rewrite", 8, 35, parent=1),
            Rec(3, "train.optimizer", 55, 70, parent=0)]
    run = _run(_trace(OPS, STEP), recs, monkeypatch)
    got = program_trace.owners(recs, [10, 30, 60])
    assert [o.name for o in got] == ["apply.rewrite", "apply.rewrite",
                                     "train.optimizer"]
    # both gaps under the rewrite count for propagate, 10 + 20 ns, 1 step
    assert program_trace.idle_ms_per_step(run, "pipeline.propagate") == \
        30 / 1e6
    assert program_trace.idle_ms_per_step(run, "train.optimizer") == 20 / 1e6
    assert program_trace.idle_split(run) == {
        "step": {"apply.rewrite": 30 / 1e9, "train.optimizer": 20 / 1e9}}


def test_a_gap_under_a_span_on_another_thread_goes_to_that_span(
        monkeypatch):
    recs = [Rec(0, "train.step", 1, 99, step=0),
            Rec(1, "train.backward", 2, 95, parent=0),
            # opened later, on autograd's worker thread, with no parent
            Rec(2, "t.recompute", 25, 65, thread=2)]
    got = program_trace.owners(recs, [10, 30, 60, 96])
    assert [o.name for o in got] == ["train.backward", "t.recompute",
                                     "t.recompute", "train.step"]
    run = _run(_trace(OPS, STEP), recs, monkeypatch)
    assert program_trace.idle_split(run) == {
        "step": {"train.backward": 10 / 1e9, "t.recompute": 40 / 1e9}}


def test_records_outside_the_step_ranges_are_left_out(monkeypatch):
    ranges = [("step", 100, 200), ("train_step", 110, 190),
              ("step", 200, 300)]
    recs = [Rec(0, "train.step", 50, 90), Rec(1, "train.step", 110, 190),
            Rec(2, "train.step", 210, 290), Rec(3, "train.step", 290, 310),
            Rec(4, "apply.rewrite", 95, 105)]
    kept = program_trace.in_stretch(_trace([], ranges), recs)
    assert [r.id for r in kept] == [1, 2]
    run = _run(_trace([("k", 100, 120), ("k", 150, 300)], ranges), recs,
               monkeypatch)
    assert program_trace.steps(program_trace.stretch(run)) == 2
    assert program_trace.idle_ms_per_step(run, "train.step") == 30 / 1e6 / 2
    # without the step ranges or the program's records: nothing to read
    assert program_trace.in_stretch(_trace([], []), recs) == []
    run = _run(_trace(OPS, STEP), None, monkeypatch)
    assert program_trace.idle_ms_per_step(run, "train.step") is None


def _metrics(run):
    bench = tiny.benchmark()
    return {m["name"]: harness.read_metric(m["name"], run)
            for m in harness.metrics_of(bench, "fm7b-train", True)}


def _tiny_traced_run(monkeypatch=None):
    from repro_torch import tracing
    tracing.clear()
    if monkeypatch is not None:
        monkeypatch.setattr(tracing, "span", lambda *a, **k: tracing._OFF)
        monkeypatch.setattr(tracing, "count", lambda *a, **k: None)
    return tiny.run("fm7b-train", seconds=3.0, trace=True)


def test_tiny_traced_training_run_reads_the_program(monkeypatch):
    run = _tiny_traced_run()
    assert run.correct
    got = _metrics(run)
    recs = program_trace.stretch(run)
    steps = sorted(r.step for r in recs if r.name == "train.step")
    assert steps and steps == sorted(r.step for r in recs
                                     if r.name == "pipeline.get_batch")
    # step s: stage 3 rewrites the column as it was (init + ingest x s
    # rows), then the snapshot copies the whole grown column
    init = tiny.TRAIN_TRAFFIC["initial_tokens"]
    ingest = tiny.TRAIN_TRAFFIC["ingest_per_step"]
    rows = sum((init + ingest * s) + (init + ingest * (s + 1))
               for s in steps)
    assert got["rows_per_update.train"] == rows / (ingest * len(steps))
    # the CPU runs no device operation and has no stream
    for name in ("propagate_idle_ms.train", "optimizer_idle_ms.train",
                 "optimizer_ms.train"):
        assert got[name] is None, name
    assert got["pipeline_ms.train"] > 0

    # the harness's ranges and idle labels are the same without the spans
    quiet = _tiny_traced_run(monkeypatch)
    assert quiet.correct
    assert program_trace.stretch(quiet) == []
    assert _metrics(quiet)["rows_per_update.train"] is None
    for r in (run, quiet):
        assert {name for name, _, _ in r.trace.ranges} == \
            {"step", "traffic", "ingest", "pipeline", "propagate",
             "get_batch", "train_step"}
        assert {label for label, _ in r.trace.breakdown()["idle_gaps"]} <= \
            set(RANGES) | {"harness"}
    assert [lab for lab, _ in run.trace.breakdown()["idle_gaps"]] == \
        [lab for lab, _ in quiet.trace.breakdown()["idle_gaps"]]


@pytest.mark.parametrize("name", ["propagate_idle_ms.train",
                                  "optimizer_idle_ms.train",
                                  "optimizer_ms.train",
                                  "rows_per_update.train"])
def test_a_run_without_a_trace_reads_none(name):
    run = types.SimpleNamespace(trace=None, extra={})
    assert harness.read_metric(name, run) is None
