"""The port's spans and counters (`repro_torch.tracing`): off they record
nothing and never enter `record_function`; on they nest per thread (also
in a checkpoint's recompute during backward), keep the profiler's clock,
and attach counts to the innermost open span; the token pipeline's and
the train step's spans and counts; and no name the program uses is one of
the benchmark harness's range names."""

from __future__ import annotations

import pathlib
import re
import sys
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch import tracing
from repro_torch.data import HTAPTokenPipeline

ROOT = pathlib.Path(__file__).resolve().parent.parent
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _fresh():
    tracing.clear()
    yield
    tracing.clear()


def _tiny_pipeline(**kw):
    return HTAPTokenPipeline(vocab_size=64, seq_len=16, batch=2, seed=3,
                             initial_tokens=kw.pop("initial_tokens", 1024),
                             device="cpu", **kw)


def _pipeline_step(pipe, step, n=128):
    pipe.ingest(np.random.default_rng(step).integers(0, 64, n))
    pipe.propagate()
    return pipe.get_batch(step)


def _tiny_train_step():
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.config import BlockSpec, ModelConfig
    from repro_torch.models.lm import init_lm
    from repro_torch.optim import get_optimizer
    cfg = ModelConfig(name="t", n_layers=2, d_model=16, n_heads=1,
                      n_kv_heads=1, d_ff=0, vocab_size=64,
                      blocks=(BlockSpec(mixer="mamba", mlp="none"),),
                      d_state=4, d_conv=4, expand=2, param_dtype="float32",
                      activ_dtype="float32", loss_chunk=16, remat=True,
                      sub_quadratic=True)
    model = init_lm(cfg, generator=torch.Generator().manual_seed(0),
                    device="cpu")
    opt = get_optimizer("adamw", lr=1e-3)
    state = opt[0](dict(model.named_parameters()))
    step = make_train_step(cfg, opt, micro_batches=2)
    toks = torch.randint(0, 64, (2, 16), generator=torch.Generator()
                         .manual_seed(1), dtype=torch.int32)
    return lambda s: step(model, state, s, {"tokens": toks, "labels": toks})


def _refuse(*a, **k):
    raise AssertionError("record_function entered while spans are off")


@pytest.mark.parametrize("work", ["pipeline", "train_step"])
def test_off_records_nothing_and_enters_no_record_function(work, monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", _refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _refuse)
    if work == "pipeline":
        pipe = _tiny_pipeline()
        for s in range(3):
            _pipeline_step(pipe, s)
    else:
        run = _tiny_train_step()
        for s in range(2):
            run(s)
    assert tracing.records() == []
    # off, a span is the one shared do-nothing object: nothing is allocated
    assert tracing.span("a.b") is tracing.span("c.d", 3, device="cpu")
    assert not tracing.enabled()


def _by_name(recs):
    out = {}
    for r in recs:
        out.setdefault(r.name, []).append(r)
    return out


@pytest.mark.parametrize("where", ["threads", "checkpoint_recompute"])
def test_spans_nest_per_thread(where):
    seen = {}
    with tracing.recording():
        if where == "threads":
            def body(tag):
                seen[tag] = threading.get_ident()
                with tracing.span(f"t.outer_{tag}"):
                    time.sleep(0.002)
                    with tracing.span(f"t.inner_{tag}"):
                        time.sleep(0.002)
            with tracing.span("t.main"):
                threads = [threading.Thread(target=body, args=(i,))
                           for i in range(3)]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(timeout=30)
            assert not any(t.is_alive() for t in threads)
        else:
            from torch.utils.checkpoint import checkpoint

            def layer(x):
                seen.setdefault("threads", []).append(threading.get_ident())
                with tracing.span("t.layer"):
                    return torch.tanh(x) * 2
            x = torch.randn(8, requires_grad=True)
            with tracing.span("t.forward"):
                y = checkpoint(layer, x, use_reentrant=False).sum()
            with tracing.span("t.backward"):
                y.backward()
    recs = tracing.records()
    by = _by_name(recs)
    ids = {r.id: r for r in recs}
    if where == "threads":
        assert len(recs) == 7
        for i in range(3):
            outer, = by[f"t.outer_{i}"]
            inner, = by[f"t.inner_{i}"]
            # a new thread's stack starts empty: its outer span has no parent
            assert outer.parent is None and inner.parent == outer.id
            assert outer.thread == inner.thread == seen[i]
            assert outer.start_ns <= inner.start_ns <= inner.end_ns \
                <= outer.end_ns
        main, = by["t.main"]
        assert main.parent is None and main.thread == threading.get_ident()
    else:
        first, again = by["t.layer"]          # the forward, the recompute
        fwd, = by["t.forward"]
        bwd, = by["t.backward"]
        assert first.parent == fwd.id
        assert again.thread == seen["threads"][1]
        parent = ids.get(again.parent)
        # the recompute's span nests under what its own thread has open
        if again.thread == bwd.thread:
            assert parent is bwd
        else:
            assert parent is None or parent.thread == again.thread
        assert bwd.start_ns <= again.start_ns <= again.end_ns <= bwd.end_ns


def test_span_clock_is_the_profilers():
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert tracing.enabled()
        with tracing.span("t.body"):
            time.sleep(0.020)
    got = [e for e in prof.profiler.kineto_results.events()
           if e.name() == "t.body"]
    assert len(got) == 1
    rec, = tracing.records()
    assert abs(rec.start_ns - got[0].start_ns()) < 2_000_000
    assert abs(rec.end_ns - got[0].end_ns()) < 2_000_000
    assert rec.end_ns - rec.start_ns >= 20_000_000


@pytest.mark.parametrize("case", ["innermost", "after_inner_closed",
                                  "no_span_open", "device_tensor"])
def test_counts_attach_to_the_innermost_span(case):
    with tracing.recording():
        if case == "no_span_open":
            tracing.count("t.n", 5)
        else:
            with tracing.span("t.outer"):
                with tracing.span("t.inner"):
                    if case == "innermost":
                        tracing.count("t.n", 5)
                    elif case == "device_tensor":
                        tracing.count("t.n", torch.tensor(2))
                        tracing.count("t.n", torch.tensor(3))
                if case == "after_inner_closed":
                    tracing.count("t.n", 5)
    by = _by_name(tracing.records())
    if case == "no_span_open":
        rec, = by["t.n"]
        assert rec.counts == {"t.n": 5} and rec.start_ns == rec.end_ns
        return
    inner, outer = by["t.inner"][0], by["t.outer"][0]
    holder, other = ((outer, inner) if case == "after_inner_closed"
                     else (inner, outer))
    assert holder.counts == {"t.n": 5} and other.counts == {}
    assert type(holder.counts["t.n"]) is int


def test_pipeline_spans_and_counts():
    init, n, steps = 1024, 128, 3
    pipe = _tiny_pipeline(initial_tokens=init)
    _pipeline_step(pipe, 0, n)                   # outside: nothing recorded
    with tracing.recording():
        for s in range(1, 1 + steps):
            _pipeline_step(pipe, s, n)
    recs = tracing.records()
    by = _by_name(recs)
    ids = {r.id: r for r in recs}
    for name, parent in [("ship.merge", "pipeline.propagate"),
                         ("ship.locate", "pipeline.propagate"),
                         ("apply.dictionary", "pipeline.propagate"),
                         ("apply.rewrite", "pipeline.propagate"),
                         ("consistency.swap", "pipeline.propagate"),
                         ("consistency.snapshot", "pipeline.get_batch"),
                         ("pipeline.gather", "pipeline.get_batch")]:
        assert len(by[name]) == steps, name
        assert {ids[r.parent].name for r in by[name]} == {parent}, name
    assert len(by["pipeline.ingest"]) == steps
    assert [r.step for r in by["pipeline.get_batch"]] == [1, 2, 3]
    # the CPU has no stream: a device span keeps no events there
    assert all(r.device_ms is None for r in by["pipeline.propagate"])
    rows = [init + n * (s + 1) for s in range(1, 1 + steps)]
    assert [r.counts["apply.updates"] for r in by["apply.dictionary"]] == \
        [n] * steps
    # stage 3 rewrites the column it was given, then the snapshot copies
    # the grown column whole: its row count changed, so every chunk is dirty
    assert [r.counts["apply.rows_rewritten"] for r in by["apply.rewrite"]] \
        == [r - n for r in rows]
    snaps = by["consistency.snapshot"]
    assert [r.counts["snapshot.rows_copied"] for r in snaps] == rows
    assert [r.counts["snapshot.rows_carried"] for r in snaps] == [0] * steps


def test_snapshot_of_an_unchanged_size_counts_dirty_chunks_on_the_device():
    import dataclasses

    from repro_torch.core.backend import SNAPSHOT_BLOCK, get_backend
    from repro_torch.core.dsm import encode_column
    n = 3 * SNAPSHOT_BLOCK + 100
    be = get_backend("hopper", device="cpu")
    values = np.arange(n) % 50
    col = encode_column(values, "cpu")
    prev = be.snapshot_column(col)
    changed = col.codes.clone()
    changed[SNAPSHOT_BLOCK + 7] = (changed[SNAPSHOT_BLOCK + 7] + 1) % 50
    changed[n - 1] = (changed[n - 1] + 1) % 50
    col2 = dataclasses.replace(col, codes=changed)
    with tracing.recording(), tracing.span("t.snap"):
        be.snapshot_column(col2, prev=prev)
    rec, = tracing.records()
    # chunks 1 and 3 are dirty: 2 x the block, capped at the column's rows
    assert rec.counts == {"snapshot.rows_copied": 2 * SNAPSHOT_BLOCK,
                          "snapshot.rows_carried": n - 2 * SNAPSHOT_BLOCK}


def test_train_step_spans():
    run = _tiny_train_step()
    with tracing.recording():
        run(7)
    recs = tracing.records()
    by = _by_name(recs)
    ids = {r.id: r for r in recs}
    step, = by["train.step"]
    assert step.step == 7 and step.parent is None
    assert len(by["train.forward"]) == len(by["train.backward"]) == 2
    for name in ("train.forward", "train.backward", "train.grad_scale",
                 "train.optimizer"):
        assert {ids[r.parent].name for r in by[name]} == {"train.step"}
        assert {r.step for r in by[name]} == {7}


def _program_names() -> set[str]:
    names = set()
    for path in (ROOT / "src" / "repro_torch").rglob("*.py"):
        names |= set(re.findall(r'tracing\.(?:span|count)\(\s*"([^"]+)"',
                                path.read_text()))
    return names


def test_no_program_name_is_a_harness_range():
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from bench.trace import RANGES
    names = _program_names()
    assert {"train.step", "pipeline.propagate", "ship.merge",
            "apply.rewrite", "snapshot.rows_copied", "session.scan"} <= names
    assert not names & set(RANGES)
    for name in names:
        assert re.fullmatch(r"[a-z_]+\.[a-z_]+", name), name
