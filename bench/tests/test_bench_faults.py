"""A run with the timed path broken underneath comes out not correct, once
for each fault a cell can have; the control reads further from the
reference than the program does. The harness's look for a card is skipped:
these run on the CPU at tiny sizes.

On a card, ``pytest -m gpu bench/tests`` also reads the training cell's
control at the cell's own size and holds it to the cell's limits."""

from __future__ import annotations

import json
import time

import pytest
import torch

from bench import harness
from bench.tests import tiny
from bench.tests.control import control_gaps


# -- training ---------------------------------------------------------------

def _unchanged_state(step_fn):
    """A step that returns its state unchanged: the loss, no update."""
    from repro_torch.models.lm import lm_loss

    def step(model, opt_state, s, batch):
        with torch.no_grad():
            loss = lm_loss(model, batch["tokens"], batch["labels"], model.cfg)
        return model, opt_state, {"loss": loss.float()}
    return step


def _half_batch(step_fn):
    """Half of the batch left out, the mean taken over the rest."""
    def step(model, opt_state, s, batch):
        half = {k: v[:v.shape[0] // 2] for k, v in batch.items()}
        return step_fn(model, opt_state, s, half)
    return step


def _dropped_write_back(step_fn):
    """AdamW's new weights never written back into the parameters: the
    float32 masters move, the weights the forward reads stay as they
    were, so every step takes its gradient at the initial weights."""
    def step(model, opt_state, s, batch):
        with torch.no_grad():
            held = [p.detach().clone() for p in model.parameters()]
        model, opt_state, out = step_fn(model, opt_state, s, batch)
        with torch.no_grad():
            for p, h in zip(model.parameters(), held):
                p.copy_(h)
        return model, opt_state, out
    return step


def _altered_token(get_batch):
    """A token altered where the pipeline produces the batch."""
    def get(step):
        toks, labels = get_batch(step)
        toks = toks.clone()
        toks[0, 0] = (toks[0, 0] + 1) % tiny.TRAIN_CONFIG["vocab_size"]
        return toks, labels
    return get


@pytest.mark.parametrize("hooks,traffic,fails", [
    ({"train_step": _unchanged_state}, {}, {"grad_gap", "update_gap"}),
    # four sequences, so that half of them still split into two micro-batches
    ({"train_step": _half_batch}, {"batch": 4}, {"grad_gap", "update_gap"}),
    ({"train_step": _dropped_write_back}, {}, {"params_off_master"}),
    ({"get_batch": _altered_token}, {}, {"batch_tokens_wrong"}),
], ids=["unchanged_state", "half_batch", "dropped_write_back",
        "altered_token"])
def test_training_fault_is_not_correct(hooks, traffic, fails):
    run = tiny.run("fm7b-train", seconds=0.3, hooks=hooks, traffic=traffic)
    assert not run.correct
    failed = {c.name for c in run.checks if not c.ok}
    assert fails <= failed, (failed, run.checks)


def test_training_sound_run_is_correct_with_four_sequences():
    run = tiny.run("fm7b-train", seconds=0.3, traffic={"batch": 4})
    assert run.correct, run.checks


def _tiny_training():
    bench = tiny.benchmark()
    _, cfg, tr = harness.load_cell(bench, "fm7b-train")
    cfg.update(tiny.TRAIN_CONFIG)
    tr.update(tiny.TRAIN_TRAFFIC)
    return cfg, tr


def test_control_reads_further_than_the_program():
    """At a tiny size the control (float8 products) reads loss and
    gradient gaps several times the sound program's (bfloat16): the
    mechanism that separates them at the cell's size."""
    cfg, tr = _tiny_training()
    ctl = control_gaps(tiny.SEED, cfg, tr, torch.device("cpu"))
    run = tiny.run("fm7b-train", seconds=0.3)
    gaps = run.extra["gaps"]
    assert ctl["loss_gap"] > 3 * gaps["loss_gap"]
    assert ctl["grad_gap"] > 3 * gaps["grad_gap"]
    assert ctl["grad_median_gap"] > 3 * gaps["grad_median_gap"]


def test_half_batch_planted_in_the_reference_reads_far():
    cfg, tr = _tiny_training()
    half = control_gaps(tiny.SEED, cfg, tr, torch.device("cpu"), "half_batch")
    limits = cfg["job"]["limits"]
    assert half["grad_gap"] > limits["grad_gap"]
    assert half["update_gap"] > limits["update_gap"]


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [2**31 + 101, 2**31 + 102, 2**31 + 103])
def test_control_fails_the_cell_at_its_size(seed):
    """The control at the training cell's own size fails one of its
    numbers (on a card: about a minute a seed)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cell's size does not fit the CPU")
    bench = harness.load_benchmark()
    _, cfg, tr = harness.load_cell(bench, "fm7b-train")
    gaps = control_gaps(seed, cfg, tr, torch.device("cuda", 0))
    lim = cfg["job"]["limits"]
    assert any(gaps[k] > lim[k] for k in lim), (gaps, lim)


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [2**31 + 201, 2**31 + 202, 2**31 + 203])
def test_dropped_write_back_fails_the_cell_at_its_size(seed):
    """The training cell at its own size, with AdamW's write-back into the
    parameters dropped, comes out not correct (on a card: about a minute
    a seed)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cell's size does not fit the CPU")
    run = harness.run_cell("fm7b-train", seed, 2.0, False, time.perf_counter(),
                           hooks={"train_step": _dropped_write_back})
    checks = {c.name: c for c in run.checks}
    print(json.dumps({"seed": seed, **{k: c.value for k, c in checks.items()}}))
    assert not checks["params_off_master"].ok, run.checks


# -- HTAP -------------------------------------------------------------------

def _session_with(patch):
    from bench.drivers.htap_rounds import make_session

    def factory(cell):
        s = make_session(cell)
        patch(s)
        return s
    return factory


def _altered_answer(s):
    batch = s.query_batch
    s.query_batch = lambda qs: [a + (i == 0) for i, a in enumerate(batch(qs))]


def _half_the_txns(s):
    from repro_torch.core.workload import slice_stream
    execute = s.execute
    s.execute = lambda chunk: execute(slice_stream(chunk, 0, len(chunk) // 2))


@pytest.mark.parametrize("cell", ["micro-ana", "micro-write"])
@pytest.mark.parametrize("fault", ["unchanged_state", "altered_answer",
                                   "half_the_txns"])
def test_htap_fault_is_not_correct(cell, fault, monkeypatch):
    hooks = {}
    if fault == "unchanged_state":
        # every apply returns the column it was given
        from repro_torch.core import session
        monkeypatch.setattr(session, "apply_updates",
                            lambda old, *a, **k: old)
    else:
        patch = {"altered_answer": _altered_answer,
                 "half_the_txns": _half_the_txns}[fault]
        hooks["session"] = _session_with(patch)
    run = tiny.run(cell, seconds=0.5, hooks=hooks)
    assert not run.correct, run.checks


def test_htap_stale_control_is_not_correct():
    """The configuration's guarantee broken: each query batch answered
    before the round's transactions are applied."""
    def stale(s):
        execute, batch = s.execute, s.query_batch
        held = []
        s.execute = lambda chunk: held.append(chunk)

        def answer(qs):
            got = batch(qs)
            while held:
                execute(held.pop(0))
            return got
        s.query_batch = answer
    run = tiny.run("micro-ana", seconds=0.5,
                   hooks={"session": _session_with(stale)})
    assert not run.correct
    assert json.dumps([c.value for c in run.checks])
