"""The whisper training cell at a tiny size on the CPU (the port with
device="cpu"): a sound run agrees with the reference, a traced run reads
its spans, each fault a training cell can have comes out not correct, the
control reads further than the program, and the benchmark's own counts
add up. On a card, ``pytest -m gpu bench/tests`` also runs the control and
the dropped write-back at the cell's own size."""

from __future__ import annotations

import gc
import json
import time

import pytest
import torch

from bench import harness, whisper_inputs, whisper_yardstick
from bench.tests import tiny
from bench.tests.control_whisper import (WORKLOAD, control_gaps,
                                         dropped_write_back)

CONFIG = dict(d_model=64, encoder_layers=2, decoder_layers=2,
              encoder_attention_heads=4, decoder_attention_heads=4,
              encoder_ffn_dim=256, decoder_ffn_dim=256, vocab_size=512,
              num_mel_bins=8, max_source_positions=24,
              max_target_positions=16)
# 48 mel frames (24 positions) and 12 tokens: lengths no block divides
TRAFFIC = dict(batch=4, seq_len=12, frames=48, initial_tokens=4096,
               ingest_per_step=256, trace_seconds=0.3)


def run(seconds=0.5, trace=False, hooks=None, traffic=None):
    return harness.run_cell(WORKLOAD, tiny.SEED, seconds, trace,
                            time.perf_counter(), device=torch.device("cpu"),
                            hooks=hooks, config_overrides=CONFIG,
                            traffic_overrides=dict(TRAFFIC, **(traffic or {})))


def tiny_cell():
    _, cfg, tr = harness.load_cell(harness.load_benchmark(), WORKLOAD)
    cfg.update(CONFIG)
    tr.update(TRAFFIC)
    return cfg, tr


def test_sound_run_agrees_with_the_reference():
    got = run(seconds=1.0)
    assert got.correct, [(c.name, c.value, c.limit) for c in got.checks]
    assert got.attempted > 0 and got.failed == 0
    assert got.counts["tokens_per_step"] == 4 * 12
    line = harness.result_line(harness.load_benchmark(), got, traced=False)
    assert set(line["metrics"]) == {"train_tokens_per_s", "setup_s"}


def test_window_runs_with_the_set_ups_objects_frozen():
    """The window's steps run with set-up's objects out of the collector's
    generations (a full collection does not scan them); the reference
    steps of set-up run before the freeze."""
    frozen = {}

    def hook(step_fn):
        def step(model, opt_state, s, batch):
            frozen[s] = gc.get_freeze_count()
            return step_fn(model, opt_state, s, batch)
        return step
    run(seconds=0.3, hooks={"train_step": hook})
    n_ref = 3
    window = [n for s, n in frozen.items() if s >= n_ref]
    assert window, frozen
    assert min(window) > 10 * max(frozen[s] for s in range(n_ref)) + 1000


def test_traced_run_reports_what_the_cpu_can_read():
    """A traced run: the model flops utilisation from the steps after the
    stretch; the device readings (roofline, idle share, the encoder's
    stream time) find nothing to read on the CPU and are left out."""
    got = run(seconds=1.5, trace=True)
    assert got.correct and got.trace is not None
    line = harness.result_line(harness.load_benchmark(), got, traced=True)
    assert set(line["metrics"]) <= {"mfu.whisper", "flash_roofline.whisper",
                                    "idle_share.whisper",
                                    "encode_ms.whisper"}
    assert "mfu.whisper" in line["metrics"]
    assert "flash_roofline.whisper" not in line["metrics"]


def _unchanged_state(step_fn):
    from repro_torch.models.encdec import encdec_loss

    def step(model, opt_state, s, batch):
        with torch.no_grad():
            loss = encdec_loss(model, batch["frames"], batch["tokens"],
                               batch["labels"], model.cfg)
        return model, opt_state, {"loss": loss.float()}
    return step


def _half_batch(step_fn):
    def step(model, opt_state, s, batch):
        half = {k: v[:v.shape[0] // 2] for k, v in batch.items()}
        return step_fn(model, opt_state, s, half)
    return step


def _altered_token(get_batch):
    def get(step):
        toks, labels = get_batch(step)
        toks = toks.clone()
        toks[0, 0] = (toks[0, 0] + 1) % CONFIG["vocab_size"]
        return toks, labels
    return get


@pytest.mark.parametrize("hooks,traffic,fails", [
    ({"train_step": _unchanged_state}, {},
     {"grad_error", "grad_gap", "update_gap"}),
    ({"train_step": _half_batch}, {"batch": 8},
     {"grad_error", "grad_gap", "grad_median_gap"}),
    ({"train_step": dropped_write_back}, {}, {"params_off_master"}),
    ({"get_batch": _altered_token}, {}, {"batch_tokens_wrong"}),
], ids=["unchanged_state", "half_batch", "dropped_write_back",
        "altered_token"])
def test_fault_is_not_correct(hooks, traffic, fails):
    got = run(seconds=0.3, hooks=hooks, traffic=traffic)
    assert not got.correct
    failed = {c.name for c in got.checks if not c.ok}
    assert fails <= failed, (failed, got.checks)


def test_control_reads_further_than_the_program():
    """At a tiny size the control (float8 products) reads the gradient's
    error several times the sound program's (bfloat16): the mechanism
    that separates them at the cell's size, where the limits are set."""
    cfg, tr = tiny_cell()
    ctl = control_gaps(tiny.SEED, cfg, tr, torch.device("cpu"))
    gaps = run(seconds=0.3).extra["gaps"]
    assert ctl["grad_error"] > 5 * gaps["grad_error"]
    assert ctl["grad_gap"] > 3 * gaps["grad_gap"]


def test_half_batch_planted_in_the_reference_reads_far():
    cfg, tr = tiny_cell()
    half = control_gaps(tiny.SEED, cfg, tr, torch.device("cpu"), "half_batch")
    limits = cfg["job"]["limits"]
    assert half["grad_error"] > limits["grad_error"]
    assert half["grad_gap"] > limits["grad_gap"]
    assert half["grad_median_gap"] > limits["grad_median_gap"]


def test_weights_count_every_leaf_the_generator_draws():
    cfg, _ = tiny_cell()
    leaves = whisper_inputs.all_weights(1, cfg, torch.float32, "cpu")
    assert sum(v.numel() for v in leaves.values()) == \
        whisper_yardstick.weights(cfg)
    # the published model: about 1.54 billion parameters
    published, _ = harness.load_cell(harness.load_benchmark(), WORKLOAD)[1:]
    assert 1.5e9 < whisper_yardstick.weights(published) < 1.6e9


def test_flops_count_the_products_a_step_runs():
    """6 a matmul parameter a position, 12 dh a (query, key) pair and
    head, counted by hand at the tiny size."""
    cfg, tr = tiny_cell()
    d, ff, V, H, dh = 64, 256, 512, 4, 16
    B, F, T, S = 4, 48, 24, 12
    dense = (2 * (4 * d * d + 2 * d * ff) * T + 2 * 2 * d * d * T
             + (2 * (6 * d * d + 2 * d * ff) + V * d) * S
             + 3 * 8 * d * F + 3 * d * d * T)
    pairs = 2 * T * T + 2 * (S * (S + 1) // 2 + S * T)
    assert whisper_yardstick.train_flops(cfg, tr) == \
        6 * B * dense + 12 * dh * B * H * pairs


def test_flash_bound_binds_on_the_products_at_whisper_shapes():
    """At whisper's head_dim of 64 the products bind the bound, forward
    and backward; a backward call, two launches, is 2.5 forwards."""
    shape = (16, 1500, 1500, 20, 20, 64, 0, 0, 0)
    fwd, which = whisper_yardstick.flash_bound_s(shape, False, 132, 1.98e9)
    bwd, which_bwd = whisper_yardstick.flash_bound_s(shape, True, 132,
                                                     1.98e9)
    assert (which, which_bwd) == ("products", "products")
    assert fwd == pytest.approx(4 * 64 * 16 * 20 * 1500 ** 2 / 989e12)
    assert 2 * bwd == pytest.approx(2.5 * fwd)


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [2**31 + 301, 2**31 + 302, 2**31 + 303])
def test_control_fails_the_cell_at_its_size(seed):
    """The control at the cell's own size fails one of its numbers (on a
    card: about a minute and a half a seed)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cell's size does not fit the CPU")
    _, cfg, tr = harness.load_cell(harness.load_benchmark(), WORKLOAD)
    gaps = control_gaps(seed, cfg, tr, torch.device("cuda", 0))
    lim = cfg["job"]["limits"]
    assert any(gaps[k] > lim[k] for k in lim), (gaps, lim)


@pytest.mark.gpu
def test_dropped_write_back_fails_the_cell_at_its_size():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cell's size does not fit the CPU")
    got = harness.run_cell(WORKLOAD, 2**31 + 401, 2.0, False,
                           time.perf_counter(),
                           hooks={"train_step": dropped_write_back})
    checks = {c.name: c for c in got.checks}
    print(json.dumps({k: c.value for k, c in checks.items()}))
    assert not checks["params_off_master"].ok, got.checks
