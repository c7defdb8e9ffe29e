"""The Jamba training cell at a tiny size on the CPU (the port with
device="cpu"): its files load through the harness, a sound run agrees with
the reference, a traced run reads what the CPU can read, each fault a
training cell can have comes out not correct, the benchmark's own counts
add up by hand, and the reference runs without the program or JAX. On a
card, ``pytest -m gpu bench/tests`` also runs the control and the dropped
write-back at the cell's own size.

The tiny size is two layers, one Mamba and one attention (period 2,
offset 1), at d 64 in the cell's bfloat16: through fourteen random layers
of width 64 bfloat16's rounding alone moves the median leaf's gradient
norm past the cell's limit (grad_median_gap 0.0036 - 0.0075 over three
seeds against 0.0017; 0.0008 at the cell's own width), where two keep it
inside (0.00098 - 0.0011; grad_gap 0.0034 - 0.016); in float32 fourteen
layers read 2e-6 - 1e-5."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from bench import harness, jamba_inputs, jamba_yardstick, whisper_yardstick
from bench.drivers.jamba_train import gap_checks
from bench.reference import jamba_lm, mamba_lm
from bench.tests import tiny
from bench.tests.control_jamba import (WORKLOAD, control_gaps,
                                       half_batches)
from bench.tests.control_whisper import dropped_write_back

CONFIG = dict(hidden_size=64, intermediate_size=128, mamba_d_state=4,
              mamba_dt_rank=4, vocab_size=512, num_hidden_layers=2,
              num_attention_heads=4, attn_layer_period=2,
              attn_layer_offset=1)
TRAFFIC = dict(batch=1, seq_len=128, initial_tokens=4096,
               ingest_per_step=256, trace_seconds=0.3)


def run(seconds=0.5, trace=False, hooks=None, traffic=None, seed=tiny.SEED):
    return harness.run_cell(WORKLOAD, seed, seconds, trace,
                            time.perf_counter(), device=torch.device("cpu"),
                            hooks=hooks, config_overrides=CONFIG,
                            traffic_overrides=dict(TRAFFIC, **(traffic or {})))


def tiny_cell():
    _, cfg, tr = harness.load_cell(harness.load_benchmark(), WORKLOAD)
    cfg.update(CONFIG)
    tr.update(TRAFFIC)
    return cfg, tr


def test_the_cells_files_load_through_the_harness():
    bench = harness.load_benchmark()
    wl, cfg, tr = harness.load_cell(bench, WORKLOAD)
    assert (wl["config"], wl["chips"]) == ("ai21-jamba2-3b-train", 1)
    assert (cfg["driver"], cfg["reference"]) == ("jamba_train", "jamba_lm")
    assert harness.driver_of(cfg).__name__ == "bench.drivers.jamba_train"
    assert (tr["batch"], tr["seq_len"], tr["ingest_per_step"],
            tr["initial_tokens"]) == (1, 32768, 65536, 16777216)
    assert cfg["job"]["micro_batches"] == 1 and cfg["job"]["remat"]
    s = jamba_inputs.sizes(cfg)
    assert (s["d"], s["di"], s["layers"], s["heads"], s["kv_heads"],
            s["dh"], s["r"], s["n"], s["ff"], s["vocab"]) == \
        (2560, 5120, 28, 20, 1, 128, 160, 16, 8192, 65536)
    assert [i for i in range(28) if jamba_inputs.is_attention(cfg, i)] == \
        [7, 21]
    assert {m["name"] for m in harness.metrics_of(bench, WORKLOAD, False)} \
        == {"train_tokens_per_s", "setup_s"}
    assert {m["name"] for m in harness.metrics_of(bench, WORKLOAD, True)} \
        == {"mfu.jamba", "flash_roofline.jamba", "attn_ms.jamba",
            "ssm_roofline.train", "idle_share.train", "pipeline_ms.train",
            "propagate_idle_ms.train", "optimizer_idle_ms.train",
            "optimizer_ms.train", "rows_per_update.train"}


def test_sound_run_agrees_with_the_reference():
    got = run(seconds=1.0)
    assert got.correct, [(c.name, c.value, c.limit) for c in got.checks]
    assert got.attempted > 0 and got.failed == 0
    assert got.counts["tokens_per_step"] == 128
    line = harness.result_line(harness.load_benchmark(), got, traced=False)
    assert line["correct"] is True
    assert set(line["metrics"]) == {"train_tokens_per_s", "setup_s"}


def test_traced_run_reports_what_the_cpu_can_read():
    """The model flops utilisation from the steps after the stretch, and
    the token pipeline's host time and rows an update, which the cell
    shares with ``fm7b-train``; the device readings (the rooflines, the
    stream times, the idle shares) find nothing to read on the CPU and
    are left out."""
    got = run(seconds=1.5, trace=True)
    assert got.correct and got.trace is not None
    line = harness.result_line(harness.load_benchmark(), got, traced=True)
    assert set(line["metrics"]) == {"mfu.jamba", "pipeline_ms.train",
                                    "rows_per_update.train"}
    m = line["metrics"]
    assert m["pipeline_ms.train"]["value"] > 0
    assert m["rows_per_update.train"]["value"] > 0


def test_the_parent_without_the_block_fails_at_once(monkeypatch):
    """A program without Jamba's block (no `JambaConfig`) fails the cell
    on its first line, before any weight is drawn."""
    import repro_torch.models.config as config
    monkeypatch.delattr(config, "JambaConfig")
    drawn = []
    monkeypatch.setattr(jamba_inputs, "outer_weights",
                        lambda *a: drawn.append(a))
    with pytest.raises(ImportError):
        run(seconds=0.1)
    assert not drawn


def _unchanged_state(step_fn):
    from repro_torch.models.lm import lm_loss

    def step(model, opt_state, s, batch):
        with torch.no_grad():
            loss = lm_loss(model, batch["tokens"], batch["labels"],
                           model.cfg)
        return model, opt_state, {"loss": loss.float()}
    return step


def _half_batch(step_fn):
    def step(model, opt_state, s, batch):
        half = {k: v[:, :v.shape[1] // 2] for k, v in batch.items()}
        return step_fn(model, opt_state, s, half)
    return step


def _altered_token(get_batch):
    def get(step):
        toks, labels = get_batch(step)
        toks = toks.clone()
        toks[0, 0] = (toks[0, 0] + 1) % CONFIG["vocab_size"]
        return toks, labels
    return get


@pytest.mark.parametrize("hooks,fails", [
    ({"train_step": _unchanged_state},
     {"grad_error", "update_gap"}),
    ({"train_step": _half_batch}, {"grad_error"}),
    ({"train_step": dropped_write_back}, {"params_off_master"}),
    ({"get_batch": _altered_token}, {"batch_tokens_wrong"}),
], ids=["unchanged_state", "half_batch", "dropped_write_back",
        "altered_token"])
def test_fault_is_not_correct(hooks, fails):
    got = run(seconds=0.3, hooks=hooks)
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
    assert ctl["grad_error"] > 3 * gaps["grad_error"]


def test_half_batch_planted_in_the_reference_reads_far():
    cfg, tr = tiny_cell()
    half = control_gaps(tiny.SEED, cfg, tr, torch.device("cpu"), "half_batch")
    failed = {c.name for c in gap_checks(half, cfg["job"]["limits"])
              if not c.ok}
    assert "grad_error" in failed, half


def test_half_batches_cut_the_positions():
    toks = torch.arange(10).reshape(1, 10)
    (t, lab), = half_batches([(toks, toks + 1)])
    assert t.tolist() == [[0, 1, 2, 3, 4]] and lab.tolist() == [[1, 2, 3, 4,
                                                                   5]]


@pytest.mark.parametrize("B,T,D,N", [(1, 16, 8, 4), (2, 48, 5, 4),
                                     (1, 160, 12, 16), (1, 37, 3, 4),
                                     (2, 1024, 8, 16)])
def test_reference_scan_equals_the_sequential_one(B, T, D, N):
    """`jamba_lm.scan_block` (chunks, a prefix scan over them) against
    `mamba_lm`'s scan, output and every gradient, in float64: one chunk,
    a length no chunk divides, a chunk count that is no power of two."""
    gen = torch.Generator().manual_seed(B * T + D)

    def draw(*shape, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=gen, dtype=torch.float64)
                * scale + shift)
    args = [draw(B, T, D), draw(B, T, D).abs() * 0.5,
            -draw(D, N).abs() * 2 - 0.1, draw(B, T, N), draw(B, T, N),
            draw(D)]
    g = draw(B, T, D)
    out = []
    for fn in (jamba_lm.scan_block, mamba_lm.Model.scan):
        leaves = [a.clone().requires_grad_() for a in args]
        y = fn(*leaves)
        out.append((y.detach(), torch.autograd.grad((y * g).sum(), leaves)))
    (y1, g1), (y2, g2) = out
    torch.testing.assert_close(y1, y2, rtol=1e-12, atol=1e-12)
    for a, b in zip(g1, g2):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)


def test_weights_count_every_leaf_the_generator_draws():
    cfg, _ = tiny_cell()
    leaves = jamba_inputs.all_weights(1, cfg, torch.float32, "cpu")
    assert sum(v.numel() for v in leaves.values()) == \
        jamba_yardstick.weights(cfg)
    # the published model: about 3.03 billion parameters
    published = harness.load_cell(harness.load_benchmark(), WORKLOAD)[1]
    assert 3.02e9 < jamba_yardstick.weights(published) < 3.04e9


def test_flops_count_the_products_a_step_runs():
    """6 a matmul parameter a token and 12 dh a (query, key) pair in the
    causal band and query head, counted by hand at the tiny size: one
    Mamba layer (in 64 x 256, x_proj 128 x 12, dt_proj 4 x 128, out 128 x
    64), one attention layer (q and o 64 x 64, k and v 64 x 16), two MLPs
    of 3 x 64 x 128 and the tied head 512 x 64 once."""
    cfg, tr = tiny_cell()
    mamba = 64 * 256 + 128 * 12 + 4 * 128 + 128 * 64
    attn = 2 * 64 * 64 + 2 * 64 * 16
    params = mamba + attn + 2 * 3 * 64 * 128 + 512 * 64
    assert jamba_yardstick.matmul_params(cfg) == params
    pairs = 128 * 129 // 2
    assert whisper_yardstick.band_pairs(128, 128, True) == pairs
    assert whisper_yardstick.band_pairs(5, 5, True) == 15
    assert jamba_yardstick.train_flops(cfg, tr) == \
        6 * 128 * params + 12 * 16 * 4 * pairs


def test_flash_bound_binds_on_the_products_at_jambas_shapes():
    """At head_dim 128 the products bind the bound, forward and backward,
    at the cell's (1, 32,768, 32,768, 20, 1, 128, causal)."""
    shape = (1, 32768, 32768, 20, 1, 128, 1, 0, 0.0)
    fwd, which = whisper_yardstick.flash_bound_s(shape, False, 132, 1.98e9)
    bwd, which_bwd = whisper_yardstick.flash_bound_s(shape, True, 132,
                                                     1.98e9)
    assert (which, which_bwd) == ("products", "products")
    pairs = 32768 * 32769 // 2
    assert fwd == pytest.approx(4 * 128 * 20 * pairs / 989e12)
    assert 2 * bwd == pytest.approx(2.5 * fwd)


REFERENCE = """
import sys, json
sys.path.insert(0, {root!r})
import bench.reference.jamba_lm, bench.jamba_inputs, bench.jamba_yardstick
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

RUN = """
import sys, json
sys.path.insert(0, {src!r}); sys.path.insert(0, {root!r})
from bench.tests import test_bench_jamba as t
t.run(seconds=0.2)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _modules(code: str) -> set[str]:
    root = str(harness.ROOT)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code.format(
        src=os.path.join(root, "src"), root=root)], check=True,
        capture_output=True, text=True, env=env, timeout=600, cwd=root)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_reference_loads_nothing_of_the_program():
    top = _modules(REFERENCE)
    assert "repro_torch" not in top
    assert not top & set(harness.FORBIDDEN)


def test_a_run_of_the_cell_loads_no_jax():
    top = _modules(RUN)
    assert "repro_torch" in top
    assert not top & set(harness.FORBIDDEN)


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [2**31 + 501, 2**31 + 502])
@pytest.mark.parametrize("fault", ["fp8", "half_batch"])
def test_control_and_half_batch_fail_the_cell_at_its_size(seed, fault):
    """The control and the half batch at the cell's own size fail one of
    its numbers (on a card: about three minutes a seed)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cell's size does not fit the CPU")
    _, cfg, tr = harness.load_cell(harness.load_benchmark(), WORKLOAD)
    gaps = control_gaps(seed, cfg, tr, torch.device("cuda", 0), fault)
    checks = gap_checks(gaps, cfg["job"]["limits"])
    print(json.dumps({"seed": seed, "fault": fault, **gaps}))
    assert not all(c.ok for c in checks), checks


@pytest.mark.gpu
def test_dropped_write_back_fails_the_cell_at_its_size():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cell's size does not fit the CPU")
    got = harness.run_cell(WORKLOAD, 2**31 + 601, 5.0, False,
                           time.perf_counter(),
                           hooks={"train_step": dropped_write_back})
    checks = {c.name: c for c in got.checks}
    print(json.dumps({k: c.value for k, c in checks.items()}))
    assert not checks["params_off_master"].ok, got.checks


@pytest.mark.gpu
def test_a_step_at_the_cells_size_runs_the_kernels_it_should():
    """One step of the cell's training object on the card, under the
    program's tracing (after a first step): no attention takes the plain
    path, every Mamba forward applies Jamba's norms (26 layers, twice
    with remat), two ``lm.attention`` spans a layer (forward and
    recompute), and the blocked attention launches 4 forwards and 2
    backward calls (4 launches), all at the cell's shape; K17, its
    backward and the conv at (1, 32,768, 5,120)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cell's size does not fit the CPU")
    from bench.drivers import jamba_train
    from bench.trace import Spans
    from repro_torch import tracing
    from repro_torch.kernels.common import (kernel_launch_shapes,
                                            reset_kernel_launch_counts)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    _, cfg, tr = harness.load_cell(harness.load_benchmark(), WORKLOAD)
    cell = harness.Cell(name=WORKLOAD, config_name="ai21-jamba2-3b-train",
                        config=cfg, traffic_name=WORKLOAD, traffic=tr,
                        chips=1, seed=2**31 + 701, seconds=1.0, trace=False,
                        device=dev, t_start=time.perf_counter())
    prog = jamba_train.load_loop({}).Program(cell, Spans(dev, False))
    prog.step(0)
    reset_kernel_launch_counts()
    tracing.clear()
    with tracing.recording():
        prog.step(1)
    recs = tracing.records()
    tracing.clear()
    counts = {}
    for r in recs:
        for name, n in r.counts.items():
            counts[name] = counts.get(name, 0) + n
    spans = [r.device_ms for r in recs if r.name == "lm.attention"]
    print(json.dumps({"counts": counts, "lm.attention_ms": spans}))
    assert counts.get("attn.plain_calls", 0) == 0
    assert counts["mamba.mixer_norms"] == 26 * 2
    assert len(spans) == 2 * 2 and all(ms > 0 for ms in spans)
    flash = (1, 32768, 32768, 20, 1, 128, 1, 0, 0)
    mamba = (1, 32768, 5120, 16)
    shapes = kernel_launch_shapes()
    assert shapes["flash_attention"] == {flash: 4}
    assert shapes["flash_attention_bwd"] == {flash: 4}
    assert shapes["selective_scan"] == {mamba: 52}
    assert shapes["selective_scan_bwd"] == {mamba: 26}
    assert shapes["causal_conv"] == {mamba[:3] + (4,): 52}
    assert shapes["causal_conv_bwd"] == {mamba[:3] + (4,): 26}
    del prog
