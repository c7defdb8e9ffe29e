"""A closed loop of training steps of `repro_torch`'s Mamba language model,
fed by its HTAP token pipeline.

Set-up builds one training object (the model with the benchmark's weights
from the seed, AdamW's state, the step from `make_train_step`, and the
`HTAPTokenPipeline` on the device) and drives it through the first
`reference_steps` steps, each through the window's own calls: ingest the
step's tokens (drawn from (seed, step)), `propagate`, `get_batch(step)`,
the train step. From those steps it keeps the losses, the first step's
gradient norm per leaf (from AdamW's first moment after one step, m / (1 -
b1)) and, after the last, the norm of each leaf's change (AdamW's float32
master weights less the initial weights, drawn again from the seed).
The window runs the same loop on the same object until `seconds` have
passed; the last step that starts in time ends it.

After the window the peak device memory is read, the model's parameters
are held against AdamW's float32 masters rounded to the parameters' type
(AdamW writes each step's weights back into them), and the program's
state is freed; then the reference (`bench.reference.mamba_lm`) checks
every batch the pipeline handed a step against the token column it works
out itself, and follows the first steps in float32 from the same weights
and batches.

A traced run times `propagate` plus `get_batch` between synchronizes in
the window's first third, then profiles a stretch of steps, then runs the
rest as an untraced run does (the model flops utilisation reads that
rest).
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from bench import generators
from bench.harness import Cell, Check, Measured
from bench.reference import mamba_lm
from bench.trace import Profiler, Spans


def model_config(cfg: dict):
    """The program's `ModelConfig` for the configuration's sizes; refuses
    sizes the program's Mamba block cannot express."""
    from repro_torch.models.config import BlockSpec, ModelConfig
    d, di = cfg["hidden_size"], cfg["intermediate_size"]
    if di % d or cfg["time_step_rank"] != max(1, d // 16):
        raise ValueError("the program's block derives d_inner = expand x "
                         "d_model and dt_rank = d_model / 16; the "
                         "configuration's sizes differ")
    return ModelConfig(
        name=cfg["name"], n_layers=cfg["num_hidden_layers"], d_model=d,
        n_heads=1, n_kv_heads=1, d_ff=0, vocab_size=cfg["vocab_size"],
        blocks=(BlockSpec(mixer="mamba", mlp="none"),),
        d_state=cfg["state_size"], d_conv=cfg["conv_kernel"],
        expand=di // d, param_dtype=cfg["torch_dtype"],
        activ_dtype=cfg["torch_dtype"], loss_chunk=cfg["job"]["loss_chunk"],
        remat=cfg["job"]["remat"], sub_quadratic=True)


def build_model(cell: Cell, mcfg):
    """The program's `LM` holding the benchmark's weights from the seed."""
    from repro_torch.models.lm import LM, Block
    from repro_torch.nn.layers import Params
    cfg, dev = cell.config, cell.device
    dt = getattr(torch, cfg["torch_dtype"])
    outer = generators.mamba_outer_weights(cell.seed, cfg, dt, dev)
    layers = [Block(mcfg.blocks[0],
                    generators.mamba_layer_weights(cell.seed, cfg, i, dt, dev))
              for i in range(cfg["num_hidden_layers"])]
    return LM(mcfg, Params(outer["embed"]), layers, Params(outer["ln_f"]),
              Params(outer["head"]))


class Program:
    """The training object and the harness's calls into it."""

    def __init__(self, cell: Cell, spans: Spans):
        from repro_torch.data import HTAPTokenPipeline
        from repro_torch.launch.steps import make_train_step
        from repro_torch.optim import get_optimizer
        cfg, tr = cell.config, cell.traffic
        job = cfg["job"]
        self.cell, self.spans = cell, spans
        self.mcfg = model_config(cfg)
        self.model = build_model(cell, self.mcfg)
        o = job["optimizer"]
        opt = get_optimizer("adamw", lr=o["lr"], b1=o["b1"], b2=o["b2"],
                            eps=o["eps"], weight_decay=o["weight_decay"])
        self.opt_state = opt[0](dict(self.model.named_parameters()))
        step = make_train_step(self.mcfg, opt,
                               micro_batches=job["micro_batches"])
        self.step_fn = cell.hooks.get("train_step", lambda f: f)(step)
        self.pipe = HTAPTokenPipeline(
            cfg["vocab_size"], tr["seq_len"], tr["batch"], seed=cell.seed,
            initial_tokens=tr["initial_tokens"], device=cell.device)
        get_batch = self.pipe.get_batch
        self.get_batch = cell.hooks.get("get_batch", lambda f: f)(get_batch)
        self.batches: list = []
        self.losses: list = []

    def step(self, s: int) -> None:
        sp, tr = self.spans, self.cell.traffic
        with sp.range("traffic"):
            chunk = generators.token_chunk(self.cell.seed, s,
                                           tr["ingest_per_step"],
                                           self.cell.config["vocab_size"])
        with sp.range("ingest"):
            self.pipe.ingest(chunk)
        with sp.timed("pipeline"):
            with sp.range("propagate"):
                self.pipe.propagate()
            with sp.range("get_batch"):
                toks, labels = self.get_batch(s)
        self.batches.append((toks.clone(), labels.clone()))
        with sp.range("train_step"):
            self.model, self.opt_state, out = self.step_fn(
                self.model, self.opt_state, s,
                {"tokens": toks, "labels": labels})
        self.losses.append(out["loss"])

    def first_grad_norms(self) -> dict:
        b1 = self.cell.config["job"]["optimizer"]["b1"]
        return {k: float(m.norm()) / (1 - b1)
                for k, m in self.opt_state["m"].items()}

    def params_off_master(self) -> int:
        """Elements of the parameters the step's forward reads that differ
        from AdamW's float32 master rounded to the parameter's type. A step
        that drops the write-back trains on stale weights while its masters
        move, which the gaps of the first steps barely see."""
        master = self.opt_state["master"]
        with torch.no_grad():
            return sum(int((p != master[k].to(p.dtype)).sum())
                       for k, p in self.model.named_parameters())

    def change_norms(self) -> dict:
        """Each leaf's change: AdamW's float32 master weights less the
        initial weights, drawn again from the seed a layer at a time."""
        cell, cfg = self.cell, self.cell.config
        dt = getattr(torch, cfg["torch_dtype"])
        master = self.opt_state["master"]
        out = {}
        outer = generators.flatten(generators.mamba_outer_weights(
            cell.seed, cfg, dt, cell.device))
        for k, v in outer.items():
            out[k] = float((master[k] - v.float()).norm())
        del outer
        for i in range(cfg["num_hidden_layers"]):
            lw = generators.flatten(generators.mamba_layer_weights(
                cell.seed, cfg, i, dt, cell.device), f"layers.{i}.")
            for k, v in lw.items():
                out[k] = float((master[k] - v.float()).norm())
        return out


def run(cell: Cell) -> Measured:
    cfg, tr, dev = cell.config, cell.traffic, cell.device
    job = cfg["job"]
    spans = Spans(dev, cell.trace)
    from repro_torch.kernels.common import kernel_launch_shapes
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    prog = Program(cell, spans)
    n_ref = int(job["reference_steps"])
    grad_norms = None
    for s in range(n_ref):
        prog.step(s)
        if s == 0:
            grad_norms = prog.first_grad_norms()
    got = {"losses": [float(x) for x in prog.losses[:n_ref]],
           "grad_norms": grad_norms, "change_norms": prog.change_norms()}
    spans.sync()
    t0 = time.perf_counter()
    setup_s = t0 - cell.t_start
    spans.timing = cell.trace
    s = n_ref
    prof = Profiler(spans, kernel_launch_shapes)
    trace_from = t0 + cell.seconds / 3
    trace_for = float(tr.get("trace_seconds", 3.0))
    after = None           # (time, step) where the profiled stretch ended
    while time.perf_counter() - t0 < cell.seconds:
        if cell.trace and prof.trace is None:
            now = time.perf_counter()
            if not prof.running and now >= trace_from:
                spans.timing = False
                prof.start()
                traced_from = time.perf_counter()
            elif prof.running and now - traced_from >= trace_for:
                prof.stop()
                after = (time.perf_counter(), s)
        with spans.range("step"):
            prog.step(s)
        s += 1
    spans.sync()
    t_end = time.perf_counter()
    window_s = t_end - t0
    if prof.running:
        prof.stop()
    steps = s - n_ref
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    got["params_off_master"] = prog.params_off_master()
    losses = [float(x) for x in prog.losses]
    batches = [(t.cpu().numpy(), l.cpu().numpy()) for t, l in prog.batches]
    del prog
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    checks, extra = judge(cell, got, batches, losses)
    extra["readings"]["reference_s"] = time.perf_counter() - t_ref
    tokens = tr["batch"] * tr["seq_len"]
    if dev.type == "cuda":
        from bench import yardstick
        extra["sm_clock_hz"] = yardstick.max_sm_clock_hz()
        extra["sms"] = torch.cuda.get_device_properties(dev).multi_processor_count
    return Measured(
        setup_s=setup_s, window_s=window_s,
        counts={"train_steps": steps, "train_tokens": steps * tokens,
                "tokens_per_step": tokens,
                # a traced run's steps after its profiled stretch, which ran
                # as an untraced run's do, and their seconds
                "clean_steps": s - after[1] if after else 0,
                "clean_s": t_end - after[0] if after else 0.0},
        latencies_s={}, spans=spans, trace=prof.trace,
        memory_peak_bytes=peak, checks=checks, attempted=steps,
        failed=sum(not np.isfinite(x) for x in losses[n_ref:]), extra=extra)


def reference_batches(cell: Cell, n_steps: int) -> list:
    """The (tokens, labels) each step's `get_batch` must return: the token
    column worked out from the seed (the pipeline's initial draw, then each
    step's ingested chunk) and the pipeline's window schedule."""
    cfg, tr = cell.config, cell.traffic
    init, ingest = tr["initial_tokens"], tr["ingest_per_step"]
    column = np.empty(init + n_steps * ingest, np.int32)
    column[:init] = generators.pipeline_initial_tokens(cell.seed, init,
                                                       cfg["vocab_size"])
    out = []
    for s in range(n_steps):
        column[init + s * ingest:init + (s + 1) * ingest] = \
            generators.token_chunk(cell.seed, s, ingest, cfg["vocab_size"])
        w = generators.batch_window(column, init + (s + 1) * ingest, s,
                                    tr["batch"], tr["seq_len"])
        out.append((w[:, :-1], w[:, 1:]))
    return out


def judge(cell: Cell, got: dict, batches: list, losses: list):
    job = cell.config["job"]
    want_batches = reference_batches(cell, len(batches))
    wrong = 0
    for (gt, gl), (wt, wl) in zip(batches, want_batches):
        for g, w in ((gt, wt), (gl, wl)):
            wrong += (int((g != w).sum()) if g.shape == w.shape
                      else int(w.size))
    n_ref = int(job["reference_steps"])
    want = mamba_lm.train(cell.seed, cell.config, job,
                          want_batches[:n_ref], cell.device, "float32")
    gaps = mamba_lm.compare(got, want)
    lim = job["limits"]
    finite = all(np.isfinite(x) for x in losses)
    # the loss gap is read and kept but not compared: no control or fault
    # reads far enough above the sound runs to bound it (PERF.md)
    checks = [Check("batch_tokens_wrong", wrong, 0),
              Check("losses_not_finite", int(not finite), 0),
              Check("params_off_master", got["params_off_master"], 0),
              Check("grad_gap", gaps["grad_gap"], lim["grad_gap"]),
              Check("grad_median_gap", gaps["grad_median_gap"],
                    lim["grad_median_gap"]),
              Check("update_gap", gaps["update_gap"], lim["update_gap"])]
    extra = {"gaps": gaps,
             "readings": {"loss_gap": gaps["loss_gap"],
                          "grad_worst_leaf": gaps["grad_worst_leaf"],
                          "update_worst_leaf": gaps["update_worst_leaf"],
                          "losses_program": got["losses"],
                          "losses_reference": want["losses"]}}
    return checks, extra
