"""A closed loop of training steps of `repro_torch`'s encoder-decoder with
whisper's own block, its decoder's tokens fed by the HTAP token pipeline.

The loop is `lm_train`'s. Set-up builds one training object (the model
with the benchmark's weights from the seed, AdamW's state, the step from
`make_train_step`, and the `HTAPTokenPipeline` on the device) and drives it
through the first `reference_steps` steps, each through the window's own
calls: draw the step's log-mel input from (seed, step) on the device,
ingest the step's tokens, `propagate`, `get_batch(step)`, the train step.
From those steps it keeps the losses, the first step's gradient norm per
leaf (AdamW's first moment after one step, m / (1 - b1)) and, after the
last, the norm of each leaf's change (AdamW's float32 masters less the
initial weights, drawn again from the seed). Then set-up's objects are
frozen out of the collector's generations (`gc.freeze`), and the window
runs the same loop until `seconds` have passed; the last step that starts
in time ends it.

After the window the peak device memory is read, the parameters are held
against AdamW's masters rounded to the parameters' type, and the
program's state is freed; then the reference (`bench.reference.whisper_lm`)
checks every batch the pipeline handed a step and follows the first steps
in float32 from the same weights, frames and batches.

A traced run profiles a stretch of steps from the window's first third,
then runs the rest as an untraced run does (the model flops utilisation
reads that rest).

The program's configuration is built first, so that a program without
whisper's block fails at once.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from bench import generators, whisper_inputs
from bench.drivers.lm_train import reference_batches
from bench.harness import Cell, Check, Measured
from bench.reference import whisper_lm
from bench.trace import Profiler, Spans


def model_config(cfg: dict, job: dict):
    """The program's `ModelConfig` for the configuration's sizes (a
    program without whisper's block raises here)."""
    from repro_torch.models.config import (BlockSpec, WhisperBlock,
                                           WhisperConfig)
    s = whisper_inputs.sizes(cfg)
    return WhisperConfig(
        name=cfg["name"], n_layers=s["dec"], n_enc_layers=s["enc"],
        d_model=s["d"], n_heads=s["heads"], n_kv_heads=s["heads"],
        head_dim=s["d"] // s["heads"], d_ff=s["ff"], vocab_size=s["vocab"],
        blocks=(BlockSpec(mixer="attn", mlp="dense"),),
        is_encoder_decoder=True, enc_context=cfg["max_source_positions"],
        frontend="frames",
        whisper=WhisperBlock(n_mels=s["mels"],
                             max_target_positions=s["positions"]),
        param_dtype=job["dtype"], activ_dtype=job["dtype"],
        loss_chunk=job["loss_chunk"], remat=job["remat"])


def build_model(cell: Cell, mcfg):
    """The program's `EncDec` holding the benchmark's weights from the
    seed."""
    from repro_torch.models.encdec import EncDec
    from repro_torch.nn.layers import Params
    cfg, dev = cell.config, cell.device
    dt = getattr(torch, cfg["job"]["dtype"])
    s = whisper_inputs.sizes(cfg)
    outer = whisper_inputs.outer_weights(cell.seed, cfg, dt, dev)
    enc, dec = ([Params(whisper_inputs.layer_weights(cell.seed, cfg, stack, i,
                                                     dt, dev))
                 for i in range(s[stack])] for stack in ("enc", "dec"))
    return EncDec(mcfg, Params(outer["embed"]), enc, dec,
                  Params(outer["ln_enc"]), Params(outer["ln_f"]), None,
                  Params(outer["frontend"]))


class Program:
    """The training object and the harness's calls into it."""

    def __init__(self, cell: Cell, spans: Spans):
        from repro_torch.data import HTAPTokenPipeline
        from repro_torch.launch.steps import make_train_step
        from repro_torch.optim import get_optimizer
        cfg, tr = cell.config, cell.traffic
        job = cfg["job"]
        self.cell, self.spans = cell, spans
        self.mcfg = model_config(cfg, job)
        self.dtype = getattr(torch, job["dtype"])
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
        sp, cell = self.spans, self.cell
        tr = cell.traffic
        with sp.range("traffic"):
            frames = whisper_inputs.mel(cell.seed, s, tr["batch"],
                                        tr["frames"], cell.config,
                                        cell.device).to(self.dtype)
            chunk = generators.token_chunk(cell.seed, s,
                                           tr["ingest_per_step"],
                                           cell.config["vocab_size"])
        with sp.range("ingest"):
            self.pipe.ingest(chunk)
        with sp.range("propagate"):
            self.pipe.propagate()
        with sp.range("get_batch"):
            toks, labels = self.get_batch(s)
        self.batches.append((toks.clone(), labels.clone()))
        with sp.range("train_step"):
            self.model, self.opt_state, out = self.step_fn(
                self.model, self.opt_state, s,
                {"tokens": toks, "labels": labels, "frames": frames})
        self.losses.append(out["loss"])

    def first_grads(self) -> dict:
        """The first step's gradient per leaf, float32 on the host, from
        AdamW's first moment after one step: m / (1 - b1)."""
        b1 = self.cell.config["job"]["optimizer"]["b1"]
        return {k: (m / (1 - b1)).cpu()
                for k, m in self.opt_state["m"].items()}

    def params_off_master(self) -> int:
        """Elements of the parameters the step's forward reads that differ
        from AdamW's float32 master rounded to the parameter's type."""
        master = self.opt_state["master"]
        with torch.no_grad():
            return sum(int((p != master[k].to(p.dtype)).sum())
                       for k, p in self.model.named_parameters())

    def change_norms(self) -> dict:
        """Each leaf's change: AdamW's float32 master weights less the
        initial weights, drawn again from the seed a layer at a time."""
        cell, cfg = self.cell, self.cell.config
        master = self.opt_state["master"]
        out = {}

        def add(tree, prefix=""):
            for k, v in generators.flatten(tree, prefix).items():
                out[k] = float((master[k] - v.float()).norm())
        add(whisper_inputs.outer_weights(cell.seed, cfg, self.dtype,
                                         cell.device))
        for stack in ("enc", "dec"):
            for i in range(whisper_inputs.sizes(cfg)[stack]):
                add(whisper_inputs.layer_weights(cell.seed, cfg, stack, i,
                                                 self.dtype, cell.device),
                    f"{stack}.{i}.")
        return out


def run(cell: Cell) -> Measured:
    cfg, tr, dev = cell.config, cell.traffic, cell.device
    job = cfg["job"]
    model_config(cfg, job)           # fails at once without whisper's block
    spans = Spans(dev, cell.trace)
    from repro_torch.kernels.common import kernel_launch_shapes
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    prog = Program(cell, spans)
    n_ref = int(job["reference_steps"])
    grads = None
    for s in range(n_ref):
        prog.step(s)
        if s == 0:
            grads = prog.first_grads()
    got = {"losses": [float(x) for x in prog.losses[:n_ref]],
           "grad_norms": {k: float(g.norm()) for k, g in grads.items()},
           "grads": grads, "change_norms": prog.change_norms()}
    # the set-up's objects (the imported modules, the model's leaves) leave
    # the collector's generations, as a training loop's set-up leaves them:
    # otherwise every full collection in the window scans them all, a pause
    # of a fifth of a second about every fourth step that the device waits
    # through, and the windows' step counts drift with where they fall
    gc.collect()
    gc.freeze()
    spans.sync()
    t0 = time.perf_counter()
    setup_s = t0 - cell.t_start
    s = n_ref
    prof = Profiler(spans, kernel_launch_shapes)
    trace_from = t0 + cell.seconds / 3
    trace_for = float(tr.get("trace_seconds", 3.0))
    after = None           # (time, step) where the profiled stretch ended
    try:
        while time.perf_counter() - t0 < cell.seconds:
            if cell.trace and prof.trace is None:
                now = time.perf_counter()
                if not prof.running and now >= trace_from:
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
    finally:
        gc.unfreeze()      # the program's state can be collected again
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


def judge(cell: Cell, got: dict, batches: list, losses: list):
    job = cell.config["job"]
    want_batches = reference_batches(cell, len(batches))
    wrong = 0
    for (gt, gl), (wt, wl) in zip(batches, want_batches):
        for g, w in ((gt, wt), (gl, wl)):
            wrong += (int((g != w).sum()) if g.shape == w.shape
                      else int(w.size))
    n_ref = int(job["reference_steps"])
    want = whisper_lm.train(cell.seed, cell.config, job,
                            want_batches[:n_ref], cell.traffic["frames"],
                            cell.device, "float32", against=got.pop("grads"))
    gaps = whisper_lm.compare(got, want)
    lim = job["limits"]
    finite = all(np.isfinite(x) for x in losses)
    # the loss gap is read and kept but not compared, as in lm_train
    checks = [Check("batch_tokens_wrong", wrong, 0),
              Check("losses_not_finite", int(not finite), 0),
              Check("params_off_master", got["params_off_master"], 0),
              Check("grad_error", gaps["grad_error"], lim["grad_error"]),
              Check("grad_gap", gaps["grad_gap"], lim["grad_gap"]),
              Check("grad_median_gap", gaps["grad_median_gap"],
                    lim["grad_median_gap"]),
              Check("update_gap", gaps["update_gap"], lim["update_gap"])]
    extra = {"gaps": gaps,
             "readings": {"loss_gap": gaps["loss_gap"],
                          "grad_worst_leaf": gaps["grad_worst_leaf"],
                          "grad_error_worst_leaf":
                              gaps["grad_error_worst_leaf"],
                          "update_worst_leaf": gaps["update_worst_leaf"],
                          "losses_program": got["losses"],
                          "losses_reference": want["losses"]}}
    return checks, extra
