"""A closed loop of training steps of `repro_torch`'s language model with
AI21's Jamba block, fed by its HTAP token pipeline.

The loop is `lm_train`'s, whole: `run` loads a copy of
``bench/drivers/lm_train.py`` of its own (`load_loop`) and runs its `run`
with this module's `model_config`, `build_model`, `judge` and the
`Readings` of its `Program` in place of that module's. Set-up builds one
training object (the `LM` with the benchmark's weights from the seed,
AdamW's state, the step from `make_train_step`, and the
`HTAPTokenPipeline` on the device) and drives it through the first
`reference_steps` steps of the window's own calls: ingest the step's
tokens, `propagate`, `get_batch(step)`, the train step. From those steps
it keeps the losses, the first step's gradient per leaf (AdamW's first
moment after one step, m / (1 - b1), its norm and a float32 copy on the
host) and, after the last, the norm of each leaf's change (AdamW's float32
masters less the initial weights, drawn again from the seed). The window
runs the same loop until `seconds` have passed; the last step that starts
in time ends it.

After the window the peak device memory is read, the parameters are held
against AdamW's masters rounded to the parameters' type, and the
program's state is freed; then the reference (`bench.reference.jamba_lm`)
checks every batch the pipeline handed a step and follows the first steps
in float32 from the same weights and batches.

The program's configuration is built first, so that a program without
Jamba's block fails at once.
"""

from __future__ import annotations

import functools
import pathlib

import numpy as np
import torch

from bench import harness, jamba_inputs
from bench.drivers import lm_train
from bench.drivers.lm_train import reference_batches
from bench.harness import Cell, Check, Measured
from bench.reference import jamba_lm


def model_config(cfg: dict):
    """The program's `JambaConfig` for the configuration's sizes, layer
    rule and job (a program without Jamba's block raises here)."""
    from repro_torch.models.config import BlockSpec, JambaBlock, JambaConfig
    s, job = jamba_inputs.sizes(cfg), cfg["job"]
    blocks = tuple(BlockSpec(mixer="attn" if jamba_inputs.is_attention(
        cfg, i) else "mamba", mlp="dense") for i in range(s["period"]))
    return JambaConfig(
        name=cfg["name"], n_layers=s["layers"], d_model=s["d"],
        n_heads=s["heads"], n_kv_heads=s["kv_heads"], head_dim=s["dh"],
        d_ff=s["ff"], vocab_size=s["vocab"], blocks=blocks,
        d_state=s["n"], d_conv=s["k"], expand=s["di"] // s["d"],
        jamba=JambaBlock(), param_dtype=job["dtype"],
        activ_dtype=job["dtype"], loss_chunk=job["loss_chunk"],
        remat=job["remat"], sub_quadratic=True)


def build_model(cell: Cell, mcfg):
    """The program's `LM` holding the benchmark's weights from the seed
    (no head: Jamba's is the embedding)."""
    from repro_torch.models.lm import LM, Block
    from repro_torch.nn.layers import Params
    cfg, dev = cell.config, cell.device
    dt = getattr(torch, cfg["job"]["dtype"])
    outer = jamba_inputs.outer_weights(cell.seed, cfg, dt, dev)
    layers = [Block(mcfg.blocks[i % mcfg.period],
                    jamba_inputs.layer_weights(cell.seed, cfg, i, dt, dev))
              for i in range(mcfg.n_layers)]
    return LM(mcfg, Params(outer["embed"]), layers, Params(outer["ln_f"]),
              None)


class Readings:
    """What Jamba's training object reads otherwise than
    `lm_train.Program`: the first step's gradients kept on the host in
    `first` (a class attribute, one dict a run), and each leaf's change
    against the weights drawn by `jamba_inputs`."""

    first: dict

    def first_grad_norms(self) -> dict:
        """The first step's gradient per leaf, m / (1 - b1): its norm, and
        a float32 copy on the host into `first`."""
        b1 = self.cell.config["job"]["optimizer"]["b1"]
        for k, m in self.opt_state["m"].items():
            self.first[k] = (m / (1 - b1)).cpu()
        return {k: float(g.norm()) for k, g in self.first.items()}

    def change_norms(self) -> dict:
        cfg = self.cell.config
        return jamba_lm.change_norms(self.cell.seed, cfg,
                                     getattr(torch, cfg["job"]["dtype"]),
                                     self.opt_state["master"])


def load_loop(first: dict):
    """A copy of `lm_train` of its own whose `Program` trains Jamba's
    model (`model_config`, `build_model`, `Readings` with `first`) and
    whose `judge` is this module's."""
    loop = harness.load_module(pathlib.Path(lm_train.__file__),
                               "bench_jamba_train_loop")
    loop.model_config = model_config
    loop.build_model = build_model
    loop.Program = type("Program", (Readings, loop.Program),
                        {"first": first})
    loop.judge = functools.partial(judge, first=first)
    return loop


def run(cell: Cell) -> Measured:
    model_config(cell.config)      # fails at once without Jamba's block
    return load_loop({}).run(cell)


def gap_checks(gaps: dict, limits: dict) -> list:
    """A `Check` for each gap the job's ``limits`` name (the others are
    read, not compared)."""
    return [Check(k, gaps[k], v) for k, v in limits.items()]


def judge(cell: Cell, got: dict, batches: list, losses: list, first: dict):
    job = cell.config["job"]
    want_batches = reference_batches(cell, len(batches))
    wrong = 0
    for (gt, gl), (wt, wl) in zip(batches, want_batches):
        for g, w in ((gt, wt), (gl, wl)):
            wrong += (int((g != w).sum()) if g.shape == w.shape
                      else int(w.size))
    n_ref = int(job["reference_steps"])
    want = jamba_lm.train(cell.seed, cell.config, job, want_batches[:n_ref],
                          cell.device, "float32", against=first)
    first.clear()
    gaps = jamba_lm.compare(got, want)
    finite = all(np.isfinite(x) for x in losses)
    # the loss gap and the worst leaf's norm gap are read and kept but
    # not compared (`PERF.md` §2)
    checks = [Check("batch_tokens_wrong", wrong, 0),
              Check("losses_not_finite", int(not finite), 0),
              Check("params_off_master", got["params_off_master"], 0),
              *gap_checks(gaps, job["limits"])]
    extra = {"gaps": gaps,
             "readings": {"loss_gap": gaps["loss_gap"],
                          "grad_gap": gaps["grad_gap"],
                          "grad_worst_leaf": gaps["grad_worst_leaf"],
                          "grad_error_worst_leaf":
                              gaps["grad_error_worst_leaf"],
                          "update_worst_leaf": gaps["update_worst_leaf"],
                          "losses_program": got["losses"],
                          "losses_reference": want["losses"]}}
    return checks, extra
