"""Step factories for every model the port runs (dense, local/global,
Mamba, the VLM backbone, MoE, the hybrid and the encoder-decoder): the
training step (loss, gradients, optimizer update), prefill, and greedy
decode against the KV/SSM caches. A MoE model's prefill and decode drop
the layers' auxiliary loss, as the reference's do; its training loss
adds it.
Prefill and decode run under ``torch.no_grad()``: they record no graph
(and take no remat) even for a model whose gradients are on.
"""

from __future__ import annotations

import torch

from repro_torch import tracing
from repro_torch.models.config import ModelConfig
from repro_torch.models.encdec import (encdec_decode_step, encdec_hidden,
                                       encdec_logits, encdec_loss)
from repro_torch.models.lm import (lm_decode_step, lm_hidden, lm_logits,
                                   lm_loss)


def make_train_step(cfg: ModelConfig, optimizer, micro_batches: int = 1):
    """train_step(model, opt_state, step, batch) -> (model, opt_state,
    {"loss": 0-d float32 tensor}). ``optimizer`` is an ``(init, update)``
    pair of `repro_torch.optim` over ``dict(model.named_parameters())``;
    ``batch`` holds ``tokens`` and ``labels`` (B, S) and, for a VLM,
    ``patch_embeds``, for an encoder-decoder ``frames`` (B, T_enc, d).
    The step turns the model's gradients on, and the update writes the
    new parameters into the model in place.

    ``micro_batches`` > 1 splits the batch's leading axis and runs the
    forward and backward one part at a time (activation memory shrinks by
    that factor); the gradients accumulate in the parameters' dtype and,
    with the loss, are divided by ``micro_batches``, as the reference's
    scan does."""
    _, opt_update = optimizer

    def loss_of(model, mb):
        if cfg.is_encoder_decoder:
            return encdec_loss(model, mb["frames"], mb["tokens"],
                               mb["labels"], cfg)
        return lm_loss(model, mb["tokens"], mb["labels"], cfg,
                       mb.get("patch_embeds"))

    def train_step(model, opt_state, step, batch):
        with tracing.span("train.step", step):
            model.requires_grad_(True)
            params = dict(model.named_parameters())
            for p in params.values():
                p.grad = None
            n = batch["tokens"].shape[0]
            if n % micro_batches:
                raise ValueError(f"batch of {n} does not split into "
                                 f"{micro_batches} micro-batches")
            part = n // micro_batches
            loss = torch.zeros((), dtype=torch.float32,
                               device=batch["tokens"].device)
            for i in range(micro_batches):
                mb = {k: v[i * part:(i + 1) * part] for k, v in batch.items()}
                with tracing.span("train.forward", step):
                    l = loss_of(model, mb)
                with tracing.span("train.backward", step):
                    l.backward()      # adds into .grad, in the params' dtype
                loss = loss + l.detach()
            grads = {}
            with tracing.span("train.grad_scale", step):
                for k, p in params.items():
                    g = p.grad if p.grad is not None else torch.zeros_like(p)
                    grads[k] = g.div_(micro_batches)
                    p.grad = None
            with tracing.span("train.optimizer", step,
                              device=batch["tokens"].device):
                opt_update(params, grads, opt_state, step)
            return model, opt_state, {"loss": loss / micro_batches}

    return train_step


def make_prefill_step(cfg: ModelConfig):
    """prefill(model, batch) -> the last position's logits (B, V) float32;
    ``batch`` holds ``tokens`` (B, S) and, for a VLM, ``patch_embeds``,
    for an encoder-decoder ``frames`` (B, T_enc, d). Only the last
    position goes through the head (the reference computes every
    position's logits and keeps the last)."""

    @torch.no_grad()
    def prefill(model, batch):
        if cfg.is_encoder_decoder:
            x = encdec_hidden(model, batch["frames"], batch["tokens"], cfg)
            return encdec_logits(model, x[:, -1, :])
        x, _ = lm_hidden(model, batch["tokens"], cfg,
                         batch.get("patch_embeds"))
        return lm_logits(model, x[:, -1, :], cfg)

    return prefill


def make_serve_step(cfg: ModelConfig):
    """serve_step(model, cache, token (B,1), index) -> (next token (B,1)
    int32, the greedy choice; cache). An encoder-decoder's cache is
    `init_encdec_cache`'s with ``cross_kv`` filled by the caller
    (`encode`, then `precompute_cross_kv`)."""
    decode = encdec_decode_step if cfg.is_encoder_decoder else lm_decode_step

    @torch.no_grad()
    def serve_step(model, cache, token, index):
        logits, cache = decode(model, cache, token, index, cfg)
        next_token = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
        return next_token[:, None], cache

    return serve_step
