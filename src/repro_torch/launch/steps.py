"""Step factories: prefill and greedy decode against the KV/SSM caches,
for every decoder the port runs (dense, local/global, Mamba, the VLM
backbone, MoE and the hybrid). A MoE model's prefill and decode drop the
layers' auxiliary loss, as the reference's do.

The training step comes with the training slice (ROADMAP.md queue 1, item
14 (a)).
"""

from __future__ import annotations

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.lm import (ENCDEC_TODO, lm_decode_step, lm_hidden,
                                   lm_logits)


def make_prefill_step(cfg: ModelConfig):
    """prefill(model, batch) -> the last position's logits (B, V) float32;
    ``batch`` holds ``tokens`` (B, S) and, for a VLM, ``patch_embeds``.
    Only the last position goes through the head (the reference computes
    every position's logits and keeps the last)."""
    if cfg.is_encoder_decoder:
        raise NotImplementedError(ENCDEC_TODO)

    def prefill(model, batch):
        x, _ = lm_hidden(model, batch["tokens"], cfg,
                         batch.get("patch_embeds"))
        return lm_logits(model, x[:, -1, :], cfg)

    return prefill


def make_serve_step(cfg: ModelConfig):
    """serve_step(model, cache, token (B,1), index) -> (next token (B,1)
    int32, the greedy choice; cache)."""
    if cfg.is_encoder_decoder:
        raise NotImplementedError(ENCDEC_TODO)

    def serve_step(model, cache, token, index):
        logits, cache = lm_decode_step(model, cache, token, index, cfg)
        next_token = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
        return next_token[:, None], cache

    return serve_step
