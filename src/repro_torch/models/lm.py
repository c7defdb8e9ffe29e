"""Unified decoder LM: a block pattern repeated over depth.

Covers dense GQA (phi3, deepseek-coder, qwen2.5), local/global alternation
with softcaps (gemma2), pure SSM (falcon-mamba) and the VLM backbone
(internvl2, with its patch-embedding stub), MoE (kimi-k2, llama4) and
the hybrid of attention, Mamba and MoE (jamba), and, opt-in through a
`JambaConfig`, AI21's Jamba block (norms in the Mamba mixer, attention
without RoPE, a tied head). An `LM` holds one module per layer in an
``nn.ModuleList`` and the depth loop is a Python loop; the reference
stacks each period's parameters and scans over them (layer ``p * period +
i`` here is stacked period ``p``, block ``i`` there). With remat each
layer is checkpointed, where the reference checkpoints each period: the
same numbers, one layer's activations live at a time. The encoder-decoder
(whisper) has its own assembly, `models.encdec`.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import tracing
from repro_torch.kernels.common import resolve_device
from repro_torch.models.config import BlockSpec, ModelConfig
from repro_torch.nn.attention import (attention_decode, attention_train,
                                      init_attention, init_kv_cache)
from repro_torch.nn.layers import (Params, embed, init_dense, init_embed,
                                   init_rmsnorm, rmsnorm)
from repro_torch.nn.layers import softcap as apply_softcap
from repro_torch.nn.mamba import (init_mamba, init_mamba_cache, mamba_decode,
                                  mamba_train)
from repro_torch.nn.moe import init_moe, init_swiglu, moe_apply, swiglu

def check_supported(cfg: ModelConfig) -> None:
    """Raise for a config this assembly does not build: an
    encoder-decoder (`models.encdec`), or an unknown block."""
    if cfg.is_encoder_decoder:
        raise ValueError(f"{cfg.name} is an encoder-decoder: build it with "
                         "models.encdec.init_encdec (its cache with "
                         "init_encdec_cache)")
    for spec in cfg.blocks:
        if spec.mixer not in ("attn", "attn_local", "mamba"):
            raise ValueError(spec.mixer)
        if spec.mlp not in ("dense", "moe", "none"):
            raise ValueError(spec.mlp)


class Block(Params):
    """One layer: ``ln1``, ``ln2``, the mixer (``attn`` or ``mamba``) and
    the MLP (``mlp``, or ``moe``; neither for ``mlp="none"``), with its
    `BlockSpec`."""

    def __init__(self, spec: BlockSpec, entries: dict):
        super().__init__(entries)
        self.spec = spec


class LM(nn.Module):
    """The model: ``embed``, ``layers`` (one `Block` per layer), ``ln_f``
    and ``head`` (None where Jamba's block ties it to the embedding);
    ``forward`` is `lm_apply`."""

    def __init__(self, cfg: ModelConfig, embed: Params, layers: list[Block],
                 ln_f: Params, head: Params | None):
        super().__init__()
        check_supported(cfg)
        if len(layers) != cfg.n_layers:
            raise ValueError(f"{len(layers)} layers for {cfg.n_layers}")
        if (head is None) != (cfg.jamba is not None):
            raise ValueError("a head leaf exactly where the block does not "
                             "tie it to the embedding (Jamba's does)")
        self.cfg = cfg
        self.embed = embed
        self.layers = nn.ModuleList(layers)
        self.ln_f = ln_f
        self.head = head

    def forward(self, tokens, patch_embeds=None):
        return lm_apply(self, tokens, self.cfg, patch_embeds)


# ---------------------------------------------------------------------------
# Init, and weights carried across from the reference
# ---------------------------------------------------------------------------

def _init_block(gen, cfg: ModelConfig, spec: BlockSpec, dtype,
                device) -> Block:
    kw = dict(dtype=dtype, device=device)
    p = {"ln1": init_rmsnorm(cfg.d_model, **kw),
         "ln2": init_rmsnorm(cfg.d_model, **kw)}
    if spec.mixer in ("attn", "attn_local"):
        p["attn"] = init_attention(gen, cfg.d_model, cfg.n_heads,
                                   cfg.n_kv_heads, cfg.head_dim_,
                                   cfg.qkv_bias, **kw)
    else:
        p["mamba"] = init_mamba(gen, cfg.d_model, cfg.d_inner, cfg.d_state,
                                cfg.d_conv, cfg.dt_rank, **kw,
                                mixer_norms=cfg.jamba is not None)
    if spec.mlp == "dense":
        p["mlp"] = init_swiglu(gen, cfg.d_model, cfg.d_ff, **kw)
    elif spec.mlp == "moe":
        # the router stays float32 (init_moe's own choice)
        p["moe"] = init_moe(gen, cfg.d_model, cfg.d_ff, cfg.n_experts,
                            cfg.top_k, cfg.n_shared_experts, **kw)
    return Block(spec, p)


def init_lm(cfg: ModelConfig, *, generator: torch.Generator, device=None,
            dtype=None) -> LM:
    """Random weights with the reference's distributions, drawn from
    `generator` (on its device) and placed on `device` (None: the GPU) in
    `dtype` (None: ``cfg.pdtype``)."""
    check_supported(cfg)
    device = resolve_device(device)
    dtype = cfg.pdtype if dtype is None else dtype
    kw = dict(dtype=dtype, device=device)
    emb = init_embed(generator, cfg.vocab_size, cfg.d_model, **kw)
    head = (None if cfg.jamba is not None else
            init_dense(generator, cfg.d_model, cfg.vocab_size, **kw))
    layers = [_init_block(generator, cfg, cfg.blocks[i % cfg.period], dtype,
                          device) for i in range(cfg.n_layers)]
    return LM(cfg, emb, layers, init_rmsnorm(cfg.d_model, **kw), head)


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":          # ml_dtypes' bfloat16
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _tree(node, device, pick=None) -> dict:
    """Nested dicts of arrays -> nested dicts of tensors; `pick` takes one
    index of a leading stacked axis."""
    return {k: _tree(v, device, pick) if isinstance(v, dict)
            else _tensor(v if pick is None else np.asarray(v)[pick], device)
            for k, v in node.items()}


def params_from_reference(cfg: ModelConfig, tree, device) -> LM:
    """An `LM` holding the reference's `init_lm` parameters: `tree` is its
    pytree as nested dicts and tuples of numpy arrays, each leaf of
    ``tree["layers"][i]`` with a leading ``n_periods`` axis. Stacked
    period ``p``, block ``i`` becomes layer ``p * period + i``. Jamba's
    block has no counterpart there."""
    check_supported(cfg)
    if cfg.jamba is not None:
        raise ValueError(f"{cfg.name}: the reference has no Jamba block")
    device = resolve_device(device)
    layers = [Block(spec, _tree(tree["layers"][i], device, pick=p))
              for p in range(cfg.n_periods)
              for i, spec in enumerate(cfg.blocks)]
    return LM(cfg, Params(_tree(tree["embed"], device)), layers,
              Params(_tree(tree["ln_f"], device)),
              Params(_tree(tree["head"], device)))


# ---------------------------------------------------------------------------
# Train / prefill forward
# ---------------------------------------------------------------------------

def _mixer_kw(cfg: ModelConfig, spec: BlockSpec) -> dict:
    if spec.mixer == "mamba":
        return dict(d_inner=cfg.d_inner, d_state=cfg.d_state,
                    d_conv=cfg.d_conv, dt_rank=cfg.dt_rank)
    return dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                head_dim=cfg.head_dim_, rope_theta=cfg.rope_theta,
                window=cfg.window if spec.mixer == "attn_local" else 0,
                attn_softcap=cfg.attn_softcap, use_rope=cfg.jamba is None)


def _mlp(p: Block, x, cfg: ModelConfig):
    """The block's MLP on ``rmsnorm(ln2, x)``: (h, the MoE aux loss or
    None)."""
    h = rmsnorm(p["ln2"], x)
    if p.spec.mlp == "dense":
        return swiglu(p["mlp"], h), None
    return moe_apply(p["moe"], h, n_experts=cfg.n_experts, top_k=cfg.top_k,
                     capacity_factor=cfg.capacity_factor)


def _block_train(p: Block, x, cfg: ModelConfig):
    """-> (x, the MoE aux loss or None). An attention mixer runs inside
    the span ``lm.attention`` (stream events on x's device), in the
    forward and in a remat's recompute."""
    spec = p.spec
    h = rmsnorm(p["ln1"], x)
    if spec.mixer == "mamba":
        h = mamba_train(p["mamba"], h, **_mixer_kw(cfg, spec))
    else:
        with tracing.span("lm.attention", device=x.device):
            h = attention_train(p["attn"], h, **_mixer_kw(cfg, spec))
    x = x + h
    if spec.mlp == "none":
        return x, None
    h, aux = _mlp(p, x, cfg)
    return x + h, aux


def lm_hidden(model: LM, tokens, cfg: ModelConfig, patch_embeds=None):
    """tokens: (B, S) -> hidden states (B, S, d) and the auxiliary loss
    (float32: the MoE layers' summed in layer order, as the reference's
    scan carries it; 0 without MoE). The reference's sharding constraints
    do nothing on one device and are left out. With ``cfg.remat`` and
    autograd recording, each layer runs under ``torch.utils.checkpoint``:
    its input is kept, its inside recomputed in the backward. The
    reference's ``jax.checkpoint`` wraps a whole period instead; the
    numbers are the same, and at most one layer's activations live at a
    time rather than a period's."""
    x = embed(model.embed, tokens).to(cfg.adtype)
    if cfg.frontend is not None and patch_embeds is not None:
        # VLM stub: precomputed frontend embeddings replace the first
        # n_frontend_tokens positions
        nf = patch_embeds.shape[1]
        x = torch.cat([patch_embeds.to(cfg.adtype), x[:, nf:]], dim=1)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    for layer in model.layers:
        if remat:
            x, a = checkpoint(_block_train, layer, x, cfg,
                              use_reentrant=False, preserve_rng_state=False)
        else:
            x, a = _block_train(layer, x, cfg)
        if a is not None:
            aux = aux + a
    return rmsnorm(model.ln_f, x), aux


def head_weight(model: LM):
    """The head's (d, V) matrix: ``head["w"]``, or the embedding's table
    transposed (a view) where Jamba's block ties them."""
    if model.head is None:
        return model.embed["table"].t()
    return model.head["w"]


def lm_logits(model: LM, x, cfg: ModelConfig):
    """Hidden states -> float32 logits (final softcap applied)."""
    logits = x @ head_weight(model)
    return apply_softcap(logits.float(), cfg.final_softcap)


def lm_apply(model: LM, tokens, cfg: ModelConfig, patch_embeds=None):
    """Full forward to logits (B, S, V)."""
    x, aux = lm_hidden(model, tokens, cfg, patch_embeds)
    return lm_logits(model, x, cfg), aux


def chunked_ce(x, head_w, labels, cfg: ModelConfig):
    """Mean next-token cross entropy of hidden states x (B, S, d) against
    labels (B, S): float32 logits with the final softcap, logsumexp minus
    the gold logit. Where ``cfg.loss_chunk`` divides S and is smaller, the
    sequence is cut into chunks of that many positions, one chunk's
    logits at a time, and the loss is the mean of the chunks' means (the
    reference's order)."""

    def ce(xc, yc):
        logits = apply_softcap((xc @ head_w).float(), cfg.final_softcap)
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, yc[..., None].long())[..., 0]
        return (logz - gold).mean()

    chunk, S = cfg.loss_chunk, x.shape[1]
    if chunk and S % chunk == 0 and S > chunk:
        total = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(0, S, chunk):
            total = total + ce(x[:, i:i + chunk], labels[:, i:i + chunk])
        return total / (S // chunk)
    return ce(x, labels)


def lm_loss(model: LM, tokens, labels, cfg: ModelConfig, patch_embeds=None):
    """Next-token cross entropy plus 0.01 x the MoE auxiliary loss."""
    x, aux = lm_hidden(model, tokens, cfg, patch_embeds)
    return chunked_ce(x, head_weight(model), labels, cfg) + 0.01 * aux


# ---------------------------------------------------------------------------
# Decode (KV/SSM caches, one token per step)
# ---------------------------------------------------------------------------

def init_lm_cache(cfg: ModelConfig, batch: int, max_len: int,
                  dtype=torch.bfloat16, device=None) -> list[dict]:
    """One cache per layer; attn_local layers keep a rolling window."""
    check_supported(cfg)
    device = resolve_device(device)
    caches = []
    for i in range(cfg.n_layers):
        spec = cfg.blocks[i % cfg.period]
        if spec.mixer == "attn":
            caches.append(init_kv_cache(batch, max_len, cfg.n_kv_heads,
                                        cfg.head_dim_, dtype, device))
        elif spec.mixer == "attn_local":
            caches.append(init_kv_cache(batch, min(cfg.window, max_len),
                                        cfg.n_kv_heads, cfg.head_dim_,
                                        dtype, device))
        else:
            caches.append(init_mamba_cache(batch, cfg.d_inner, cfg.d_state,
                                           cfg.d_conv, dtype, device))
    return caches


def lm_decode_step(model: LM, cache: list[dict], token, index,
                   cfg: ModelConfig):
    """token: (B,1) int; index: the current position (int). Returns
    (logits (B,1,V) float32, cache), the caches updated in place."""
    x = embed(model.embed, token).to(cfg.adtype)
    for layer, c in zip(model.layers, cache):
        spec = layer.spec
        h = rmsnorm(layer["ln1"], x)
        if spec.mixer == "mamba":
            h, _ = mamba_decode(layer["mamba"], h, c, **_mixer_kw(cfg, spec))
        else:
            h, _ = attention_decode(layer["attn"], h, c, index,
                                    **_mixer_kw(cfg, spec))
        x = x + h
        if spec.mlp != "none":
            x = x + _mlp(layer, x, cfg)[0]         # the aux loss is dropped
    return lm_logits(model, rmsnorm(model.ln_f, x), cfg), cache
