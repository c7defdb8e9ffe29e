"""Encoder-decoder model (the whisper-base backbone).

The conv frontend is a stub, as in the reference: callers pass
precomputed frame embeddings (B, T_enc, d). Encoder: bidirectional
attention and a dense MLP. Decoder: causal self-attention, cross
attention and a dense MLP. The layers are few (6 + 6), so each stack is a
``nn.ModuleList`` of one `Params` per layer, as the reference's lists of
layer dicts are, and the depth loop is a Python loop.

Decode writes the decoder's self-attention cache in place (through the
flash-decode kernel on CUDA tensors, `attention_decode`); the cross
attention at decode is the plain `_sdpa` over K/V computed once from the
encoder's output (`precompute_cross_kv`), as the reference's is.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.common import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.lm import _tree, chunked_ce
from repro_torch.nn.attention import (_full_mask, _sdpa, attention_decode,
                                      attention_train, bidir_attention_train,
                                      cross_attention_train, init_attention,
                                      init_kv_cache)
from repro_torch.nn.layers import (Params, dense, embed, init_dense,
                                   init_embed, init_rmsnorm, rmsnorm)
from repro_torch.nn.moe import init_swiglu, swiglu


def _n_enc(cfg: ModelConfig) -> int:
    return cfg.n_enc_layers or cfg.n_layers


class EncDec(nn.Module):
    """The model: ``embed``, ``enc`` and ``dec`` (one `Params` a layer,
    under the reference's keys: ``ln1``, ``attn``, ``ln2``, ``mlp``, and
    in the decoder ``lnx`` and ``xattn``), ``ln_enc``, ``ln_f`` and
    ``head``; ``forward`` is `encdec_apply`."""

    def __init__(self, cfg: ModelConfig, embed: Params, enc: list[Params],
                 dec: list[Params], ln_enc: Params, ln_f: Params,
                 head: Params):
        super().__init__()
        if not cfg.is_encoder_decoder:
            raise ValueError(f"{cfg.name} is not an encoder-decoder: build "
                             "it with models.lm.init_lm")
        if (len(enc), len(dec)) != (_n_enc(cfg), cfg.n_layers):
            raise ValueError(f"{len(enc)} + {len(dec)} layers for "
                             f"{_n_enc(cfg)} + {cfg.n_layers}")
        self.cfg = cfg
        self.embed = embed
        self.enc = nn.ModuleList(enc)
        self.dec = nn.ModuleList(dec)
        self.ln_enc = ln_enc
        self.ln_f = ln_f
        self.head = head

    def forward(self, frames, tokens):
        return encdec_apply(self, frames, tokens, self.cfg)


# ---------------------------------------------------------------------------
# Init, and weights carried across from the reference
# ---------------------------------------------------------------------------

def _attn(gen, cfg: ModelConfig, kw) -> Params:
    return init_attention(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                          cfg.head_dim_, False, **kw)


def _init_layer(gen, cfg: ModelConfig, decoder: bool, kw) -> Params:
    p = {"ln1": init_rmsnorm(cfg.d_model, **kw), "attn": _attn(gen, cfg, kw)}
    if decoder:
        p["lnx"] = init_rmsnorm(cfg.d_model, **kw)
        p["xattn"] = _attn(gen, cfg, kw)
    p["ln2"] = init_rmsnorm(cfg.d_model, **kw)
    p["mlp"] = init_swiglu(gen, cfg.d_model, cfg.d_ff, **kw)
    return Params(p)


def init_encdec(cfg: ModelConfig, *, generator: torch.Generator,
                device=None, dtype=None) -> EncDec:
    """Random weights with the reference's distributions, drawn from
    `generator` (on its device) and placed on `device` (None: the GPU) in
    `dtype` (None: ``cfg.pdtype``)."""
    device = resolve_device(device)
    dtype = cfg.pdtype if dtype is None else dtype
    kw = dict(dtype=dtype, device=device)
    emb = init_embed(generator, cfg.vocab_size, cfg.d_model, **kw)
    enc = [_init_layer(generator, cfg, False, kw) for _ in range(_n_enc(cfg))]
    dec = [_init_layer(generator, cfg, True, kw)
           for _ in range(cfg.n_layers)]
    head = init_dense(generator, cfg.d_model, cfg.vocab_size, **kw)
    return EncDec(cfg, emb, enc, dec, init_rmsnorm(cfg.d_model, **kw),
                  init_rmsnorm(cfg.d_model, **kw), head)


def encdec_params_from_reference(cfg: ModelConfig, tree, device) -> EncDec:
    """An `EncDec` holding the reference's `init_encdec` parameters:
    `tree` is its pytree as nested dicts and lists of numpy arrays (the
    layer lists are not stacked)."""
    device = resolve_device(device)
    return EncDec(cfg, Params(_tree(tree["embed"], device)),
                  [Params(_tree(p, device)) for p in tree["enc"]],
                  [Params(_tree(p, device)) for p in tree["dec"]],
                  Params(_tree(tree["ln_enc"], device)),
                  Params(_tree(tree["ln_f"], device)),
                  Params(_tree(tree["head"], device)))


# ---------------------------------------------------------------------------
# Train / prefill forward
# ---------------------------------------------------------------------------

def _heads(cfg: ModelConfig) -> dict:
    return dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                head_dim=cfg.head_dim_)


def _enc_layer(p, x, cfg: ModelConfig):
    x = x + bidir_attention_train(p["attn"], rmsnorm(p["ln1"], x),
                                  **_heads(cfg))
    return x + swiglu(p["mlp"], rmsnorm(p["ln2"], x))


def _dec_layer(p, x, ctx, cfg: ModelConfig):
    x = x + attention_train(p["attn"], rmsnorm(p["ln1"], x),
                            rope_theta=cfg.rope_theta, **_heads(cfg))
    x = x + cross_attention_train(p["xattn"], rmsnorm(p["lnx"], x), ctx,
                                  **_heads(cfg))
    return x + swiglu(p["mlp"], rmsnorm(p["ln2"], x))


def _layer(fn, remat: bool, *args):
    """``fn(*args)``; with `remat` and autograd recording under
    ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint`` of a
    layer): only the layer's inputs are kept, its inside recomputed in
    backward."""
    if remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return fn(*args)


def encode(model: EncDec, frames, cfg: ModelConfig):
    """frames: (B, T_enc, d) precomputed frame embeddings (stub frontend)
    -> the encoder's output (B, T_enc, d)."""
    x = frames.to(cfg.adtype)
    for p in model.enc:
        x = _layer(_enc_layer, cfg.remat, p, x, cfg)
    return rmsnorm(model.ln_enc, x)


def encdec_hidden(model: EncDec, frames, tokens, cfg: ModelConfig,
                  remat_decoder: bool = False):
    """(frames (B, Te, d), tokens (B, Td)) -> the decoder's final hidden
    states (B, Td, d). The encoder's layers take ``cfg.remat``; the
    decoder's only with `remat_decoder`, which `encdec_loss` sets, as the
    reference's `encdec_loss` remats them and its `encdec_apply` does
    not."""
    ctx = encode(model, frames, cfg)
    x = embed(model.embed, tokens).to(cfg.adtype)
    for p in model.dec:
        x = _layer(_dec_layer, remat_decoder and cfg.remat, p, x, ctx, cfg)
    return rmsnorm(model.ln_f, x)


def encdec_logits(model: EncDec, x):
    """Hidden states -> float32 logits."""
    return (x @ model.head["w"]).float()


def encdec_apply(model: EncDec, frames, tokens, cfg: ModelConfig):
    """Training forward: (frames (B,Te,d), tokens (B,Td)) -> (logits
    (B, Td, V) float32, a float32 0: no auxiliary loss)."""
    x = encdec_hidden(model, frames, tokens, cfg)
    return encdec_logits(model, x), torch.zeros((), dtype=torch.float32,
                                                device=x.device)


def encdec_loss(model: EncDec, frames, tokens, labels, cfg: ModelConfig):
    """Mean next-token cross entropy (`lm.chunked_ce`)."""
    x = encdec_hidden(model, frames, tokens, cfg, remat_decoder=True)
    return chunked_ce(x, model.head["w"], labels, cfg)


# ---------------------------------------------------------------------------
# Decode (a self-attention cache a decoder layer, fixed cross K/V)
# ---------------------------------------------------------------------------

def init_encdec_cache(cfg: ModelConfig, batch: int, max_len: int,
                      dtype=torch.bfloat16, device=None) -> dict:
    """``self``: a KV cache of `max_len` slots a decoder layer;
    ``cross_kv``: ``enc_context`` slots a decoder layer, which the caller
    replaces with `precompute_cross_kv`'s."""
    device = resolve_device(device)

    def caches(n_slots):
        return [init_kv_cache(batch, n_slots, cfg.n_kv_heads, cfg.head_dim_,
                              dtype, device) for _ in range(cfg.n_layers)]
    return {"self": caches(max_len), "cross_kv": caches(cfg.enc_context)}


def precompute_cross_kv(model: EncDec, ctx, cfg: ModelConfig,
                        dtype=torch.bfloat16) -> list[dict]:
    """The cross attention's K/V of every decoder layer from the
    encoder's output ctx (B, T, d), once, in `dtype`."""
    B, T, _ = ctx.shape
    shape = (B, T, cfg.n_kv_heads, cfg.head_dim_)
    return [{"k": dense(p["xattn"]["wk"], ctx).reshape(shape).to(dtype),
             "v": dense(p["xattn"]["wv"], ctx).reshape(shape).to(dtype)}
            for p in model.dec]


def encdec_decode_step(model: EncDec, cache: dict, token, index,
                       cfg: ModelConfig):
    """One decoder token (B, 1) at position `index` (int) against the
    self caches and the fixed cross K/V. Returns (logits (B, 1, V)
    float32, cache), the self caches updated in place."""
    x = embed(model.embed, token).to(cfg.adtype)
    B, H, hd = x.shape[0], cfg.n_heads, cfg.head_dim_
    for p, self_kv, cross in zip(model.dec, cache["self"], cache["cross_kv"]):
        h, _ = attention_decode(p["attn"], rmsnorm(p["ln1"], x), self_kv,
                                index, rope_theta=cfg.rope_theta,
                                **_heads(cfg))
        x = x + h
        q = dense(p["xattn"]["wq"], rmsnorm(p["lnx"], x)).reshape(B, 1, H, hd)
        h = _sdpa(q, cross["k"], cross["v"],
                  _full_mask(1, cross["k"].shape[1], x.device))
        x = x + dense(p["xattn"]["wo"], h.reshape(B, 1, H * hd))
        x = x + swiglu(p["mlp"], rmsnorm(p["ln2"], x))
    return encdec_logits(model, rmsnorm(model.ln_f, x)), cache
