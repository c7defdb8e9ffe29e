"""Encoder-decoder model (whisper).

Two blocks, chosen by ``cfg.whisper`` (which only a `WhisperConfig` sets):

- None (the default): the reference's whisper-shaped backbone, equal to
  it. The conv frontend is a stub: callers pass precomputed frame
  embeddings (B, T_enc, d). Encoder: bidirectional attention and a SwiGLU
  MLP under RMSNorm. Decoder: causal self-attention with RoPE, cross
  attention and the same MLP. An untied head.
- a `WhisperBlock`: whisper's own equations (arXiv:2212.04356). Callers
  pass log-mel frames (B, n_mels, 2 T_enc); two Conv1d + GELU (the second
  of stride 2) map them to T_enc positions, to which fixed sinusoids are
  added. Each sub-layer is ``x + f(layernorm(x))`` with LayerNorm's bias;
  attention has q, v and out biases and none on k; the MLP is
  ``fc2(gelu(fc1(x)))`` with biases; the encoder ends in ``ln_enc``
  (whisper's ``ln_post``). The decoder adds learned positions to the token
  embedding (no RoPE), ends in ``ln_f`` and reads its logits through the
  token embedding (a tied head). Training and prefill only: decoding with
  this block raises NotImplementedError.

Each stack is a ``nn.ModuleList`` of one `Params` per layer, as the
reference's lists of layer dicts are, and the depth loop is a Python loop.
The encoder runs in the span ``encdec.encode`` (the front end in
``encdec.frontend`` within it) and the decoder stack in ``encdec.decode``,
both timing the device's stream (`repro_torch.tracing`).

Decode writes the decoder's self-attention cache in place (through the
flash-decode kernel on CUDA tensors, `attention_decode`); the cross
attention at decode is the plain `_sdpa` over K/V computed once from the
encoder's output (`precompute_cross_kv`), as the reference's is.
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import tracing
from repro_torch.kernels.common import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.lm import _tree, chunked_ce
from repro_torch.nn.attention import (_full_mask, _sdpa, attention_decode,
                                      attention_train, bidir_attention_train,
                                      cross_attention_train, init_attention,
                                      init_kv_cache)
from repro_torch.nn.layers import (Params, dense, embed, init_dense,
                                   init_embed, init_layernorm, init_rmsnorm,
                                   layernorm, normal, rmsnorm)
from repro_torch.nn.moe import init_swiglu, swiglu


def _n_enc(cfg: ModelConfig) -> int:
    return cfg.n_enc_layers or cfg.n_layers


def sinusoids(length: int, channels: int, device=None) -> torch.Tensor:
    """whisper's fixed encoder positions (length, channels) float32: the
    sines, then the cosines, of ``t / 10000^(i / (channels / 2 - 1))``."""
    inc = math.log(10000) / (channels // 2 - 1)
    inv = torch.exp(-inc * torch.arange(channels // 2, dtype=torch.float32,
                                        device=device))
    t = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    return torch.cat([torch.sin(t * inv), torch.cos(t * inv)], dim=1)


class EncDec(nn.Module):
    """The model: ``embed``, ``enc`` and ``dec`` (one `Params` a layer,
    under the reference's keys: ``ln1``, ``attn``, ``ln2``, ``mlp``, and
    in the decoder ``lnx`` and ``xattn``), ``ln_enc``, ``ln_f`` and
    ``head``; ``forward`` is `encdec_apply`. With whisper's block
    (``cfg.whisper``) ``embed`` also holds the decoder's learned positions
    (``pos``), ``frontend`` the two convolutions (``conv1``, ``conv2``:
    ``w`` (d_out, d_in, 3) and ``b``), ``head`` is None (tied to
    ``embed.table``), and the buffer ``enc_pos`` holds the encoder's
    sinusoids."""

    def __init__(self, cfg: ModelConfig, embed: Params, enc: list[Params],
                 dec: list[Params], ln_enc: Params, ln_f: Params,
                 head: Params | None, frontend: Params | None = None):
        super().__init__()
        if not cfg.is_encoder_decoder:
            raise ValueError(f"{cfg.name} is not an encoder-decoder: build "
                             "it with models.lm.init_lm")
        if (len(enc), len(dec)) != (_n_enc(cfg), cfg.n_layers):
            raise ValueError(f"{len(enc)} + {len(dec)} layers for "
                             f"{_n_enc(cfg)} + {cfg.n_layers}")
        whisper = cfg.whisper is not None
        if (frontend is not None) != whisper or (head is None) != whisper:
            raise ValueError("whisper's block takes a front end and no head "
                             "(it is tied), the reference's block a head "
                             "and no front end")
        self.cfg = cfg
        self.embed = embed
        self.frontend = frontend
        self.enc = nn.ModuleList(enc)
        self.dec = nn.ModuleList(dec)
        self.ln_enc = ln_enc
        self.ln_f = ln_f
        self.head = head
        if whisper:
            self.register_buffer("enc_pos", sinusoids(
                cfg.enc_context, cfg.d_model, embed["table"].device),
                persistent=False)

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


def _whisper_attn(gen, cfg: ModelConfig, kw) -> Params:
    d, inner = cfg.d_model, cfg.n_heads * cfg.head_dim_
    return Params(wq=init_dense(gen, d, inner, True, **kw),
                  wk=init_dense(gen, d, inner, False, **kw),
                  wv=init_dense(gen, d, inner, True, **kw),
                  wo=init_dense(gen, inner, d, True, **kw))


def _init_whisper_layer(gen, cfg: ModelConfig, decoder: bool, kw) -> Params:
    d = cfg.d_model
    p = {"ln1": init_layernorm(d, **kw), "attn": _whisper_attn(gen, cfg, kw)}
    if decoder:
        p["lnx"] = init_layernorm(d, **kw)
        p["xattn"] = _whisper_attn(gen, cfg, kw)
    p["ln2"] = init_layernorm(d, **kw)
    p["mlp"] = {"fc1": init_dense(gen, d, cfg.d_ff, True, **kw),
                "fc2": init_dense(gen, cfg.d_ff, d, True, **kw)}
    return Params(p)


def _init_whisper(cfg: ModelConfig, gen, kw) -> EncDec:
    """whisper's block: matrices N(0, 1 / fan_in) (a convolution's fan_in
    is d_in x 3), the token embedding and the decoder's positions N(0, 1 /
    d) (the head is tied: the logits start at unit scale), biases 0,
    LayerNorms 1 and 0."""
    d, w = cfg.d_model, cfg.whisper
    emb = Params(table=normal(gen, (cfg.vocab_size, d), d ** -0.5, **kw),
                 pos=normal(gen, (w.max_target_positions, d), d ** -0.5,
                            **kw))
    front = {name: {"w": normal(gen, (d, d_in, 3), (3 * d_in) ** -0.5, **kw),
                    "b": torch.zeros((d,), **kw)}
             for name, d_in in (("conv1", w.n_mels), ("conv2", d))}
    enc = [_init_whisper_layer(gen, cfg, False, kw)
           for _ in range(_n_enc(cfg))]
    dec = [_init_whisper_layer(gen, cfg, True, kw)
           for _ in range(cfg.n_layers)]
    return EncDec(cfg, emb, enc, dec, init_layernorm(d, **kw),
                  init_layernorm(d, **kw), None, Params(front))


def init_encdec(cfg: ModelConfig, *, generator: torch.Generator,
                device=None, dtype=None) -> EncDec:
    """Random weights with the reference's distributions (whisper's block:
    `_init_whisper`'s), drawn from `generator` (on its device) and placed
    on `device` (None: the GPU) in `dtype` (None: ``cfg.pdtype``)."""
    device = resolve_device(device)
    dtype = cfg.pdtype if dtype is None else dtype
    kw = dict(dtype=dtype, device=device)
    if cfg.whisper is not None:
        return _init_whisper(cfg, generator, kw)
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


def _gelu_mlp(p, x):
    return dense(p["fc2"], F.gelu(dense(p["fc1"], x)))


def _whisper_enc_layer(p, x, cfg: ModelConfig):
    ln = _norm(cfg)
    x = x + bidir_attention_train(p["attn"], ln(p["ln1"], x), **_heads(cfg))
    return x + _gelu_mlp(p["mlp"], ln(p["ln2"], x))


def _whisper_dec_layer(p, x, ctx, cfg: ModelConfig):
    ln = _norm(cfg)
    x = x + attention_train(p["attn"], ln(p["ln1"], x), use_rope=False,
                            **_heads(cfg))
    x = x + cross_attention_train(p["xattn"], ln(p["lnx"], x), ctx,
                                  **_heads(cfg))
    return x + _gelu_mlp(p["mlp"], ln(p["ln2"], x))


def _norm(cfg: ModelConfig):
    """The block's norm: RMSNorm, or whisper's LayerNorm (eps 1e-5)."""
    return rmsnorm if cfg.whisper is None else layernorm


def _layer(fn, remat: bool, *args):
    """``fn(*args)``; with `remat` and autograd recording under
    ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint`` of a
    layer): only the layer's inputs are kept, its inside recomputed in
    backward."""
    if remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return fn(*args)


def _frontend(model: EncDec, mel, cfg: ModelConfig):
    """Log-mel frames (B, n_mels, 2 T) -> (B, T, d): two Conv1d + GELU
    (kernel 3, padding 1; the second of stride 2), then the sinusoids."""
    f = model.frontend
    x = mel.to(cfg.adtype)
    x = F.gelu(F.conv1d(x, f["conv1"]["w"], f["conv1"]["b"], padding=1))
    x = F.gelu(F.conv1d(x, f["conv2"]["w"], f["conv2"]["b"], stride=2,
                        padding=1))
    T = x.shape[2]
    if T > cfg.enc_context:
        raise ValueError(f"{mel.shape[2]} frames give {T} positions, over "
                         f"the encoder's {cfg.enc_context}")
    return x.transpose(1, 2) + model.enc_pos[:T].to(x.dtype)


def encode(model: EncDec, frames, cfg: ModelConfig):
    """frames: (B, T_enc, d) precomputed frame embeddings (stub frontend),
    or with whisper's block log-mel frames (B, n_mels, 2 T_enc) -> the
    encoder's output (B, T_enc, d)."""
    dev = frames.device
    with tracing.span("encdec.encode", device=dev):
        if cfg.whisper is None:
            x, layer = frames.to(cfg.adtype), _enc_layer
        else:
            with tracing.span("encdec.frontend", device=dev):
                x = _frontend(model, frames, cfg)
            layer = _whisper_enc_layer
        for p in model.enc:
            x = _layer(layer, cfg.remat, p, x, cfg)
        return _norm(cfg)(model.ln_enc, x)


def encdec_hidden(model: EncDec, frames, tokens, cfg: ModelConfig,
                  remat_decoder: bool = False):
    """(frames (B, Te, d), or log-mel frames with whisper's block; tokens
    (B, Td)) -> the decoder's final hidden states (B, Td, d). The
    encoder's layers take ``cfg.remat``; the decoder's only with
    `remat_decoder`, which `encdec_loss` sets, as the reference's
    `encdec_loss` remats them and its `encdec_apply` does not."""
    ctx = encode(model, frames, cfg)
    with tracing.span("encdec.decode", device=tokens.device):
        x = embed(model.embed, tokens).to(cfg.adtype)
        layer = _dec_layer
        if cfg.whisper is not None:
            S = tokens.shape[1]
            if S > cfg.whisper.max_target_positions:
                raise ValueError(f"{S} tokens, over the decoder's "
                                 f"{cfg.whisper.max_target_positions} "
                                 "positions")
            x = x + model.embed["pos"][:S].to(x.dtype)
            layer = _whisper_dec_layer
        for p in model.dec:
            x = _layer(layer, remat_decoder and cfg.remat, p, x, ctx, cfg)
        return _norm(cfg)(model.ln_f, x)


def _head_w(model: EncDec):
    """The head (d, V); whisper's block reads the token embedding."""
    if model.head is None:
        return model.embed["table"].t()
    return model.head["w"]


def encdec_logits(model: EncDec, x):
    """Hidden states -> float32 logits."""
    return (x @ _head_w(model)).float()


def encdec_apply(model: EncDec, frames, tokens, cfg: ModelConfig):
    """Training forward: (frames (B,Te,d), tokens (B,Td)) -> (logits
    (B, Td, V) float32, a float32 0: no auxiliary loss)."""
    x = encdec_hidden(model, frames, tokens, cfg)
    return encdec_logits(model, x), torch.zeros((), dtype=torch.float32,
                                                device=x.device)


def encdec_loss(model: EncDec, frames, tokens, labels, cfg: ModelConfig):
    """Mean next-token cross entropy (`lm.chunked_ce`)."""
    x = encdec_hidden(model, frames, tokens, cfg, remat_decoder=True)
    return chunked_ce(x, _head_w(model), labels, cfg)


# ---------------------------------------------------------------------------
# Decode (a self-attention cache a decoder layer, fixed cross K/V)
# ---------------------------------------------------------------------------

def _decodes(cfg: ModelConfig) -> None:
    if cfg.whisper is not None:
        raise NotImplementedError(
            f"{cfg.name}: decoding with whisper's own block (learned "
            "positions, LayerNorm, biases, a tied head) is not implemented; "
            "its training and prefill are")


def init_encdec_cache(cfg: ModelConfig, batch: int, max_len: int,
                      dtype=torch.bfloat16, device=None) -> dict:
    """``self``: a KV cache of `max_len` slots a decoder layer;
    ``cross_kv``: ``enc_context`` slots a decoder layer, which the caller
    replaces with `precompute_cross_kv`'s."""
    _decodes(cfg)
    device = resolve_device(device)

    def caches(n_slots):
        return [init_kv_cache(batch, n_slots, cfg.n_kv_heads, cfg.head_dim_,
                              dtype, device) for _ in range(cfg.n_layers)]
    return {"self": caches(max_len), "cross_kv": caches(cfg.enc_context)}


def precompute_cross_kv(model: EncDec, ctx, cfg: ModelConfig,
                        dtype=torch.bfloat16) -> list[dict]:
    """The cross attention's K/V of every decoder layer from the
    encoder's output ctx (B, T, d), once, in `dtype`."""
    _decodes(cfg)
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
    _decodes(cfg)
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
