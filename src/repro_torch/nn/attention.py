"""GQA attention: prefill (causal, optional sliding window and softcap),
the encoder-decoder's cross and bidirectional forms (no mask, no RoPE),
and decode (one token against a KV cache through the flash-decode
kernel). Each prefill and training form takes the blocked attention
(`nn.flash`) by `_blocked`: on the CPU where the reference does, at S >=
FLASH_THRESHOLD with S % 1024 == 0 (and, for the cross form, T % 1024 ==
0); on CUDA tensors at any lengths wherever the kernel takes the head
size and type, its tiles' tails masked in the kernel (a deliberate
difference from the reference, whose blocked attention refuses such
lengths). A CUDA call that takes the plain `_sdpa` instead is counted as
``attn.plain_calls`` (`repro_torch.tracing`)."""

from __future__ import annotations

import torch

from repro_torch import tracing
from repro_torch.kernels.decode_attn import decode_attention
from repro_torch.kernels.flash_attn import ops as flash_ops
from repro_torch.nn.layers import Params, dense, init_dense, softcap
from repro_torch.nn.rope import apply_rope

NEG_INF = -1e30


def init_attention(gen, d_model: int, n_heads: int, n_kv_heads: int,
                   head_dim: int, qkv_bias: bool = False,
                   dtype=torch.float32, device=None) -> Params:
    kw = dict(dtype=dtype, device=device)
    return Params(
        wq=init_dense(gen, d_model, n_heads * head_dim, qkv_bias, **kw),
        wk=init_dense(gen, d_model, n_kv_heads * head_dim, qkv_bias, **kw),
        wv=init_dense(gen, d_model, n_kv_heads * head_dim, qkv_bias, **kw),
        wo=init_dense(gen, n_heads * head_dim, d_model, False, **kw))


def _qkv(p, x, n_heads, n_kv_heads, head_dim):
    B, S, _ = x.shape
    q = dense(p["wq"], x).reshape(B, S, n_heads, head_dim)
    k = dense(p["wk"], x).reshape(B, S, n_kv_heads, head_dim)
    v = dense(p["wv"], x).reshape(B, S, n_kv_heads, head_dim)
    return q, k, v


def _sdpa(q, k, v, mask, attn_softcap: float = 0.0):
    """q: (B,S,H,dh); k,v: (B,T,Hkv,dh); mask broadcastable to
    (B,Hkv,G,S,T) via trailing (S,T) dims."""
    B, S, H, dh = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    if q.is_cuda:
        tracing.count("attn.plain_calls", 1)
    qg = q.reshape(B, S, Hkv, G, dh)
    scores = torch.einsum("bshgd,bthd->bhgst", qg.float(),
                          k.float()) * (dh ** -0.5)
    scores = softcap(scores, attn_softcap)
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgst,bthd->bshgd", probs, v.float())
    return out.reshape(B, S, H, dh).to(q.dtype)


def causal_mask(S: int, window: int = 0, device=None):
    """(1, S, S) causal mask; window>0 adds a sliding-window band."""
    i = torch.arange(S, device=device)[:, None]
    j = torch.arange(S, device=device)[None, :]
    m = j <= i
    if window > 0:
        m = m & (j > i - window)
    return m[None]


# on the CPU, sequences at or above this length take the blocked (flash)
# path
FLASH_THRESHOLD = 2048


def _blocked(q, k) -> bool:
    """Whether a prefill or training attention with queries q (B, S, H,
    dh) and keys k (B, T, Hkv, dh) takes the blocked attention: on CUDA
    tensors whenever the kernel takes the head size and type
    (`flash_ops.takes`), at any lengths; otherwise the reference's rule, S
    >= FLASH_THRESHOLD with S and T multiples of 1,024."""
    if q.is_cuda and flash_ops.takes(q.shape[-1], q.dtype):
        return True
    S, T = q.shape[1], k.shape[1]
    return S >= FLASH_THRESHOLD and S % 1024 == 0 and T % 1024 == 0


def attention_train(p, x, *, n_heads, n_kv_heads, head_dim, rope_theta=1e4,
                    window: int = 0, attn_softcap: float = 0.0,
                    positions=None, use_rope: bool = True):
    B, S, _ = x.shape
    q, k, v = _qkv(p, x, n_heads, n_kv_heads, head_dim)
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    if use_rope:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    if _blocked(q, k):
        from repro_torch.nn.flash import flash_attention
        out = flash_attention(q, k, v, causal=True, window=window,
                              softcap=attn_softcap)
    else:
        mask = causal_mask(S, window, x.device)[:, None]   # (1,1,S,T)
        out = _sdpa(q, k, v, mask, attn_softcap)
    return dense(p["wo"], out.reshape(B, S, n_heads * head_dim))


def _full_mask(S: int, T: int, device):
    return torch.ones((1, 1, S, T), dtype=torch.bool, device=device)


def cross_attention_train(p, x, ctx, *, n_heads, n_kv_heads, head_dim):
    """Encoder-decoder cross attention (no mask, no rope): queries from x
    (B, S, d), keys and values from ctx (B, T, d)."""
    B, S, _ = x.shape
    T = ctx.shape[1]
    q = dense(p["wq"], x).reshape(B, S, n_heads, head_dim)
    k = dense(p["wk"], ctx).reshape(B, T, n_kv_heads, head_dim)
    v = dense(p["wv"], ctx).reshape(B, T, n_kv_heads, head_dim)
    if _blocked(q, k):
        from repro_torch.nn.flash import flash_attention
        out = flash_attention(q, k, v, causal=False)
    else:
        out = _sdpa(q, k, v, _full_mask(S, T, x.device))
    return dense(p["wo"], out.reshape(B, S, n_heads * head_dim))


def bidir_attention_train(p, x, *, n_heads, n_kv_heads, head_dim):
    """Encoder self-attention (bidirectional, no rope - whisper style)."""
    B, S, _ = x.shape
    q, k, v = _qkv(p, x, n_heads, n_kv_heads, head_dim)
    if _blocked(q, k):
        from repro_torch.nn.flash import flash_attention
        out = flash_attention(q, k, v, causal=False)
    else:
        out = _sdpa(q, k, v, _full_mask(S, S, x.device))
    return dense(p["wo"], out.reshape(B, S, n_heads * head_dim))


# ---------------------------------------------------------------------------
# Decode path (KV cache, one token)
# ---------------------------------------------------------------------------

def init_kv_cache(batch: int, max_len: int, n_kv_heads: int, head_dim: int,
                  dtype=torch.bfloat16, device=None) -> dict:
    shape = (batch, max_len, n_kv_heads, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def attention_decode(p, x, cache, index, *, n_heads, n_kv_heads, head_dim,
                     rope_theta=1e4, window: int = 0,
                     attn_softcap: float = 0.0, use_rope: bool = True):
    """One-token decode. x: (B, 1, d); cache k/v: (B, S_max, Hkv, dh);
    index: int (or 0-d tensor) - current length (position of the new
    token).

    For window > 0 the cache is a rolling buffer of size window (the
    gemma2 local layers); positions are still absolute via `index`. The
    new key and value are written into the cache IN PLACE (a copy into
    slot `index`, or `index % S_max` for a rolling buffer), where the
    reference returns a rebuilt cache; the attention itself is the
    flash-decode kernel on CUDA tensors and its plain version on the CPU.
    Returns (out (B,1,d), cache).
    """
    B = x.shape[0]
    index = int(index)
    S_max = cache["k"].shape[1]
    q = dense(p["wq"], x).reshape(B, 1, n_heads, head_dim)
    k_new = dense(p["wk"], x).reshape(B, 1, n_kv_heads, head_dim)
    v_new = dense(p["wv"], x).reshape(B, 1, n_kv_heads, head_dim)
    if use_rope:
        pos = torch.full((B, 1), index, dtype=torch.int32, device=x.device)
        q = apply_rope(q, pos, rope_theta)
        k_new = apply_rope(k_new, pos, rope_theta)
    slot = index % S_max if window > 0 else index
    cache["k"][:, slot] = k_new[:, 0]
    cache["v"][:, slot] = v_new[:, 0]
    length = min(index + 1, S_max)
    out = decode_attention(q[:, 0], cache["k"], cache["v"], length,
                           softcap=attn_softcap)
    out = dense(p["wo"], out.reshape(B, 1, n_heads * head_dim))
    return out, cache
