"""Blocked (flash-style) attention: the prefill and training memory fix.

The largest live intermediate stays at a block pair instead of (B, H, S, S).
The math is `_sdpa`'s. The reference's version is plain jnp (a jitted
nested `lax.scan`, not a Pallas kernel). Here a CPU tensor takes the plain
loop over (q_block x kv_block) pairs, `flash_attention_fwd_ref`, which
autograd differentiates, and refuses lengths that are not multiples of
the blocks, as the reference does; a CUDA tensor takes the hand-written
kernel (``kernels/flash_attn``, ``csrc/flash_attn.cu``) with its own
backward, at any lengths: the kernel's tiles are its own and it masks
their tails. A caller that names `q_block` / `kv_block` on the card asks
for the reference's refusal of lengths that are not multiples of them.

GQA: each KV head serves its G = H / Hkv query heads.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attn import ops as flash_ops


Q_BLOCK, KV_BLOCK = 256, 1024     # the plain loop's (the reference's) blocks


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0, q_block: int | None = None,
                    kv_block: int | None = None):
    """q: (B,Sq,H,dh); k,v: (B,Skv,Hkv,dh) -> (B,Sq,H,dh) in q's type. On
    CUDA tensors the kernel, through `FlashAttention` where autograd
    records and an input needs a gradient; a call it does not take
    raises. The blocks default to Q_BLOCK, KV_BLOCK."""
    if not flash_ops.on_gpu(q, k, v):
        return flash_ops.flash_attention_fwd_ref(
            q, k, v, causal=causal, window=window, softcap=softcap,
            q_block=q_block or Q_BLOCK, kv_block=kv_block or KV_BLOCK)[0]
    if q_block or kv_block:
        flash_ops.check_blocks(q.shape[1], k.shape[1], q_block or Q_BLOCK,
                               kv_block or KV_BLOCK)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return flash_ops.FlashAttention.apply(q, k, v, causal, window,
                                              softcap)
    return flash_ops.flash_attention_fwd(q, k, v, causal=causal,
                                         window=window, softcap=softcap)[0]
