"""Blocked (flash-style) attention in plain PyTorch: the prefill memory fix.

Loops over (q blocks x kv blocks) with an online-softmax state keep the
largest live intermediate at (B, H, q_block, kv_block) instead of
(B, H, S, S). The math is `_sdpa`'s. The reference's version is plain jnp
too (not a Pallas kernel); a hand-written Hopper kernel for it is queued
(ROADMAP.md queue 2).

GQA: KV blocks are repeated to full heads inside the block.
"""

from __future__ import annotations

import torch

from repro_torch.nn.layers import softcap as apply_softcap

NEG_INF = -1e30


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0, q_block: int = 256,
                    kv_block: int = 1024):
    """q: (B,Sq,H,dh); k,v: (B,Skv,Hkv,dh) -> (B,Sq,H,dh)."""
    B, Sq, H, dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = dh ** -0.5
    q_block = min(q_block, Sq)
    kv_block = min(kv_block, Skv)
    if Sq % q_block or Skv % kv_block:
        raise ValueError(f"sequence lengths {Sq}, {Skv} must be multiples "
                         f"of the blocks {q_block}, {kv_block}")
    dev = q.device
    blocks = []
    for q0 in range(0, Sq, q_block):
        qi = q[:, q0:q0 + q_block].float()                 # (B,qb,H,dh)
        qpos = q0 + torch.arange(q_block, device=dev)
        m = torch.full((B, H, q_block), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, H, q_block), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, H, q_block, dh), dtype=torch.float32,
                          device=dev)
        for k0 in range(0, Skv, kv_block):
            kpos = k0 + torch.arange(kv_block, device=dev)
            kh = torch.repeat_interleave(k[:, k0:k0 + kv_block], G, dim=2)
            vh = torch.repeat_interleave(v[:, k0:k0 + kv_block], G, dim=2)
            s = torch.einsum("bqhd,bkhd->bhqk", qi, kh.float()) * scale
            s = apply_softcap(s, softcap)
            mask = torch.ones((q_block, kv_block), dtype=torch.bool,
                              device=dev)
            if causal:
                mask &= kpos[None, :] <= qpos[:, None]
            if window > 0:
                mask &= kpos[None, :] > qpos[:, None] - window
            s = torch.where(mask[None, None], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", p, vh.float())
            m = m_new
        out = acc / torch.clamp(l[..., None], min=1e-30)
        blocks.append(out.transpose(1, 2).to(q.dtype))     # (B,qb,H,dh)
    return torch.cat(blocks, dim=1)
