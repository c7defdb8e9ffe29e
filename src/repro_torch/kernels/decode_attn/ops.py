"""Flash-decode attention (``csrc/decode_attn.cu``) and its plain version.

One query token per sequence against a (possibly partly filled) KV cache:
q (B, H, d), k and v (B, S, Hkv, d), the first ``length`` slots valid. The
reference's wrapper falls back to its jnp oracle when S is not a multiple
of its block; the kernel here takes any S and reads only the valid slots.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import (check_tensor, count_launch, on_gpu,
                                        sm_count)

HEAD_DIMS = (64, 128, 256)
MAX_GROUP = 8
_DTYPES = (torch.float32, torch.bfloat16)


def decode_attention_ref(q, k, v, length, scale, softcap: float = 0.0):
    """Plain PyTorch version: q (B,H,d); k,v (B,S,Hkv,d); length: valid
    prefix of S. -> (B,H,d) in q's type."""
    B, H, d = q.shape
    _, S, Hkv, _ = k.shape
    G = H // Hkv
    qg = q.reshape(B, Hkv, G, d)
    scores = torch.einsum("bhgd,bshd->bhgs", qg.float(), k.float()) * scale
    if softcap > 0.0:
        scores = softcap * torch.tanh(scores / softcap)
    mask = torch.arange(S, device=q.device)[None, None, None, :] < length
    scores = torch.where(mask, scores, torch.tensor(-1e30, device=q.device))
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhgs,bshd->bhgd", p, v.float())
    return out.reshape(B, H, d).to(q.dtype)


def n_splits(device: torch.device, batch: int, n_kv_heads: int,
             length: int) -> int:
    """Chunks of the valid prefix: enough blocks for four per SM, at
    least 128 slots a chunk."""
    want = -(-4 * sm_count(device) // max(1, batch * n_kv_heads))
    return max(1, min(-(-length // 128), want))


def launch_decode_attention(q, k, v, length: int, out, scale: float,
                            softcap: float, n_split: int, part_m=None,
                            part_l=None, part_acc=None) -> None:
    """The bare launch on checked GPU tensors; with ``n_split > 1`` the
    float32 scratch ``part_m``/``part_l`` (B*H*n_split) and ``part_acc``
    (B*H*n_split*d) is given. No allocation, no synchronisation."""
    B, H, d = q.shape
    _, S, Hkv, _ = k.shape
    lib = build.load_library()
    ptr = (lambda t: t.data_ptr() if t is not None else None)
    with torch.cuda.device(q.device):
        code = lib.decode_attn(
            q.data_ptr(), int(q.dtype == torch.bfloat16), k.data_ptr(),
            v.data_ptr(), int(k.dtype == torch.bfloat16), out.data_ptr(),
            ptr(part_m), ptr(part_l), ptr(part_acc), B, S, H, Hkv, d,
            int(length), int(n_split), float(scale), float(softcap),
            torch.cuda.current_stream().cuda_stream)
    build.check(code, "decode_attn")


def _length(length, S: int) -> int:
    n = int(length.reshape(-1)[0]) if isinstance(length, torch.Tensor) \
        else int(length)
    if not 1 <= n <= S:
        raise ValueError(f"length {n} outside [1, {S}]")
    return n


def decode_attention(q, k, v, length, scale=None, softcap: float = 0.0):
    """One-token attention vs a (possibly partially filled) KV cache.

    q: (B, H, d) float32 or bf16; k, v: (B, S, Hkv, d) float32 or bf16;
    length: int or 0-d / 1-element tensor, the valid prefix of S. Returns
    (B, H, d) in q's type. On CUDA tensors it launches the kernel (any S,
    1 <= length <= S, d in 64/128/256, H / Hkv from 1 to 8) or raises.
    """
    B, H, d = q.shape
    _, S, Hkv, dk = k.shape
    if scale is None:
        scale = d ** -0.5
    if not on_gpu(q, k, v):
        return decode_attention_ref(q, k, v, length, scale, softcap)
    if k.shape != v.shape or k.shape[0] != B or dk != d:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not fit")
    if H % Hkv or not 1 <= H // Hkv <= MAX_GROUP:
        raise ValueError(f"{H} query heads over {Hkv} KV heads: the group "
                         f"must be 1..{MAX_GROUP}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in {HEAD_DIMS}")
    if q.dtype not in _DTYPES or k.dtype not in _DTYPES or v.dtype != k.dtype:
        raise TypeError(f"q {q.dtype}, k {k.dtype}, v {v.dtype}: float32 or "
                        "bfloat16, k and v of one type")
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_tensor(t, t.dtype, name)
    for name, t in (("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")
    n = _length(length, S)
    out = torch.empty_like(q)
    if B == 0:
        return out
    n_split = n_splits(q.device, B, Hkv, n)
    parts = ()
    if n_split > 1:
        pm = torch.empty((B * H * n_split,), dtype=torch.float32,
                         device=q.device)
        parts = (pm, torch.empty_like(pm),
                 torch.empty((B * H * n_split * d,), dtype=torch.float32,
                             device=q.device))
    launch_decode_attention(q, k, v, n, out, scale, softcap, n_split, *parts)
    count_launch("decode_attn", (B, S, H, Hkv, d, n))
    return out
