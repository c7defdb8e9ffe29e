"""Flash-decode attention (``csrc/decode_attn.cu``) and its plain version.

One query token per sequence against a (possibly partly filled) KV cache:
q (B, H, d), k and v (B, S, Hkv, d), the first ``length`` slots valid. The
reference's wrapper falls back to its jnp oracle when S is not a multiple
of its block; the kernel here takes any S and reads only the valid slots.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import (check_tensor, count_launch, on_gpu,
                                        sm_count)

HEAD_DIMS = tuple(range(16, 257, 16))   # the kernel's: multiples of 16
MAX_GROUP = 8
TILE = 32                               # slots a tile (csrc TK)
MAX_SPLITS = 256                        # csrc MAX_SPLITS
_DTYPES = (torch.float32, torch.bfloat16)


def shape_supported(head_dim: int, group: int) -> bool:
    """The kernel's shape rule: head_dim a multiple of 16 up to 256 and 1
    to 8 query heads per KV head."""
    return head_dim in HEAD_DIMS and 1 <= group <= MAX_GROUP


def split_plan(length: int, batch: int, n_kv_heads: int,
               resident: int) -> tuple[int, int]:
    """(n_split, chunk): the valid prefix cut into chunks of whole tiles so
    that batch * n_kv_heads * n_split blocks fit one wave of `resident`
    blocks (the card's SMs times the blocks an SM takes), at most
    MAX_SPLITS; one split where the (sequence, KV head) pairs alone fill a
    wave."""
    want = min(MAX_SPLITS, max(1, resident // max(1, batch * n_kv_heads)))
    chunk = -(-length // want)
    chunk = -(-chunk // TILE) * TILE
    return -(-length // chunk), chunk


_resident: dict[tuple, int] = {}


def resident_blocks(device: torch.device, q_bf16: bool, kv_bf16: bool,
                    head_dim: int, group: int) -> int:
    """Blocks of the split pass the card holds at once for these types and
    shape (``decode_attn_plan``: the CUDA occupancy of the pass's shared
    memory and registers, times the SMs); asked once per (device, key)."""
    key = (device.index, q_bf16, kv_bf16, head_dim, group)
    n = _resident.get(key)
    if n is None:
        per_sm = ctypes.c_int(0)
        with torch.cuda.device(device):
            build.check(build.entry("decode_attn_plan")(
                int(q_bf16), int(kv_bf16), head_dim, group,
                ctypes.byref(per_sm)), "decode_attn_plan")
        n = _resident[key] = max(1, per_sm.value) * sm_count(device)
    return n


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


def launch_decode_attention(q, k, v, length: int, out, scale: float,
                            softcap: float, n_split: int, chunk: int,
                            part_m=None, part_l=None, part_acc=None,
                            counters=None) -> None:
    """The bare launch on checked GPU tensors, split as `split_plan` says;
    with ``n_split > 1`` the float32 scratch ``part_m``/``part_l``
    (B*H*n_split) and ``part_acc`` (B*H*n_split*d) and the int32 zeros
    ``counters`` (B*Hkv, left zero by the launch) are given. No
    allocation, no synchronisation."""
    B, H, d = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    ptr = (lambda t: t.data_ptr() if t is not None else None)
    build.launch("decode_attn", q.device, q.data_ptr(),
                 int(q.dtype == torch.bfloat16), k.data_ptr(), v.data_ptr(),
                 int(k.dtype == torch.bfloat16), out.data_ptr(), ptr(part_m),
                 ptr(part_l), ptr(part_acc), ptr(counters), B, S, H, Hkv, d,
                 int(length), int(n_split), int(chunk), float(scale),
                 float(softcap))


_counters: dict[torch.device, torch.Tensor] = {}


def split_counters(device: torch.device, n: int) -> torch.Tensor:
    """`n` int32 zeros on `device` for the splits' arrival counts: made
    once (grown when a launch needs more) and left zero by every launch,
    which makes them safe to share between launches in one stream's
    order (not between launches running at once on two streams)."""
    t = _counters.get(device)
    if t is None or t.numel() < n:
        t = _counters[device] = torch.zeros(max(n, 1024), dtype=torch.int32,
                                            device=device)
    return t


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
    1 <= length <= S, `shape_supported(d, H // Hkv)`: d a multiple of 16 up
    to 256, H / Hkv from 1 to 8) or raises.
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
    if H % Hkv or not shape_supported(d, H // Hkv):
        raise ValueError(f"head_dim {d}, {H} query heads over {Hkv} KV "
                         "heads: the kernel takes a head_dim that is a "
                         f"multiple of 16 up to 256 and a group of 1.."
                         f"{MAX_GROUP}")
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
    n_split, chunk = split_plan(n, B, Hkv, resident_blocks(
        q.device, q.dtype == torch.bfloat16, k.dtype == torch.bfloat16, d,
        H // Hkv))
    parts = ()
    if n_split > 1:
        pm = torch.empty((B * H * n_split,), dtype=torch.float32,
                         device=q.device)
        parts = (pm, torch.empty_like(pm),
                 torch.empty((B * H * n_split * d,), dtype=torch.float32,
                             device=q.device),
                 split_counters(q.device, B * Hkv))
    launch_decode_attention(q, k, v, n, out, scale, softcap, n_split, chunk,
                            *parts)
    count_launch("decode_attn", (B, S, H, Hkv, d, n))
    return out
