"""Blocked attention (``csrc/flash_attn.cu``) and its plain versions.

The prefill and training attention over a whole sequence: q (B, Sq, H, dh),
k and v (B, Skv, Hkv, dh), GQA with G = H / Hkv, an optional causal mask,
sliding window and softcap. The reference computes it as a jitted nested
``lax.scan`` (``repro/nn/flash.py:30``), no Pallas kernel; its gradient is
``jax.grad`` of those scans. Here a CUDA tensor goes through the kernel
``flash_attn_fwd``, and, where autograd records and an input needs a
gradient, through `FlashAttention`, whose backward is two kernels of the
port's own: the dQ pass (``flash_attn_bwd_dq``, which also forms D =
rowsum(dO * O)) and the dK/dV pass (``flash_attn_bwd_dkdv``, each KV head's
gradient summed over its G query heads in one block). On the CPU the plain
loop `flash_attention_fwd_ref` runs and autograd differentiates it, as
``jax.grad`` differentiates the reference's scans.

What bounds the kernels on an H100: the products (4 dh flops a query-key
pair in the band forward, 10 dh backward) at the tensor cores' bf16 rate,
and beside them one exponential a pair (two in the backward) on the
special-function units; the bytes are far behind. The bf16 instances, the
paths' type, run every product on the tensor cores (``wgmma``, bf16 in,
float32 sums), with tiles streamed into shared memory by asynchronous
copies and the online softmax in registers. The forward splits the
probabilities into bf16(P) + bf16(P - bf16(P)) and adds both products: an
emulation of the rounding (tests/test_torch_flash_attn.py) keeps every
output within 0.95 - 0.98 of the bound a bf16 output is held to on the
card, where bf16(P) alone leaves about a fifth of them outside it. The
backward rounds P and dS once each and stays within the bf16 gradients'
bound. The float32 instances stay float32 FMAs on the CUDA cores: their
callers hold them to 2e-4 and 1e-4, which bf16 operands cannot meet.

Launches are counted as ``flash_attention`` (one a forward) and
``flash_attention_bwd`` (two a backward: the dQ pass, the dK/dV pass), at
`launch_shape`: (B, Sq, Skv, H, Hkv, dh, causal, window, softcap).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import check_tensor, count_launch, on_gpu
from repro_torch.nn.layers import softcap as apply_softcap

HEAD_DIMS = (64, 112, 128, 256)    # the kernel's (the repo's configs')
NEG_INF = -1e30
_DTYPES = (torch.float32, torch.bfloat16)


def check_blocks(Sq: int, Skv: int, q_block: int,
                 kv_block: int) -> tuple[int, int]:
    """The blocks cut to the lengths, or the reference's ValueError where a
    length is not a multiple of its block."""
    q_block, kv_block = min(q_block, Sq), min(kv_block, Skv)
    if Sq % q_block or Skv % kv_block:
        raise ValueError(f"sequence lengths {Sq}, {Skv} must be multiples "
                         f"of the blocks {q_block}, {kv_block}")
    return q_block, kv_block


def flash_attention_fwd_ref(q, k, v, *, causal: bool = True, window: int = 0,
                            softcap: float = 0.0, q_block: int = 256,
                            kv_block: int = 1024):
    """Plain version: loops over (q blocks x kv blocks) with an online
    softmax, the largest live intermediate (B, H, q_block, kv_block).
    q: (B,Sq,H,dh); k,v: (B,Skv,Hkv,dh) -> (out (B,Sq,H,dh) in q's type,
    lse (B,H,Sq) float32, the log-sum-exp of each row's scores)."""
    B, Sq, H, dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = dh ** -0.5
    q_block, kv_block = check_blocks(Sq, Skv, q_block, kv_block)
    dev = q.device
    blocks, lses = [], []
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
        lses.append(m + torch.log(l))
    return torch.cat(blocks, dim=1), torch.cat(lses, dim=-1)


def flash_attention_bwd_ref(q, k, v, out, lse, dout, *, causal: bool = True,
                            window: int = 0, softcap: float = 0.0,
                            q_block: int = 256, kv_block: int = 1024):
    """Plain version of the kernels' backward, in their algorithm (not
    autograd): for the upstream gradient dout of `out` = the forward's
    output (in q's type) with its log-sum-exp `lse` (B, H, Sq), p = exp(s -
    lse) recomputed block by block, D = rowsum(dout * out), dS = p (dP - D)
    times 1 - tanh^2 under a softcap, times the scale; dK and dV summed over
    the G query heads of a KV head. Returns (dq, dk, dv) in the inputs'
    types."""
    B, Sq, H, dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = dh ** -0.5
    q_block, kv_block = check_blocks(Sq, Skv, q_block, kv_block)
    dev = q.device
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2)  # (B,H,Sq)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=dev)
    dk = torch.zeros((B, Skv, H, dh), dtype=torch.float32, device=dev)
    dv = torch.zeros_like(dk)
    for q0 in range(0, Sq, q_block):
        qs = slice(q0, q0 + q_block)
        qi, doi = q[:, qs].float(), dout[:, qs].float()
        qpos = q0 + torch.arange(qi.shape[1], device=dev)
        L, D = lse[:, :, qs, None], delta[:, :, qs, None]
        for k0 in range(0, Skv, kv_block):
            ks = slice(k0, k0 + kv_block)
            kh = torch.repeat_interleave(k[:, ks], G, dim=2).float()
            vh = torch.repeat_interleave(v[:, ks], G, dim=2).float()
            kpos = k0 + torch.arange(kh.shape[1], device=dev)
            s = torch.einsum("bqhd,bkhd->bhqk", qi, kh) * scale
            if softcap > 0:
                t = torch.tanh(s / softcap)
                s = softcap * t
            mask = torch.ones((len(qpos), len(kpos)), dtype=torch.bool,
                              device=dev)
            if causal:
                mask &= kpos[None, :] <= qpos[:, None]
            if window > 0:
                mask &= kpos[None, :] > qpos[:, None] - window
            p = torch.exp(torch.where(mask[None, None], s, NEG_INF) - L)
            dv[:, ks] += torch.einsum("bhqk,bqhd->bkhd", p, doi)
            ds = p * (torch.einsum("bqhd,bkhd->bhqk", doi, vh) - D)
            if softcap > 0:
                ds = ds * (1 - t * t)
            ds = ds * scale
            dq[:, qs] += torch.einsum("bhqk,bkhd->bqhd", ds, kh)
            dk[:, ks] += torch.einsum("bhqk,bqhd->bkhd", ds, qi)
    dk = dk.reshape(B, Skv, Hkv, G, dh).sum(3)
    dv = dv.reshape(B, Skv, Hkv, G, dh).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def launch_shape(q, k, causal: bool, window: int, softcap: float) -> tuple:
    """The shape a launch is counted at: (B, Sq, Skv, H, Hkv, dh, causal,
    window, softcap), the cap as a whole number (the configs' caps are)."""
    B, Sq, H, dh = q.shape
    return (B, Sq, k.shape[1], H, k.shape[2], dh, int(causal), int(window),
            int(softcap))


def _scalars(q, k, causal, window, softcap) -> tuple:
    B, Sq, H, dh = q.shape
    return (B, Sq, k.shape[1], H, k.shape[2], dh,
            int(q.dtype == torch.bfloat16), int(causal), int(window),
            dh ** -0.5, float(softcap))


def launch_flash_attention(q, k, v, out, lse, causal: bool, window: int,
                           softcap: float) -> None:
    """The forward's bare launch on checked GPU tensors into ``out`` and
    ``lse`` (B, H, Sq) float32. No allocation, no synchronisation."""
    build.launch("flash_attn_fwd", q.device, q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), out.data_ptr(), lse.data_ptr(),
                 *_scalars(q, k, causal, window, softcap))


def launch_flash_attention_bwd_dq(q, k, v, out, dout, lse, delta, dq,
                                  causal: bool, window: int,
                                  softcap: float) -> None:
    """The dQ pass's bare launch: writes ``delta`` (B, H, Sq) float32, D =
    rowsum(dout * out), and ``dq``. No allocation, no synchronisation."""
    build.launch("flash_attn_bwd_dq", q.device, *(
        t.data_ptr() for t in (q, k, v, out, dout, lse, delta, dq)),
        *_scalars(q, k, causal, window, softcap))


def launch_flash_attention_bwd_dkdv(q, k, v, dout, lse, delta, dk, dv,
                                    causal: bool, window: int,
                                    softcap: float) -> None:
    """The dK/dV pass's bare launch, after the dQ pass (it reads
    ``delta``). No allocation, no synchronisation."""
    build.launch("flash_attn_bwd_dkdv", q.device, *(
        t.data_ptr() for t in (q, k, v, dout, lse, delta, dk, dv)),
        *_scalars(q, k, causal, window, softcap))


def takes(head_dim: int, dtype) -> bool:
    """Whether the kernels take this head size and type (the lengths are
    any)."""
    return head_dim in HEAD_DIMS and dtype in _DTYPES


def _check(q, k, v, window: int, *more) -> None:
    """What the kernels take, or a ValueError / TypeError that names the
    plain version: fitting shapes, head_dim in HEAD_DIMS, one type of
    float32 or bf16 for all, contiguous tensors, and a key in every query
    row's band (with a window, Sq < Skv + window)."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape or \
            k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3] or \
            q.shape[2] % k.shape[2] or any(t.shape != q.shape for t in more):
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not fit")
    B, Sq, H, dh = q.shape
    if dh not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {dh} is not one the "
                         f"kernel takes {HEAD_DIMS}; the plain version "
                         "flash_attention_fwd_ref takes any")
    if window > 0 and Sq >= k.shape[1] + window:
        raise ValueError(f"flash_attention: with window {window}, query rows "
                         f"from {k.shape[1] + window - 1} on have no key in "
                         "their band; the plain version "
                         "flash_attention_fwd_ref averages all of v there")
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention: {q.dtype}, not float32 or bf16")
    for name, t in (("q", q), ("k", k), ("v", v),
                    *((f"gradient input {i}", t) for i, t in enumerate(more))):
        check_tensor(t, q.dtype, name)


def _forward_gpu(q, k, v, causal, window, softcap):
    B, Sq, H, dh = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    launch_flash_attention(q, k, v, out, lse, causal, window, softcap)
    count_launch("flash_attention", launch_shape(q, k, causal, window,
                                                 softcap))
    return out, lse


def flash_attention_fwd(q, k, v, *, causal: bool = True, window: int = 0,
                        softcap: float = 0.0):
    """(out, lse) of the blocked attention. On CUDA tensors it launches the
    kernel or raises (`_check`); on the CPU, `flash_attention_fwd_ref` at
    its default blocks."""
    if not on_gpu(q, k, v):
        return flash_attention_fwd_ref(q, k, v, causal=causal, window=window,
                                       softcap=softcap)
    _check(q, k, v, window)
    return _forward_gpu(q, k, v, causal, window, softcap)


def flash_attention_bwd(q, k, v, out, lse, dout, *, causal: bool = True,
                        window: int = 0, softcap: float = 0.0):
    """(dq, dk, dv) for the upstream gradient ``dout`` of ``out`` (the
    forward's output, with its ``lse``). On CUDA tensors two launches, the
    dQ pass then the dK/dV pass, or a raise; the same bits every call. On
    the CPU, `flash_attention_bwd_ref`."""
    if not on_gpu(q, k, v, out, lse, dout):
        return flash_attention_bwd_ref(q, k, v, out, lse, dout,
                                       causal=causal, window=window,
                                       softcap=softcap)
    _check(q, k, v, window, out, dout)
    B, Sq, H, _ = q.shape
    if lse.shape != (B, H, Sq):
        raise ValueError(f"lse {tuple(lse.shape)}, not {(B, H, Sq)}")
    check_tensor(lse, torch.float32, "lse")
    delta = torch.empty_like(lse)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    shape = launch_shape(q, k, causal, window, softcap)
    launch_flash_attention_bwd_dq(q, k, v, out, dout, lse, delta, dq, causal,
                                  window, softcap)
    count_launch("flash_attention_bwd", shape)
    launch_flash_attention_bwd_dkdv(q, k, v, dout, lse, delta, dk, dv, causal,
                                    window, softcap)
    count_launch("flash_attention_bwd", shape)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """The kernel's forward with the kernels' backward, for CUDA tensors
    (`nn.flash.flash_attention` sends a CUDA call here when an input needs
    a gradient). Saves q, k, v, the output and its log-sum-exp."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap):
        _check(q, k, v, window)
        out, lse = _forward_gpu(q, k, v, causal, window, softcap)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = dict(causal=causal, window=window, softcap=softcap)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        if not on_gpu(q, k, v, out, lse, dout):
            raise RuntimeError("FlashAttention's backward runs on CUDA "
                               "tensors only; on the CPU autograd "
                               "differentiates flash_attention_fwd_ref")
        dq, dk, dv = flash_attention_bwd(
            q, k, v, out, lse, dout.to(q.dtype).contiguous(), **ctx.opts)
        return dq, dk, dv, None, None, None

