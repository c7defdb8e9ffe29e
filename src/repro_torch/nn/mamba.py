"""Mamba-1 block (falcon-mamba; jamba's SSM layers).

in_proj -> (x, z); causal depthwise conv (d_conv taps) with its bias and
SiLU; x_proj -> (dt,B,C), with Jamba's block RMS norms on each of the
three (`models.config.JambaBlock`); dt's bias and softplus; selective
scan; silu(z) gate; out_proj. The conv, and the scan with dt's bias and
softplus before it and the gate after it, are hand-written kernels on
CUDA tensors and their plain versions on the CPU. Decode keeps a
(d_conv-1)-tap conv state and the (D, N) ssm state and steps with the
plain recurrence, as the reference does.
"""

from __future__ import annotations

import torch
from torch.nn import functional as F

from repro_torch import tracing
from repro_torch.kernels.causal_conv import causal_conv_silu
from repro_torch.kernels.selective_scan import (selective_scan_gated,
                                                selective_scan_step_ref)
from repro_torch.nn.layers import (Params, init_dense, init_rmsnorm, normal,
                                   rmsnorm, silu)


def init_mamba(gen, d_model: int, d_inner: int, d_state: int, d_conv: int,
               dt_rank: int, dtype=torch.float32, device=None,
               mixer_norms: bool = False) -> Params:
    """The layer's leaves; with `mixer_norms` also Jamba's norms of dt's
    low-rank part, B and C (``dt_norm``, ``b_norm``, ``c_norm``, scales
    1)."""
    kw = dict(dtype=dtype, device=device)
    p = Params(
        in_proj=init_dense(gen, d_model, 2 * d_inner, **kw),
        conv_w=normal(gen, (d_conv, d_inner), d_conv ** -0.5, dtype, device),
        x_proj=init_dense(gen, d_inner, dt_rank + 2 * d_state, **kw),
        dt_proj=init_dense(gen, dt_rank, d_inner, bias=True, **kw),
        out_proj=init_dense(gen, d_inner, d_model, **kw))
    dev = p["conv_w"].device
    p["conv_b"] = torch.zeros((d_inner,), dtype=dtype, device=dev)
    # S4D-real init: A = -(1..N) per channel; A and the skip stay float32
    p["a_log"] = torch.log(torch.arange(1, d_state + 1, dtype=torch.float32,
                                        device=dev)).repeat(d_inner, 1)
    p["d_skip"] = torch.ones((d_inner,), dtype=torch.float32, device=dev)
    if mixer_norms:
        for name, n in (("dt_norm", dt_rank), ("b_norm", d_state),
                        ("c_norm", d_state)):
            p[name] = init_rmsnorm(n, dtype=dtype, device=dev)
    return p


def _ssm_inputs(p, xc, d_state, dt_rank):
    """-> (dt's projection without its bias, A, B, C). Where the layer has
    Jamba's norms (``dt_norm`` among its leaves) dt's low-rank part, B and
    C each go through their RMS norm first, counted as
    ``mamba.mixer_norms``."""
    proj = xc @ p["x_proj"]["w"]                               # (B,T,R+2N)
    dt_r, b_mat, c_mat = torch.split(proj, [dt_rank, d_state, d_state],
                                     dim=-1)
    if "dt_norm" in p:
        dt_r = rmsnorm(p["dt_norm"], dt_r)
        b_mat = rmsnorm(p["b_norm"], b_mat)
        c_mat = rmsnorm(p["c_norm"], c_mat)
        tracing.count("mamba.mixer_norms", 1)
    a = -torch.exp(p["a_log"])                                 # (D, N)
    return dt_r @ p["dt_proj"]["w"], a, b_mat, c_mat


def _ssm_params(p, xc, d_state, dt_rank):
    dt_raw, a, b_mat, c_mat = _ssm_inputs(p, xc, d_state, dt_rank)
    return F.softplus(dt_raw + p["dt_proj"]["b"]), a, b_mat, c_mat


def mamba_train(p, x, *, d_inner, d_state, d_conv, dt_rank):
    """x: (B,T,d_model) -> (B,T,d_model). The conv and the gated scan are
    the kernels on CUDA tensors (any T), their plain versions on the
    CPU."""
    xz = x @ p["in_proj"]["w"]
    xin, z = xz.chunk(2, dim=-1)
    xc = causal_conv_silu(xin, p["conv_w"], p["conv_b"])
    dt_raw, a, b_mat, c_mat = _ssm_inputs(p, xc, d_state, dt_rank)
    y = selective_scan_gated(xc, dt_raw, p["dt_proj"]["b"], a, b_mat, c_mat,
                             p["d_skip"], z)
    return y @ p["out_proj"]["w"]


def init_mamba_cache(batch: int, d_inner: int, d_state: int, d_conv: int,
                     dtype=torch.float32, device=None) -> dict:
    return {
        "conv": torch.zeros((batch, d_conv - 1, d_inner), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((batch, d_inner, d_state), dtype=torch.float32,
                           device=device),
    }


def mamba_decode(p, x, cache, *, d_inner, d_state, d_conv, dt_rank):
    """One-token step. x: (B,1,d_model) -> (y (B,1,d_model), cache); the
    cache dict's entries are replaced by the new states."""
    xz = x[:, 0] @ p["in_proj"]["w"]
    xin, z = xz.chunk(2, dim=-1)                               # (B, d_inner)
    window = torch.cat([cache["conv"],
                        xin[:, None].to(cache["conv"].dtype)], dim=1)
    xc = silu((window * p["conv_w"][None]).sum(dim=1) + p["conv_b"])
    dt, a, b_mat, c_mat = _ssm_params(p, xc[:, None], d_state, dt_rank)
    h, y = selective_scan_step_ref(cache["ssm"], xc.float(),
                                   dt[:, 0].float(), a,
                                   b_mat[:, 0].float(), c_mat[:, 0].float(),
                                   p["d_skip"])
    y = y.to(x.dtype) * silu(z)
    cache["conv"] = window[:, 1:]
    cache["ssm"] = h
    return (y @ p["out_proj"]["w"])[:, None], cache
