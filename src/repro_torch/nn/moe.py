"""The dense SwiGLU MLP. The reference's module also holds the
Mixture-of-Experts layer (routing with capacity, group-local dispatch);
that part is not ported yet and raises."""

from __future__ import annotations

import torch

from repro_torch.nn.layers import Params, init_dense, silu

MOE_TODO = ("Mixture-of-Experts layers are not ported yet: ROADMAP.md "
            "queue 1, item 14 (MoE)")


def init_swiglu(gen, d_model: int, d_ff: int, dtype=torch.float32,
                device=None) -> Params:
    return Params(
        w_gate=init_dense(gen, d_model, d_ff, dtype=dtype, device=device),
        w_up=init_dense(gen, d_model, d_ff, dtype=dtype, device=device),
        w_down=init_dense(gen, d_ff, d_model, dtype=dtype, device=device))


def swiglu(p, x):
    return (silu(x @ p["w_gate"]["w"]) * (x @ p["w_up"]["w"])) \
        @ p["w_down"]["w"]


def init_moe(*args, **kwargs):
    raise NotImplementedError(MOE_TODO)


def moe_apply(*args, **kwargs):
    raise NotImplementedError(MOE_TODO)
