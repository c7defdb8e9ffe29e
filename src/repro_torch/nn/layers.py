"""Core layers: dense, embedding, RMSNorm, LayerNorm, and the parameter tree
node.

Weights keep the reference's ``(d_in, d_out)`` layout (``x @ w``), so a
reference parameter tree loads as it is and the two compare like with
like. Initialisers draw the reference's distributions from a
``torch.Generator``, on the generator's device unless told otherwise.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F


class Params(nn.Module):
    """One node of a parameter tree. Its entries - tensors, registered as
    parameters, and sub-trees, registered as submodules - are read as the
    reference's nested dicts are: ``p["w"]``, ``"b" in p``. Parameters are
    made with gradients off, which is what serving wants; a trainer turns
    them on (`launch.steps.make_train_step` calls
    ``model.requires_grad_(True)``)."""

    def __init__(self, entries: dict | None = None, **kw):
        super().__init__()
        for key, value in {**(entries or {}), **kw}.items():
            self[key] = value

    def __setitem__(self, key: str, value) -> None:
        if isinstance(value, dict):
            value = Params(value)
        elif isinstance(value, torch.Tensor) and not isinstance(
                value, nn.Parameter):
            value = nn.Parameter(value, requires_grad=False)
        setattr(self, key, value)

    def __getitem__(self, key: str):
        if key in self._parameters:
            return self._parameters[key]
        if key in self._modules:
            return self._modules[key]
        raise KeyError(key)

    def __contains__(self, key: str) -> bool:
        return key in self._parameters or key in self._modules


def normal(gen: torch.Generator, shape, scale: float, dtype, device=None):
    """N(0, scale^2) drawn in float32 on the generator's device, then cast
    and moved (the reference draws float32 normals and casts)."""
    x = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32) * scale
    return x.to(device=device if device is not None else gen.device,
                dtype=dtype)


def init_dense(gen, d_in: int, d_out: int, bias: bool = False,
               dtype=torch.float32, scale: float | None = None,
               device=None) -> Params:
    scale = (d_in ** -0.5) if scale is None else scale
    p = Params(w=normal(gen, (d_in, d_out), scale, dtype, device))
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=p["w"].device)
    return p


def dense(p, x):
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


def init_embed(gen, vocab: int, d: int, dtype=torch.float32,
               device=None) -> Params:
    return Params(table=normal(gen, (vocab, d), 1.0, dtype, device))


def embed(p, ids):
    return F.embedding(ids, p["table"])


def init_rmsnorm(d: int, dtype=torch.float32, device=None) -> Params:
    return Params(scale=torch.ones((d,), dtype=dtype, device=device))


def rmsnorm(p, x, eps: float = 1e-6):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(x.dtype)


def init_layernorm(d: int, dtype=torch.float32, device=None) -> Params:
    return Params(scale=torch.ones((d,), dtype=dtype, device=device),
                  bias=torch.zeros((d,), dtype=dtype, device=device))


def layernorm(p, x, eps: float = 1e-5):
    """LayerNorm with a bias over the last axis, in x's type (PyTorch's
    kernel sums in float32 whatever the type)."""
    return F.layer_norm(x, (x.shape[-1],), p["scale"].to(x.dtype),
                        p["bias"].to(x.dtype), eps)


def silu(x):
    return x * torch.sigmoid(x)


def softcap(x, cap: float):
    return cap * torch.tanh(x / cap) if cap > 0 else x
