"""The dense SwiGLU MLP and the Mixture-of-Experts layer: top-k routing
with capacity, group-local dispatch (GShard-style grouping) and a
gather-based combine, as the reference computes them (``repro.nn.moe``).

The layer holds no hand kernel: the reference computes it as plain array
code (no Pallas), so the port's counterpart is plain PyTorch. The three
expert products are ``torch.bmm`` over the expert axis on the ``(E, d, f)``
weights as they lie; an ``einsum`` may permute its operands, and a permuted
copy of a large model's expert weights (kimi-k2: 11.3 GB a product in
bf16) costs more than the product.

Every expert computes its ``C`` slots whether or not a token was routed
there, as in the reference: a decode step reads every expert's weights.
"""

from __future__ import annotations

import torch

from repro_torch.nn.layers import Params, init_dense, silu


def init_swiglu(gen, d_model: int, d_ff: int, dtype=torch.float32,
                device=None) -> Params:
    return Params(
        w_gate=init_dense(gen, d_model, d_ff, dtype=dtype, device=device),
        w_up=init_dense(gen, d_model, d_ff, dtype=dtype, device=device),
        w_down=init_dense(gen, d_ff, d_model, dtype=dtype, device=device))


def swiglu(p, x):
    return (silu(x @ p["w_gate"]["w"]) * (x @ p["w_up"]["w"])) \
        @ p["w_down"]["w"]


def _experts(gen, shape, scale: float, dtype, device) -> torch.Tensor:
    """N(0, scale^2) of `shape` (E, ...), drawn in float32 one expert at a
    time and scaled in place, so the float32 transient is one expert's
    slice and not two tensors of the whole (kimi-k2: 2 x 22.5 GB)."""
    device = device if device is not None else gen.device
    out = torch.empty(shape, dtype=dtype, device=device)
    for e in range(shape[0]):
        x = torch.randn(shape[1:], generator=gen, device=gen.device,
                        dtype=torch.float32)
        out[e].copy_(x.mul_(scale))
    return out


def init_moe(gen, d_model: int, d_ff: int, n_experts: int, top_k: int,
             n_shared: int = 0, dtype=torch.float32, device=None) -> Params:
    """The router is float32 whatever `dtype` is (the reference's
    ``init_dense(..., dtype=jnp.float32)``)."""
    p = Params(
        router=init_dense(gen, d_model, n_experts, dtype=torch.float32,
                          device=device),
        w_gate=_experts(gen, (n_experts, d_model, d_ff), d_model ** -0.5,
                        dtype, device),
        w_up=_experts(gen, (n_experts, d_model, d_ff), d_model ** -0.5,
                      dtype, device),
        w_down=_experts(gen, (n_experts, d_ff, d_model), d_ff ** -0.5,
                        dtype, device))
    if n_shared > 0:
        p["shared"] = init_swiglu(gen, d_model, d_ff * n_shared, dtype,
                                  device)
    return p


def capacity(B: int, S: int, n_experts: int, top_k: int,
             capacity_factor: float) -> tuple[int, int, int]:
    """(G, Sg, C): one group per batch row when ``S * top_k >= 4 * E``,
    else one group of ``B * S`` tokens; ``C`` slots an expert and group.
    Plain Python arithmetic, as the reference's, so it rounds the same."""
    if S * top_k >= 4 * n_experts:
        G, Sg = B, S
    else:
        G, Sg = 1, B * S
    C = max(1, int(Sg * top_k * capacity_factor / n_experts))
    return G, Sg, min(Sg, ((C + 7) // 8) * 8)


def route(p, xg, top_k: int):
    """xg: (G, Sg, d) -> (logits, probs) float32 (G, Sg, E) and the
    renormalised gates (G, Sg, k) float32 with their experts (G, Sg, k)."""
    logits = xg.float() @ p["router"]["w"]
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = torch.topk(probs, top_k, dim=-1)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    return logits, probs, gate_vals, gate_idx


def _positions_in_expert(flat_expert, n_experts: int):
    """(..., N) expert ids -> (..., N) int32 arrival rank within each
    expert (stable), per row."""
    n = flat_expert.shape[-1]
    order = torch.argsort(flat_expert, dim=-1, stable=True)
    sorted_e = torch.gather(flat_expert, -1, order)
    experts = torch.arange(n_experts, dtype=sorted_e.dtype,
                           device=sorted_e.device)
    seg_start = torch.searchsorted(
        sorted_e, experts.expand(*sorted_e.shape[:-1], n_experts)
        .contiguous())
    pos_sorted = torch.arange(n, device=sorted_e.device) \
        - torch.gather(seg_start, -1, sorted_e)
    # `order` is a permutation: one write a place
    return torch.empty_like(pos_sorted, dtype=torch.int32).scatter_(
        -1, order, pos_sorted.to(torch.int32))


def dispatch(gate_idx, n_experts: int, C: int):
    """gate_idx (G, Sg, k) -> (slot (G, Sg*k): each choice's row of the
    (E*C) expert slots, E*C where it is dropped; idx (G, E*C): the token
    in its group each slot holds, Sg for an empty slot)."""
    G, Sg, k = gate_idx.shape
    flat_e = gate_idx.reshape(G, Sg * k)
    pos = _positions_in_expert(flat_e, n_experts)
    slot = torch.where(pos < C, flat_e * C + pos, n_experts * C)
    token_of = torch.arange(Sg, device=slot.device).repeat_interleave(k)
    idx = torch.full((G, n_experts * C + 1), Sg, dtype=torch.int64,
                     device=slot.device)
    # A kept choice's slot is its own; only the dropped ones share the
    # last column, which is cut: a scatter with duplicate indices has no
    # order on the card, and here no kept slot depends on it.
    idx.scatter_(1, slot, token_of.expand(G, -1))
    return slot, idx[:, : n_experts * C]


def _pad_row(t):
    """(G, N, d) -> (G, N + 1, d) with a zero row last."""
    return torch.cat([t, t.new_zeros((t.shape[0], 1, t.shape[2]))], dim=1)


def moe_apply(p, x, *, n_experts: int, top_k: int,
              capacity_factor: float = 1.25, router_z_weight: float = 1e-3):
    """x: (B, S, d) -> (y (B, S, d) in x's type, aux float32 0-d)."""
    B, S, d = x.shape
    E = n_experts
    G, Sg, C = capacity(B, S, E, top_k, capacity_factor)
    xg = x.reshape(G, Sg, d)
    logits, probs, gate_vals, gate_idx = route(p, xg, top_k)
    slot, idx = dispatch(gate_idx, E, C)

    rows = torch.arange(G, device=x.device)[:, None]
    xe = _pad_row(xg)[rows, idx]                              # (G, E*C, d)
    # experts first: (E, G*C, d) against the (E, d, f) weights as they lie
    xe = xe.reshape(G, E, C, d).transpose(0, 1).reshape(E, G * C, d)
    h = silu(torch.bmm(xe, p["w_gate"])) * torch.bmm(xe, p["w_up"])
    ye = torch.bmm(h, p["w_down"])                            # (E, G*C, d)
    ye = ye.reshape(E, G, C, d).transpose(0, 1).reshape(G, E * C, d)

    # combine: each token's k slots gathered back (the zero row for a
    # drop), weighted in the activation type
    yk = _pad_row(ye)[rows, slot].reshape(G, Sg, top_k, d)
    y = (yk * gate_vals[..., None].to(yk.dtype)).sum(dim=2)
    if "shared" in p:
        y = y + swiglu(p["shared"], xg)

    # load-balancing aux loss (Switch) + router z-loss
    me = probs.mean(dim=(0, 1))
    ce = torch.nn.functional.one_hot(gate_idx[..., 0], E).float().mean(
        dim=(0, 1))
    aux = E * torch.sum(me * ce) + router_z_weight * torch.mean(
        torch.logsumexp(logits, dim=-1) ** 2)
    return y.reshape(B, S, d).to(x.dtype), aux
