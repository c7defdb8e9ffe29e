"""Adafactor (factored second moments, no momentum): the >100B default.

State per matrix-like leaf: row and column second-moment factors over the
last two dims (leading dims, such as the experts', are kept). Vectors keep
a full second moment. Updates are RMS-clipped (Shazeer & Stern, 2018).

The reference's leaves are the stacked period tree: block ``i``'s leaf
holds every period's copy along a leading axis. Here layer
``p * period + i`` is a parameter of its own, so the optimizer stacks
them back: ``layers.{p * period + i}.<rest>`` for every ``p`` is one
leaf, stacked in ``p`` order and keyed in the state by its first layer's
name (``layers.{i}.<rest>``). Its factors, and the RMS that clips it, are
taken over the whole stack, as the reference's are; a layer vector is so
a (periods, d) matrix, factored. Every other parameter is a leaf of its
own. ``period`` is the model's ``cfg.period``; None stacks nothing (each
layer a stack of one), which is the reference's layout for a model of
one period only.
"""

from __future__ import annotations

import torch

from repro_torch.optim.adamw import f32_step


def _stacks(names, period) -> dict[str, list[str] | None]:
    """Stack key -> the parameter names stacked under it in period order;
    None for a parameter outside ``layers`` (not stacked)."""
    stacks, order = {}, {}
    for k in names:
        parts = k.split(".", 2)
        if parts[0] != "layers":
            stacks[k] = None
            continue
        j = int(parts[1])
        key = k if period is None else f"layers.{j % period}.{parts[2]}"
        stacks.setdefault(key, []).append(k)
        order[k] = 0 if period is None else j // period
    for members in stacks.values():
        if members is not None:
            members.sort(key=order.__getitem__)
    return stacks


def adafactor(lr: float = 1e-4, decay: float = 0.8, eps: float = 1e-30,
              clip_threshold: float = 1.0, period: int | None = None):
    def init(params):
        def one(shape, device):
            kw = dict(dtype=torch.float32, device=device)
            if len(shape) >= 2:
                return {"vr": torch.zeros(shape[:-1], **kw),
                        "vc": torch.zeros(shape[:-2] + shape[-1:], **kw)}
            return {"v": torch.zeros(shape, **kw)}

        f = {}
        for key, members in _stacks(params, period).items():
            p = params[key]
            shape = p.shape if members is None else \
                torch.Size((len(members),)) + p.shape
            f[key] = one(shape, p.device)
        return {"f": f}

    @torch.no_grad()
    def update(params, grads, state, step):
        """The reference's arithmetic in float32; the factors are updated
        in place, the parameters overwritten. Returns (params, state)."""
        if not params:
            return params, state
        t = f32_step(step, next(iter(params.values())).device)
        beta = 1.0 - t ** (-decay)
        for key, members in _stacks(params, period).items():
            if members is None:
                g = grads[key].to(torch.float32)
            else:
                g = torch.stack([grads[k].to(torch.float32)
                                 for k in members])
            u = one(g, state["f"][key], beta)
            rms = torch.sqrt((u * u).mean() + eps)
            u = u / torch.clamp(rms / clip_threshold, min=1.0)
            for k, uk in (((key, u),) if members is None
                          else zip(members, u)):
                p = params[k]
                p.copy_((p.to(torch.float32) - lr * uk).to(p.dtype))
        return params, state

    def one(g, s, beta):
        """Updates the leaf's factors in place; returns its update."""
        g2 = g * g + eps
        if g.dim() >= 2:
            s["vr"].copy_(beta * s["vr"] + (1 - beta) * g2.mean(dim=-1))
            s["vc"].copy_(beta * s["vc"] + (1 - beta) * g2.mean(dim=-2))
            denom = s["vr"].mean(dim=-1, keepdim=True)
            return g / torch.sqrt(
                (s["vr"] / torch.clamp(denom, min=eps))[..., None]
                * s["vc"][..., None, :] + eps)
        s["v"].copy_(beta * s["v"] + (1 - beta) * g2)
        return g / torch.sqrt(s["v"] + eps)

    return init, update
