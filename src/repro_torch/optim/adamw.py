"""AdamW with optional float32 master weights for bf16 parameters."""

from __future__ import annotations

import torch

from repro_torch.kernels.adamw import adamw_update


def f32_step(step, device) -> torch.Tensor:
    """The reference's ``step.astype(float32) + 1``, on `device`. A Python
    step is filled in on the device: a copy from the host would wait for
    the device's queue to drain, and the device would then idle through
    the update's host work."""
    if isinstance(step, torch.Tensor):
        return step.to(device=device, dtype=torch.float32) + 1.0
    return torch.full((), float(step), dtype=torch.float32,
                      device=device) + 1.0


def adamw(lr: float = 1e-4, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.01,
          master_weights: bool = True):
    def init(params):
        state = {
            "m": {k: torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device) for k, p in params.items()},
            "v": {k: torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device) for k, p in params.items()},
        }
        if master_weights:
            state["master"] = {k: p.detach().to(torch.float32, copy=True)
                               for k, p in params.items()}
        return state

    @torch.no_grad()
    def update(params, grads, state, step):
        """The reference's arithmetic in float32 (`kernels.adamw`: one
        kernel over the leaves on the GPU, the plain loop on the CPU); m, v
        and the masters are updated in place, the parameters overwritten
        with the new values. Returns (params, state)."""
        if not params:
            return params, state
        t = f32_step(step, next(iter(params.values())).device)
        bc1 = 1.0 - b1 ** t
        bc2 = 1.0 - b2 ** t
        masters = state.get("master")
        adamw_update([(p, grads[k], state["m"][k], state["v"][k],
                       None if masters is None else masters[k])
                      for k, p in params.items()], bc1, bc2, lr=lr, b1=b1,
                     b2=b2, eps=eps, weight_decay=weight_decay)
        return params, state

    return init, update
