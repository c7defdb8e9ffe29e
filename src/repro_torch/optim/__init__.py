"""Optimizers: AdamW and Adafactor over a dict of named parameters.

``init(params)`` and ``update(params, grads, state, step)`` take
``dict(model.named_parameters())`` (and the gradients under the same
names); the states are dicts of tensors in the reference's layout
(``repro.optim``), one entry per parameter (Adafactor's per stack of a
layer's leaves over the periods), so `checkpoint` saves them as they
are. ``update`` writes the new values into the parameters in place
(the reference returns new arrays). Models over 100B parameters default
to Adafactor (factored second moment, no momentum).
"""

from repro_torch.optim.adafactor import adafactor
from repro_torch.optim.adamw import adamw


def get_optimizer(name: str, lr: float = 1e-4, period: int | None = None,
                  **kw):
    """``period``: the model's ``cfg.period``, by which Adafactor stacks
    the layers' leaves as the reference's period tree does (AdamW works
    element by element, and needs no stacking)."""
    if name == "adamw":
        return adamw(lr=lr, **kw)
    if name == "adafactor":
        return adafactor(lr=lr, period=period, **kw)
    raise ValueError(name)


def default_optimizer_for(param_count: int) -> str:
    """>100B params: factored states (kimi-k2, jamba, llama4)."""
    return "adafactor" if param_count > 100e9 else "adamw"
