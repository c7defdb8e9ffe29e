"""Public wrapper for AdamW's fused update (``csrc/adamw.cu``).

A leaf is ``(param, grad, m, v, master)``: the parameter (bf16 or
float32) and its gradient of the same type and shape, the float32 moments
and the float32 master, or None where the optimizer keeps none. The kernel
updates m, v, the master and the parameter in place, as the plain version
does. A launch takes up to MAX_LEAVES leaves of one instance (parameter
type, master or not); the leaves of an instance go in their order,
MAX_LEAVES at a time.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch import tracing
from repro_torch.kernels import build
from repro_torch.kernels.common import check_tensor, count_launch, on_gpu

MAX_LEAVES = 80       # leaves one launch's table takes (csrc/adamw.cu)
PARAM_TYPES = (torch.bfloat16, torch.float32)


def adamw_update_ref(leaves, bc1, bc2, lr, b1, b2, eps, weight_decay):
    """Plain PyTorch version: the reference's arithmetic in float32, leaf
    by leaf; m, v and the masters are updated in place, the parameters
    overwritten with the new values."""
    for p, g, m, v, master in leaves:
        g = g.to(torch.float32)
        w = master if master is not None else p.to(torch.float32)
        m.copy_(b1 * m + (1 - b1) * g)
        v.copy_(b2 * v + (1 - b2) * g * g)
        u = (m / bc1) / (torch.sqrt(v / bc2) + eps) + weight_decay * w
        w = w - lr * u
        if master is not None:
            master.copy_(w)
        p.copy_(w.to(p.dtype))


def leaf_table(leaves) -> ctypes.Array:
    """A launch's table: 6 int64s a leaf (the parameter's, gradient's, m's,
    v's and master's pointers, 0 without a master, and the element
    count)."""
    vals = []
    for p, g, m, v, master in leaves:
        vals += [p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(),
                 0 if master is None else master.data_ptr(), p.numel()]
    return (ctypes.c_longlong * len(vals))(*vals)


def launch_adamw(leaves, bc1, bc2, lr, b1, b2, eps, weight_decay) -> None:
    """The bare launch on checked GPU tensors: up to MAX_LEAVES leaves of
    one instance, `bc1` and `bc2` the 0-d float32 bias corrections on
    their device. No allocation, no synchronisation."""
    p, master = leaves[0][0], leaves[0][4]
    build.launch("adamw_update", p.device, leaf_table(leaves), len(leaves),
                 int(p.dtype == torch.bfloat16), int(master is not None),
                 b1, 1 - b1, b2, 1 - b2, eps, weight_decay, lr,
                 bc1.data_ptr(), bc2.data_ptr())


def launch_groups(leaves) -> list[list[int]]:
    """The launches: leaf indices grouped by instance, in the order of each
    instance's first leaf, each instance's leaves in order and at most
    MAX_LEAVES a launch."""
    by_instance: dict = {}
    for i, (p, *_, master) in enumerate(leaves):
        groups = by_instance.setdefault((p.dtype, master is None), [])
        if not groups or len(groups[-1]) == MAX_LEAVES:
            groups.append([])
        groups[-1].append(i)
    return [g for groups in by_instance.values() for g in groups]


def _check(leaves, bc1, bc2) -> None:
    for t, name in ((bc1, "bc1"), (bc2, "bc2")):
        check_tensor(t, torch.float32, name, 0)
    for i, (p, g, m, v, master) in enumerate(leaves):
        if p.dtype not in PARAM_TYPES:
            raise TypeError(f"leaf {i}: the kernel takes bf16 or float32 "
                            f"parameters, got {p.dtype}")
        check_tensor(p, p.dtype, f"leaf {i} param")
        check_tensor(g, p.dtype, f"leaf {i} grad")
        for t, name in ((m, "m"), (v, "v"), (master, "master")):
            if t is not None:
                check_tensor(t, torch.float32, f"leaf {i} {name}")
        for t in (g, m, v, master):
            if t is not None and t.shape != p.shape:
                raise ValueError(f"leaf {i}: shapes {tuple(t.shape)} and "
                                 f"{tuple(p.shape)} differ")


def adamw_update(leaves, bc1, bc2, *, lr: float, b1: float, b2: float,
                 eps: float, weight_decay: float) -> None:
    """AdamW's update of every leaf in place. `bc1`, `bc2`: the bias
    corrections ``1 - b1 ** t`` and ``1 - b2 ** t`` as 0-d float32 tensors
    on the leaves' device. On the GPU the kernel, a launch per group of
    `launch_groups` that holds an element, counted as ``adamw`` with the
    shape (leaves, elements, the parameter's bytes an element, 1 with a
    master else 0); the update's elements count as ``optim.fused_params``.
    On the CPU the plain version."""
    if not leaves:
        return
    if not on_gpu(bc1, bc2, *(t for leaf in leaves for t in leaf
                              if t is not None)):
        adamw_update_ref(leaves, bc1, bc2, lr, b1, b2, eps, weight_decay)
        return
    _check(leaves, bc1, bc2)
    fused = 0
    for group in launch_groups(leaves):
        part = [leaves[i] for i in group]
        n = sum(leaf[0].numel() for leaf in part)
        if n == 0:
            continue
        launch_adamw(part, bc1, bc2, lr, b1, b2, eps, weight_decay)
        count_launch("adamw", (len(part), n, part[0][0].element_size(),
                               int(part[0][4] is not None)))
        fused += n
    tracing.count("optim.fused_params", fused)
