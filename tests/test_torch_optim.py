"""The port's optimizers (`repro_torch.optim`) against the JAX package's
(`repro.optim`): the four cases of tests/test_optim.py, then AdamW
(float32 without masters, bf16 with float32 masters) and Adafactor
(matrix, stacked-matrix and vector leaves, and per-layer leaves stacked
over the periods as the reference's period tree) step for step on seeded
trees and gradients, 5 steps. Both compute in float32 in the same order:
float32 parameters and states within 2e-6 relative plus 1e-7 (the last
bits of pow, sqrt and the means; 1.0e-6 measured at most), bf16
parameters equal to the reference's bit for bit after the cast.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import optim as ref_optim
from repro_torch.optim import (adafactor, adamw, default_optimizer_for,
                               get_optimizer)

torch.set_num_threads(1)


def test_adamw_matches_reference_math():
    lr, b1, b2, eps, wd = 1e-2, 0.9, 0.95, 1e-8, 0.0
    init, update = adamw(lr=lr, b1=b1, b2=b2, eps=eps, weight_decay=wd,
                         master_weights=False)
    p = {"w": torch.tensor([1.0, -2.0, 3.0])}
    g = {"w": torch.tensor([0.1, -0.2, 0.3])}
    state = init(p)
    new_p, state = update(p, g, state, 0)
    m = 0.1 * np.array([0.1, -0.2, 0.3])
    v = 0.05 * np.array([0.1, -0.2, 0.3]) ** 2
    mh, vh = m / (1 - b1), v / (1 - b2)
    expect = np.array([1.0, -2.0, 3.0]) - lr * mh / (np.sqrt(vh) + eps)
    np.testing.assert_allclose(new_p["w"].numpy(), expect, rtol=1e-6)
    assert new_p["w"] is p["w"]                    # updated in place


def test_adamw_master_weights_bf16():
    init, update = adamw(lr=1e-2, master_weights=True)
    p = {"w": torch.ones((4,), dtype=torch.bfloat16)}
    g = {"w": torch.full((4,), 1e-3, dtype=torch.bfloat16)}
    state = init(p)
    for step in range(20):
        p, state = update(p, g, state, step)
    # bf16-quantized steps alone would lose these tiny updates; the fp32
    # master accumulates them
    assert float(state["master"]["w"][0]) < 1.0
    assert p["w"].dtype == torch.bfloat16


def test_adafactor_descends_quadratic():
    init, update = adafactor(lr=0.1)
    p = {"w": torch.tensor([[3.0, -2.0], [1.0, 4.0]], requires_grad=True)}
    state = init(p)
    assert set(state["f"]["w"].keys()) == {"vr", "vc"}
    assert state["f"]["w"]["vr"].shape == (2,)
    loss0 = float((p["w"].detach() ** 2).sum())
    for step in range(50):
        g = torch.autograd.grad((p["w"] ** 2).sum(), p["w"])[0]
        p, state = update(p, {"w": g}, state, step)
    assert float((p["w"] ** 2).sum()) < loss0 * 0.1


def test_default_optimizer_thresholds():
    assert default_optimizer_for(33e9) == "adamw"
    assert default_optimizer_for(1e12) == "adafactor"
    assert get_optimizer("adamw") is not None
    with pytest.raises(ValueError):
        get_optimizer("sgd")


SHAPES = {"mat": (6, 5), "stack": (3, 4, 7), "vec": (9,)}


def _trees(rng, dtype, steps):
    """Seeded parameters and per-step gradients, as numpy float32 (bf16
    values where `dtype` is bf16)."""
    def draw(shape, scale):
        a = (rng.normal(size=shape) * scale).astype(np.float32)
        if dtype == "bfloat16":
            a = a.astype(ml_dtypes.bfloat16).astype(np.float32)
        return a
    params = {k: draw(s, 1.0) for k, s in SHAPES.items()}
    grads = [{k: draw(s, 0.1) for k, s in SHAPES.items()}
             for _ in range(steps)]
    return params, grads


def _close(got, want, dtype):
    got = got.detach().float().numpy()
    want = np.asarray(want).astype(np.float32)
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-7)


@pytest.mark.parametrize("kind,dtype,kw", [
    ("adamw", "float32", dict(master_weights=False)),
    ("adamw", "bfloat16", dict(master_weights=True)),
    ("adamw", "float32", dict(master_weights=True, weight_decay=0.1)),
    ("adafactor", "float32", {}),
    ("adafactor", "bfloat16", {}),
])
def test_step_for_step_against_the_reference(kind, dtype, kw):
    lr = 3e-2
    params, grads = _trees(np.random.default_rng(5), dtype, 5)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    rp = {k: jnp.asarray(v).astype(jdt) for k, v in params.items()}
    # a copy: the port updates its parameters in place, and jnp.asarray may
    # alias a 64-byte aligned numpy array, so the reference's would change
    tp = {k: torch.from_numpy(v.copy()).to(tdt) for k, v in params.items()}
    r_init, r_update = ref_optim.get_optimizer(kind, lr=lr, **kw)
    t_init, t_update = get_optimizer(kind, lr=lr, **kw)
    rs, ts = r_init(rp), t_init(tp)
    update = jax.jit(r_update)
    for step, g in enumerate(grads):
        rp, rs = update(rp, {k: jnp.asarray(v).astype(jdt)
                             for k, v in g.items()}, rs, jnp.int32(step))
        tp, ts = t_update(tp, {k: torch.from_numpy(v).to(tdt)
                               for k, v in g.items()}, ts, step)
        for k in SHAPES:
            assert tp[k].dtype == tdt
            _close(tp[k], rp[k].astype(jnp.float32), dtype)
    flat_r = jax.tree_util.tree_flatten_with_path(rs)[0]
    for path, leaf in flat_r:
        node = ts
        for key in path:
            node = node[key.key]
        assert node.dtype == torch.float32 and node.shape == leaf.shape
        _close(node, leaf, "float32")


@pytest.mark.parametrize("period", [1, 2])
def test_adafactor_stacks_layers_over_the_periods(period):
    """Named per-layer leaves (``layers.{p * period + i}.*``, 4 layers)
    against the reference's period tree (``layers[i]`` stacked over p),
    step for step: the factors and the clip over each stack, a layer
    vector factored as a (periods, d) matrix, the state keyed by the
    stack's first layer."""
    lr, n_layers = 3e-2, 4
    rng = np.random.default_rng(11)
    leaf_shapes = {"w": (6, 5), "scale": (7,)}
    draw = lambda *s: rng.normal(size=s).astype(np.float32)
    layers = [{k: draw(*s) for k, s in leaf_shapes.items()}
              for _ in range(n_layers)]
    grads = [[{k: draw(*s) * 10.0 ** -j for k, s in leaf_shapes.items()}
              for j in range(n_layers)] for _ in range(5)]

    def ref_tree(per_layer):
        return {"layers": [{k: jnp.stack([per_layer[p * period + i][k]
                                          for p in range(n_layers // period)])
                            for k in leaf_shapes} for i in range(period)],
                "head": jnp.ones(leaf_shapes["w"])}

    def port_tree(per_layer):
        out = {f"layers.{j}.{k}": torch.from_numpy(np.array(v))
               for j, layer in enumerate(per_layer) for k, v in layer.items()}
        out["head"] = torch.ones(leaf_shapes["w"])
        return out
    r_init, r_update = ref_optim.get_optimizer("adafactor", lr=lr)
    t_init, t_update = get_optimizer("adafactor", lr=lr, period=period)
    rp, tp = ref_tree(layers), port_tree(layers)
    rs, ts = r_init(rp), t_init(tp)
    assert set(ts["f"]) == {f"layers.{i}.{k}" for i in range(period)
                            for k in leaf_shapes} | {"head"}
    update = jax.jit(r_update)
    for step, g in enumerate(grads):
        rg = ref_tree(g)
        rg["head"] = jnp.full(leaf_shapes["w"], 0.5)
        tg = port_tree(g)
        tg["head"] = torch.full(leaf_shapes["w"], 0.5)
        rp, rs = update(rp, rg, rs, jnp.int32(step))
        tp, ts = t_update(tp, tg, ts, step)
    for j in range(n_layers):
        p, i = divmod(j, period)
        for k in leaf_shapes:
            _close(tp[f"layers.{j}.{k}"], rp["layers"][i][k][p], "float32")
    for i in range(period):
        for k in leaf_shapes:
            for f, v in ts["f"][f"layers.{i}.{k}"].items():
                _close(v, rs["f"]["layers"][i][k][f], "float32")
