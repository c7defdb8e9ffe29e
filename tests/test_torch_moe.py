"""The port's Mixture-of-Experts layer (`repro_torch.nn.moe`) against the
reference's (`repro.nn.moe`), on the same numpy inputs and the reference's
parameters carried across.

Float32 on the CPU: outputs and the aux loss at 2e-5 (the same arithmetic
in another order); the routing's integers - positions within an expert,
the slot map, the dispatch map and with them which tokens drop - bit for
bit. The reference's maps are read off its own `moe_apply`: the first
`take_along_axis` it calls gathers the dispatch map, the second the slot
map.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nn import moe as ref_moe
from repro_torch.models.lm import _tree
from repro_torch.nn import moe
from repro_torch.nn.layers import Params, normal

torch.set_num_threads(1)
T = torch.from_numpy
TOL = dict(rtol=2e-5, atol=2e-5)

# the four cases of tests/test_moe.py: (d, d_ff, E, k, shared, x's shape,
# capacity factor)
CASES = {
    "ample": (32, 64, 4, 2, 0, (2, 16), 8.0),
    "shared": (16, 32, 4, 1, 1, (1, 8), 8.0),
    "drops": (16, 32, 2, 1, 0, (1, 32), 0.1),
    "grouped": (16, 32, 4, 2, 0, (3, 16), 8.0),
}


def _port_params(p) -> Params:
    return Params(_tree(jax.tree.map(np.asarray, p), "cpu"))


def _case(name, seed=0):
    d, dff, E, k, shared, shape, cf = CASES[name]
    p = ref_moe.init_moe(jax.random.PRNGKey(seed), d, dff, E, k,
                         n_shared=shared)
    x = np.random.default_rng(seed).normal(size=(*shape, d)).astype(
        np.float32)
    return p, x, dict(n_experts=E, top_k=k, capacity_factor=cf)


def _ref_apply(p, x, kw, monkeypatch):
    """The reference's (y, aux, dispatch map, slot map) from one call."""
    seen = []
    real = jnp.take_along_axis

    def spy(a, idx, *args, **kwargs):
        seen.append(np.asarray(idx)[..., 0])
        return real(a, idx, *args, **kwargs)

    with monkeypatch.context() as m:
        m.setattr(ref_moe.jnp, "take_along_axis", spy)
        y, aux = ref_moe.moe_apply(p, jnp.asarray(x), **kw)
    idx, slot = seen
    return np.asarray(y), float(aux), idx, slot


def _dense_oracle(p, x, E, k):
    """Every token through its top-k experts, no capacity (float64)."""
    pf = jax.tree.map(lambda a: np.asarray(a, np.float64), p)
    xt = x.reshape(-1, x.shape[-1]).astype(np.float64)
    logits = xt @ pf["router"]["w"]
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    idx = np.argsort(-probs, axis=-1, kind="stable")[:, :k]
    gates = np.take_along_axis(probs, idx, -1)
    gates /= gates.sum(-1, keepdims=True)
    silu = lambda v: v / (1 + np.exp(-v))                       # noqa: E731
    y = np.zeros_like(xt)
    for t in range(xt.shape[0]):
        for e, g in zip(idx[t], gates[t]):
            h = silu(xt[t] @ pf["w_gate"][e]) * (xt[t] @ pf["w_up"][e])
            y[t] += g * (h @ pf["w_down"][e])
    if "shared" in pf:
        s = pf["shared"]
        y += (silu(xt @ s["w_gate"]["w"]) * (xt @ s["w_up"]["w"])) \
            @ s["w_down"]["w"]
    return y.reshape(x.shape), idx


@pytest.mark.parametrize("name", list(CASES))
def test_moe_apply_matches_the_reference(name, monkeypatch):
    p, x, kw = _case(name)
    want, want_aux, want_idx, want_slot = _ref_apply(p, x, kw, monkeypatch)
    tp = _port_params(p)
    got, aux = moe.moe_apply(tp, T(x), **kw)
    assert got.dtype == torch.float32 and aux.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(float(aux), want_aux, **TOL)
    # the same routing, so the same maps and the same drops
    B, S, d = x.shape
    G, Sg, C = moe.capacity(B, S, kw["n_experts"], kw["top_k"],
                            kw["capacity_factor"])
    _, _, _, gate_idx = moe.route(tp, T(x).reshape(G, Sg, d), kw["top_k"])
    slot, idx = moe.dispatch(gate_idx, kw["n_experts"], C)
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    np.testing.assert_array_equal(slot.numpy(), want_slot)
    # against the dense oracle, token by token where nothing dropped
    oracle, oracle_idx = _dense_oracle(p, x, kw["n_experts"], kw["top_k"])
    np.testing.assert_array_equal(gate_idx.reshape(-1, kw["top_k"]).numpy(),
                                  oracle_idx)
    dropped = (slot.numpy() == kw["n_experts"] * C).reshape(
        B * S, kw["top_k"]).any(-1)
    assert dropped.any() == (name == "drops")
    kept = ~dropped
    np.testing.assert_allclose(got.numpy().reshape(B * S, d)[kept],
                               oracle.reshape(B * S, d)[kept], rtol=2e-4,
                               atol=2e-4)
    if name == "drops":                 # top-1, no shared expert: y = 0
        assert not got.numpy().reshape(B * S, d)[dropped].any()


@pytest.mark.parametrize("flat", [
    [0, 1, 0, 2, 1, 0, 3, 3],
    [2] * 9,                            # every token on one expert
    [5, 0, 5, 0],                       # experts 1-4 and 6-7 empty
    [7, 6, 5, 4, 3, 2, 1, 0],
    [1],
])
def test_positions_in_expert_equal_the_reference(flat):
    E = 8
    a = np.asarray(flat, np.int32)
    want = np.asarray(ref_moe._positions_in_expert(jnp.asarray(a), E))
    got = moe._positions_in_expert(T(a.astype(np.int64)), E)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_positions_in_expert_take_rows_and_random_ids():
    rng = np.random.default_rng(3)
    for E, n in ((4, 64), (16, 40), (384, 32)):
        a = rng.integers(0, E, (3, n)).astype(np.int32)
        want = np.stack([np.asarray(ref_moe._positions_in_expert(
            jnp.asarray(r), E)) for r in a])
        got = moe._positions_in_expert(T(a.astype(np.int64)), E)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("B,S,E,k,cf", [
    (1, 16, 4, 2, 1.0),         # Sg * k * cf / E = 8 exactly
    (1, 32, 4, 1, 1.25),        # 10.0 exactly, rounded up to 16
    (1, 100, 1, 1, 0.57),       # 56.99999999999999 in float64: C 56, not 64
    (1, 4, 16, 4, 8.0),         # one group; C 32 clipped to Sg = 4
    (4, 1, 384, 8, 1.25),       # kimi-k2's decode: C 1 -> 8 -> Sg = 4
    (4, 1, 16, 1, 1.25),        # llama4-scout's decode: C 4 = Sg
    (2, 64, 16, 1, 1.25),       # grouped (S k = 4 E), C 8
    (3, 5, 2, 1, 0.01),         # C floored at 1, rounded up to 8
])
def test_capacity_equals_the_reference(B, S, E, k, cf, monkeypatch):
    d = 4
    p = ref_moe.init_moe(jax.random.PRNGKey(0), d, 8, E, k)
    x = np.random.default_rng(0).normal(size=(B, S, d)).astype(np.float32)
    _, _, idx, slot = _ref_apply(p, x, dict(n_experts=E, top_k=k,
                                            capacity_factor=cf), monkeypatch)
    G, Sg, C = moe.capacity(B, S, E, k, cf)
    assert idx.shape == (G, E * C) and slot.shape == (G, Sg * k)


def test_dispatch_equals_the_reference_on_its_gates(monkeypatch):
    """The maps from the reference's own top-k choices (many drops: C = 8
    for 64 choices over 3 experts)."""
    B, S, E, k, d = 1, 32, 3, 2, 8
    p = ref_moe.init_moe(jax.random.PRNGKey(2), d, 8, E, k)
    x = np.random.default_rng(2).normal(size=(B, S, d)).astype(np.float32)
    kw = dict(n_experts=E, top_k=k, capacity_factor=0.3)
    _, _, want_idx, want_slot = _ref_apply(p, x, kw, monkeypatch)
    logits = jnp.asarray(x).reshape(1, S, d) @ p["router"]["w"]
    _, gate_idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), k)
    G, Sg, C = moe.capacity(B, S, E, k, 0.3)
    slot, idx = moe.dispatch(T(np.asarray(gate_idx).astype(np.int64)), E, C)
    np.testing.assert_array_equal(slot.numpy(), want_slot)
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    assert (want_slot == E * C).sum() > 0


def test_bf16_matches_the_reference_within_one_bf16_rounding():
    """bf16 weights and activations, the router float32 in both: equal
    routing, and outputs within one bf16 rounding (2**-8 relative) of the
    reference's, at the scale of the output."""
    d, dff, E, k = 64, 128, 8, 2
    p = ref_moe.init_moe(jax.random.PRNGKey(4), d, dff, E, k, n_shared=1,
                         dtype=jnp.bfloat16)
    assert p["router"]["w"].dtype == jnp.float32
    x = np.random.default_rng(4).normal(size=(4, 1, d)).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    kw = dict(n_experts=E, top_k=k, capacity_factor=1.25)
    want, want_aux = ref_moe.moe_apply(p, xb, **kw)
    tp = _port_params(p)
    assert tp["w_up"].dtype == torch.bfloat16
    assert tp["router"]["w"].dtype == torch.float32
    got, aux = moe.moe_apply(tp, T(x).bfloat16(), **kw)
    assert got.dtype == torch.bfloat16
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=2**-8 * np.abs(want).max())
    np.testing.assert_allclose(float(aux), float(want_aux), **TOL)


def test_init_moe_shapes_types_and_distributions():
    d, dff, E, k = 64, 96, 6, 2
    gen = torch.Generator().manual_seed(0)
    p = moe.init_moe(gen, d, dff, E, k, n_shared=2, dtype=torch.bfloat16,
                     device="cpu")
    want = jax.eval_shape(lambda: ref_moe.init_moe(
        jax.random.PRNGKey(0), d, dff, E, k, n_shared=2, dtype=jnp.bfloat16))
    got = {n: (tuple(t.shape), str(t.dtype).removeprefix("torch."))
           for n, t in p.named_parameters()}
    assert got == {".".join(c.key for c in path): (leaf.shape,
                                                   str(leaf.dtype))
                   for path, leaf in jax.tree_util.tree_flatten_with_path(
                       want)[0]}
    assert p["router"]["w"].dtype == torch.float32
    # each tensor's std within 5 % of the reference's scale, every expert
    for name, scale in (("w_gate", d ** -0.5), ("w_up", d ** -0.5),
                        ("w_down", dff ** -0.5)):
        w = p[name].float()
        for e in range(E):
            assert abs(float(w[e].std()) / scale - 1) < 0.05, (name, e)
            assert abs(float(w[e].mean())) / scale < 0.05, (name, e)
    assert abs(float(p["router"]["w"].std()) * d ** 0.5 - 1) < 0.05
    assert abs(float(p["shared"]["w_down"]["w"].float().std())
               * (2 * dff) ** 0.5 - 1) < 0.05


def test_init_moe_draws_experts_as_one_draw_of_the_whole_would():
    """One expert at a time against one float32 draw of the whole tensor
    (`layers.normal`): the same N(0, scale^2) by mean, std and quantiles."""
    E, d, f = 8, 128, 256
    gen = torch.Generator().manual_seed(5)
    a = moe._experts(gen, (E, d, f), d ** -0.5, torch.float32, "cpu")
    b = normal(torch.Generator().manual_seed(6), (E, d, f), d ** -0.5,
               torch.float32)
    assert a.shape == b.shape and a.dtype == b.dtype
    qs = torch.tensor([0.01, 0.1, 0.25, 0.5, 0.75, 0.9, 0.99])
    qa = torch.quantile(a.reshape(-1)[:2**18], qs)
    qb = torch.quantile(b.reshape(-1)[:2**18], qs)
    np.testing.assert_allclose(qa.numpy(), qb.numpy(), rtol=0,
                               atol=0.02 * d ** -0.5 * 3)
    assert abs(float(a.std()) / float(b.std()) - 1) < 0.01
    assert not torch.equal(a[0], a[1])          # experts draw anew
    a16 = moe._experts(torch.Generator().manual_seed(5), (E, d, f),
                       d ** -0.5, torch.bfloat16, "cpu")
    np.testing.assert_array_equal(a16.float().numpy(),
                                  a.bfloat16().float().numpy())
