"""The port's LM serving path vs the JAX package's, through weights carried
across with `params_from_reference`, for the nine smoke configs without an
encoder-decoder (the three MoE ones among them); the layers that hold a
kernel against the reference's kernel path in interpret mode; the float32
scan (K18); and the ten configs, field for field.

Everything is float32 on the CPU. Port against reference: 2e-5 (the same
arithmetic in another order), the MoE models' aux loss too; the port's
token-by-token decode against its own parallel prefill: 2e-3, as the
reference's own test (`tests/test_models.py::
test_decode_matches_parallel_apply`), which leaves MoE out because capacity
routing depends on the batch: here the MoE models run it with the capacity
factor raised to E, so that C = Sg and no token drops. Greedy tokens must
be equal.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.kernels import common as ref_common
from repro.kernels.dict_ops import scan_filter_agg as ref_scan_filter_agg
from repro.launch import steps as ref_steps
from repro.models import lm as ref_lm
from repro.nn import attention as ref_attention
from repro.nn import flash as ref_flash
from repro.nn import mamba as ref_mamba
from repro_torch import configs
from repro_torch.kernels.dict_ops import scan_filter_agg
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models.lm import (LM, init_lm, init_lm_cache, lm_apply,
                                   lm_decode_step, params_from_reference)
from repro_torch.nn import attention, flash, mamba
from repro_torch.nn.layers import Params

torch.set_num_threads(1)
T = torch.from_numpy
TOL = dict(rtol=2e-5, atol=2e-5)
MOE_ARCHS = ["kimi-k2-1t-a32b", "llama4-scout-17b-a16e",
             "jamba-1.5-large-398b"]
SERVE_ARCHS = ["falcon-mamba-7b", "internvl2-26b", "phi3-medium-14b",
               "deepseek-coder-33b", "gemma2-9b", "qwen2.5-14b", *MOE_ARCHS]
B, S = 2, 10


@functools.lru_cache(maxsize=None)
def _ref_model(name):
    """(reference cfg, its params, the port's cfg, the port's LM)."""
    cfg = ref_configs.get_smoke_config(name)
    params = ref_lm.init_lm(jax.random.PRNGKey(0), cfg)
    tree = jax.tree.map(np.asarray, params)
    tcfg = configs.get_smoke_config(name)
    return cfg, params, tcfg, params_from_reference(tcfg, tree, "cpu")


def _tokens(cfg, seed=0, n=S):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, n)).astype(np.int32)


def _patches(cfg):
    if cfg.frontend != "patch":
        return None
    return np.random.default_rng(1).normal(
        size=(B, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("name", configs.ARCH_NAMES)
def test_configs_equal_the_reference_field_for_field(name):
    for get in ("get_config", "get_smoke_config"):
        got = getattr(configs, get)(name)
        want = getattr(ref_configs, get)(name)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.param_count() == want.param_count()
        assert got.active_param_count() == want.active_param_count()
        assert (got.pdtype, got.adtype) == (
            getattr(torch, want.param_dtype), getattr(torch, want.activ_dtype))
    for shape in configs.SHAPES:
        assert configs.shape_applicable(name, shape) == \
            ref_configs.shape_applicable(name, shape)


def test_config_tables_equal_the_reference():
    assert configs.ARCH_NAMES == ref_configs.ARCH_NAMES
    assert {k: dataclasses.astuple(v) for k, v in configs.SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in ref_configs.SHAPES.items()}
    assert configs.cells() == ref_configs.cells()


@pytest.mark.parametrize("name", SERVE_ARCHS)
def test_lm_apply_matches_the_reference(name):
    cfg, params, tcfg, model = _ref_model(name)
    toks, pe = _tokens(cfg), _patches(cfg)
    want, want_aux = ref_lm.lm_apply(params, jnp.asarray(toks), cfg,
                                     None if pe is None else jnp.asarray(pe))
    got, aux = model(T(toks), None if pe is None else T(pe))
    assert got.dtype == torch.float32 and got.shape == (B, S, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert aux.dtype == torch.float32 and aux.shape == ()
    if name in MOE_ARCHS:
        assert float(want_aux) > 0
        np.testing.assert_allclose(float(aux), float(want_aux), **TOL)
    else:
        assert float(aux) == float(want_aux) == 0.0


@pytest.mark.parametrize("name", SERVE_ARCHS)
def test_prefill_step_matches_the_reference(name):
    cfg, params, tcfg, model = _ref_model(name)
    toks, pe = _tokens(cfg, seed=2), _patches(cfg)
    batch = {"tokens": jnp.asarray(toks)}
    tbatch = {"tokens": T(toks)}
    if pe is not None:
        batch["patch_embeds"], tbatch["patch_embeds"] = jnp.asarray(pe), T(pe)
    want = ref_steps.make_prefill_step(cfg)(params, batch)
    got = make_prefill_step(tcfg)(model, tbatch)
    assert got.shape == (B, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("name", SERVE_ARCHS)
def test_decode_steps_match_the_reference(name):
    cfg, params, tcfg, model = _ref_model(name)
    toks = _tokens(cfg, seed=3)
    step = jax.jit(ref_lm.lm_decode_step, static_argnums=4)
    ref_cache = ref_lm.init_lm_cache(cfg, B, S, dtype=jnp.float32)
    cache = init_lm_cache(tcfg, B, S, dtype=torch.float32, device="cpu")
    assert len(cache) == tcfg.n_layers
    for i in range(S):
        want, ref_cache = step(params, ref_cache, jnp.asarray(toks[:, i:i + 1]),
                               jnp.int32(i), cfg)
        got, cache = lm_decode_step(model, cache, T(toks[:, i:i + 1]), i,
                                    tcfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("name", SERVE_ARCHS)
def test_serve_step_tokens_match_the_reference(name):
    """Greedy serving as `examples/serve_lm.py` drives it: a prompt fed one
    token at a time, then generated tokens fed back, with a cache shorter
    than the run for gemma2's rolling local layers (window 8)."""
    cfg, params, tcfg, model = _ref_model(name)
    prompt, n_gen, max_len = _tokens(cfg, seed=4, n=4), 8, 16
    serve = jax.jit(ref_steps.make_serve_step(cfg))
    ref_cache = ref_lm.init_lm_cache(cfg, B, max_len, dtype=jnp.float32)
    step = make_serve_step(tcfg)
    cache = init_lm_cache(tcfg, B, max_len, dtype=torch.float32,
                          device="cpu")
    want_tok = got_tok = None
    for i in range(prompt.shape[1] + n_gen - 1):
        if i < prompt.shape[1]:
            want_tok, got_tok = jnp.asarray(prompt[:, i:i + 1]), T(
                prompt[:, i:i + 1])
        want_tok, ref_cache = serve(params, ref_cache, want_tok, jnp.int32(i))
        got_tok, cache = step(model, cache, got_tok, i)
        assert got_tok.dtype == torch.int32 and got_tok.shape == (B, 1)
        np.testing.assert_array_equal(got_tok.numpy(), np.asarray(want_tok))


@pytest.mark.parametrize("name", SERVE_ARCHS)
def test_decode_matches_parallel_apply_in_the_port(name):
    """The port's own token-by-token decode reproduces its parallel
    logits (on the card: the decode-attention kernel or the plain Mamba
    step against the plain prefill attention or the scan kernel); a MoE
    model with its capacity factor raised to E, so that nothing drops."""
    _, _, tcfg, model = _ref_model(name)
    if name in MOE_ARCHS:
        tcfg = dataclasses.replace(tcfg,
                                   capacity_factor=float(tcfg.n_experts))
    toks = T(_tokens(tcfg, seed=5))
    want, _ = lm_apply(model, toks, tcfg)
    cache = init_lm_cache(tcfg, B, S, dtype=torch.float32, device="cpu")
    for i in range(S):
        got, cache = lm_decode_step(model, cache, toks[:, i:i + 1], i, tcfg)
        np.testing.assert_allclose(got[:, 0].numpy(), want[:, i].numpy(),
                                   rtol=2e-3, atol=2e-3)


def test_params_from_reference_keeps_bf16_weights():
    """A bf16 config's reference tree (ml_dtypes bfloat16 leaves) loads as
    bf16 tensors with the same values; the forward runs in bf16."""
    cfg = dataclasses.replace(ref_configs.get_smoke_config("qwen2.5-14b"),
                              param_dtype="bfloat16",
                              activ_dtype="bfloat16")
    params = ref_lm.init_lm(jax.random.PRNGKey(1), cfg)
    tcfg = dataclasses.replace(configs.get_smoke_config("qwen2.5-14b"),
                               param_dtype="bfloat16",
                               activ_dtype="bfloat16")
    model = params_from_reference(tcfg, jax.tree.map(np.asarray, params),
                                  "cpu")
    w = model.layers[1]["attn"]["wq"]["w"]
    assert w.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        w.float().numpy(),
        np.asarray(params["layers"][0]["attn"]["wq"]["w"][1], np.float32))
    toks = _tokens(cfg, seed=6)
    want, _ = ref_lm.lm_apply(params, jnp.asarray(toks), cfg)
    got, _ = lm_apply(model, T(toks), tcfg)
    assert np.isfinite(got.numpy()).all()
    # bf16 activations round at other places in the two frameworks: two
    # bf16 steps at the logits' magnitude (about 4, where a step is 2**-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2 * 2.0**-5)


def test_init_lm_draws_the_reference_distributions():
    cfg = configs.get_smoke_config("gemma2-9b")
    gen = torch.Generator().manual_seed(0)
    model = init_lm(cfg, generator=gen, device="cpu")
    assert isinstance(model, LM) and len(model.layers) == cfg.n_layers
    ref_tree = jax.eval_shape(lambda: ref_lm.init_lm(
        jax.random.PRNGKey(0), ref_configs.get_smoke_config("gemma2-9b")))
    for i, layer in enumerate(model.layers):
        assert layer.spec == cfg.blocks[i % cfg.period]
        want = {".".join(k.key for k in path): (leaf.shape[1:], leaf.dtype)
                for path, leaf in jax.tree_util.tree_flatten_with_path(
                    ref_tree["layers"][i % cfg.period])[0]}
        got = {name: (tuple(t.shape), str(t.dtype).removeprefix("torch."))
               for name, t in layer.named_parameters()}
        assert got == {k: (tuple(s), str(d)) for k, (s, d) in want.items()}
    table = model.embed["table"]
    assert abs(float(table.std()) - 1.0) < 0.05
    w = model.layers[0]["attn"]["wq"]["w"]
    assert abs(float(w.std()) * cfg.d_model ** 0.5 - 1.0) < 0.05
    assert not any(p.requires_grad for p in model.parameters())
    bf = init_lm(cfg, generator=gen, device="cpu", dtype=torch.bfloat16)
    assert bf.head["w"].dtype == torch.bfloat16


def test_init_lm_moe_draws_the_reference_distributions():
    """A MoE model in bf16: the reference's tree, its router float32, the
    experts drawn one at a time at the reference's scales."""
    name = "kimi-k2-1t-a32b"
    cfg = configs.get_smoke_config(name)
    model = init_lm(cfg, generator=torch.Generator().manual_seed(0),
                    device="cpu", dtype=torch.bfloat16)
    ref_tree = jax.eval_shape(lambda: ref_lm.init_lm(
        jax.random.PRNGKey(0), ref_configs.get_smoke_config(name)))
    for layer in model.layers:
        want = {".".join(k.key for k in path): leaf.shape[1:]
                for path, leaf in jax.tree_util.tree_flatten_with_path(
                    ref_tree["layers"][0])[0]}
        got = {n: tuple(t.shape) for n, t in layer.named_parameters()}
        assert got == {k: tuple(s) for k, s in want.items()}
        moe = layer["moe"]
        assert moe["router"]["w"].dtype == torch.float32
        assert moe["w_gate"].dtype == moe["shared"]["w_up"]["w"].dtype == \
            torch.bfloat16
        for n, fan_in in (("w_gate", cfg.d_model), ("w_up", cfg.d_model),
                          ("w_down", cfg.d_ff)):
            std = moe[n].float().std(dim=(1, 2)) * fan_in ** 0.5
            assert float((std - 1).abs().max()) < 0.1, n


# ---------------------------------------------------------------------------
# The layers that hold a kernel, against the reference's kernel path
# ---------------------------------------------------------------------------

def _attn_params(rng, d_model, H, Hkv, hd):
    return {n: {"w": (rng.normal(size=(di, do)) * di ** -0.5).astype(
        np.float32)} for n, di, do in (("wq", d_model, H * hd),
                                       ("wk", d_model, Hkv * hd),
                                       ("wv", d_model, Hkv * hd),
                                       ("wo", H * hd, d_model))}


@pytest.mark.parametrize("window,index,cap", [(0, 700, 0.0), (512, 900, 50.0),
                                              (0, 0, 30.0)])
def test_attention_decode_matches_the_reference_kernel_path(rng, window,
                                                            index, cap):
    """`attention_decode(use_kernel=True)` runs the Pallas kernel in
    interpret mode (S 512 or 1024: the kernel's wrapper takes multiples of
    512 only); the port's layer takes its kernel's plain version here."""
    d_model, H, Hkv, hd = 32, 4, 2, 64
    S_max = window or 1024
    p = _attn_params(rng, d_model, H, Hkv, hd)
    x = rng.normal(size=(B, 1, d_model)).astype(np.float32)
    k = rng.normal(size=(B, S_max, Hkv, hd)).astype(np.float32)
    v = rng.normal(size=(B, S_max, Hkv, hd)).astype(np.float32)
    kw = dict(n_heads=H, n_kv_heads=Hkv, head_dim=hd, window=window,
              attn_softcap=cap)
    want, want_cache = ref_attention.attention_decode(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x),
        {"k": jnp.asarray(k), "v": jnp.asarray(v)}, jnp.int32(index),
        use_kernel=True, **kw)
    cache = {"k": T(k.copy()), "v": T(v.copy())}
    got, got_cache = attention.attention_decode(
        Params(jax.tree.map(T, p)), T(x), cache, index, **kw)
    assert got_cache is cache                       # updated in place
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for n in ("k", "v"):
        np.testing.assert_allclose(cache[n].numpy(),
                                   np.asarray(want_cache[n]), **TOL)


def _mamba_params(rng, d_model, di, N, K, R):
    dense = (lambda a, b: {"w": (rng.normal(size=(a, b)) * a ** -0.5)
                           .astype(np.float32)})
    return {"in_proj": dense(d_model, 2 * di),
            "conv_w": (rng.normal(size=(K, di)) * K ** -0.5).astype(
                np.float32),
            "conv_b": rng.normal(size=(di,)).astype(np.float32) * 0.1,
            "x_proj": dense(di, R + 2 * N),
            "dt_proj": {**dense(R, di),
                        "b": rng.normal(size=(di,)).astype(np.float32)},
            "a_log": np.log(np.tile(np.arange(1, N + 1, dtype=np.float32),
                                    (di, 1))),
            "d_skip": np.ones((di,), np.float32),
            "out_proj": dense(di, d_model)}


def test_mamba_train_matches_the_reference_kernel_path(rng):
    """`mamba_train(use_kernel=True)` runs the Pallas scan in interpret mode
    (d_inner 128 and T 256: its wrapper's blocks)."""
    d_model, di, N, K, R, Tn = 64, 128, 4, 4, 4, 256
    p = _mamba_params(rng, d_model, di, N, K, R)
    x = rng.normal(size=(1, Tn, d_model)).astype(np.float32)
    kw = dict(d_inner=di, d_state=N, d_conv=K, dt_rank=R)
    want = ref_mamba.mamba_train(jax.tree.map(jnp.asarray, p),
                                 jnp.asarray(x), use_kernel=True, **kw)
    got = mamba.mamba_train(Params(jax.tree.map(T, p)), T(x), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-5,
                               atol=3e-5)


def test_mamba_decode_matches_the_reference(rng):
    d_model, di, N, K, R = 64, 128, 4, 4, 4
    p = _mamba_params(rng, d_model, di, N, K, R)
    kw = dict(d_inner=di, d_state=N, d_conv=K, dt_rank=R)
    ref_cache = ref_mamba.init_mamba_cache(B, di, N, K)
    cache = mamba.init_mamba_cache(B, di, N, K)
    for _ in range(3):
        x = rng.normal(size=(B, 1, d_model)).astype(np.float32)
        want, ref_cache = ref_mamba.mamba_decode(
            jax.tree.map(jnp.asarray, p), jnp.asarray(x), ref_cache, **kw)
        got, cache = mamba.mamba_decode(Params(jax.tree.map(T, p)), T(x),
                                        cache, **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        for n in ("conv", "ssm"):
            np.testing.assert_allclose(cache[n].numpy(),
                                       np.asarray(ref_cache[n]), **TOL)


@pytest.mark.parametrize("kw", [dict(causal=True), dict(causal=True,
                                                        window=24),
                                dict(causal=False),
                                dict(causal=True, softcap=30.0)])
def test_flash_attention_matches_the_reference_and_sdpa(rng, kw):
    Bn, Sn, H, Hkv, dh = 2, 64, 4, 2, 16
    q, k, v = (rng.normal(size=(Bn, Sn, h, dh)).astype(np.float32)
               for h in (H, Hkv, Hkv))
    blocks = dict(q_block=16, kv_block=32)
    want = ref_flash.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), **kw, **blocks)
    got = flash.flash_attention(T(q), T(k), T(v), **kw, **blocks)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    mask = (attention.causal_mask(Sn, kw.get("window", 0))
            if kw["causal"] else torch.ones((1, Sn, Sn), dtype=torch.bool))
    plain = attention._sdpa(T(q), T(k), T(v), mask[:, None],
                            kw.get("softcap", 0.0))
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL)


def test_attention_train_takes_the_blocked_path_as_the_reference(rng):
    """At S >= 2048 and S % 1024 == 0 both take the blocked attention."""
    d_model, H, Hkv, hd, Sn = 16, 2, 1, 64, 2048
    p = _attn_params(rng, d_model, H, Hkv, hd)
    x = rng.normal(size=(1, Sn, d_model)).astype(np.float32)
    kw = dict(n_heads=H, n_kv_heads=Hkv, head_dim=hd, window=100,
              attn_softcap=50.0)
    want = ref_attention.attention_train(jax.tree.map(jnp.asarray, p),
                                         jnp.asarray(x), **kw)
    got = attention.attention_train(Params(jax.tree.map(T, p)), T(x), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


# ---------------------------------------------------------------------------
# K18: the float32 scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,k", [(1, 1), (4097, 300), (50_000, 20_000)])
def test_float_scan_matches_the_reference_kernel_in_interpret_mode(n, k):
    rng = np.random.default_rng(n)
    f = rng.integers(0, k, n).astype(np.int32)
    a = rng.integers(0, k, n).astype(np.int32)
    valid = rng.random(n) < 0.9
    dic = np.sort(rng.integers(-2**24, 2**24, k)).astype(np.int32)
    ref_common.set_interpret_override("1")
    try:
        for lo, hi in ((0, k), (k // 4, k // 2 + 1), (3, 3)):
            want_s, want_c = ref_scan_filter_agg(
                jnp.asarray(f), jnp.asarray(a), jnp.asarray(valid),
                jnp.asarray(dic), lo, hi)
            s, c = scan_filter_agg(T(f), T(a), T(valid), T(dic), lo, hi,
                                   exact=False)
            assert (s.dtype, c.dtype) == (torch.float32, torch.int32)
            assert int(c) == int(want_c)
            np.testing.assert_allclose(float(s), float(want_s), rtol=1e-5)
    finally:
        ref_common.set_interpret_override(None)
