"""The port's encoder-decoder (whisper) against the JAX package's, on the
CPU in float32, through the reference's `whisper-base-smoke` weights
carried across with `encdec_params_from_reference`: `init_encdec`'s tree
and draws, `encode`, `encdec_apply`, the prefill step, the cross K/V,
every decode step, the serve step's tokens, `encdec_loss` (unchunked and
in two chunks) and its gradients, remat, and the cross and bidirectional
attentions on their blocked and plain branches.

Port against reference: 2e-5 (the same arithmetic in another order), as
`tests/test_torch_lm.py`; the port's token-by-token decode against its
own parallel apply: 2e-3, as the reference's own
`tests/test_models.py::test_encdec_decode_matches_parallel_apply`; greedy
tokens equal; gradients within GRAD_TOL of the leaf's largest |g|, as
`tests/test_torch_train.py`.
"""

import functools

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.launch import steps as ref_steps
from repro.models import encdec as ref_encdec
from repro.nn import attention as ref_attention
from repro.nn import flash as ref_flash
from repro_torch import configs
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models import encdec
from repro_torch.models.encdec import (EncDec, encdec_apply,
                                       encdec_decode_step, encdec_loss,
                                       encdec_params_from_reference, encode,
                                       init_encdec, init_encdec_cache,
                                       precompute_cross_kv)
from repro_torch.nn import attention
from repro_torch.nn import flash
from repro_torch.nn.layers import Params

torch.set_num_threads(1)
T = torch.from_numpy
TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = 2e-5          # of the leaf's largest |g|
NAME = "whisper-base"
B, S, TE = 2, 10, 16     # batch, decoder tokens, encoder frames


@functools.lru_cache(maxsize=None)
def _ref():
    """(reference cfg, its params, the port's cfg, the port's model)."""
    cfg = ref_configs.get_smoke_config(NAME)
    params = ref_encdec.init_encdec(jax.random.PRNGKey(0), cfg)
    tcfg = configs.get_smoke_config(NAME)
    return cfg, params, tcfg, encdec_params_from_reference(
        tcfg, jax.tree.map(np.asarray, params), "cpu")


def _inputs(cfg, seed=0, n=S, te=TE):
    rng = np.random.default_rng(seed)
    frames = rng.normal(size=(B, te, cfg.d_model)).astype(np.float32)
    toks = rng.integers(0, cfg.vocab_size, (B, n)).astype(np.int32)
    return frames, toks


def _path(path) -> str:
    return ".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path)


def _leaf(tree, name):
    """The reference's leaf under the port's parameter name."""
    node = tree
    for k in name.split("."):
        node = node[int(k)] if isinstance(node, (list, tuple)) else node[k]
    return np.asarray(node)


def test_init_encdec_matches_the_reference_tree_and_draws():
    cfg = configs.get_smoke_config(NAME)
    gen = torch.Generator().manual_seed(0)
    model = init_encdec(cfg, generator=gen, device="cpu")
    assert isinstance(model, EncDec)
    assert (len(model.enc), len(model.dec)) == (cfg.n_enc_layers,
                                                cfg.n_layers)
    ref_tree = jax.eval_shape(lambda: ref_encdec.init_encdec(
        jax.random.PRNGKey(0), ref_configs.get_smoke_config(NAME)))
    want = {_path(path): (tuple(leaf.shape), str(leaf.dtype))
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                ref_tree)[0]}
    got = {n: (tuple(t.shape), str(t.dtype).removeprefix("torch."))
           for n, t in model.named_parameters()}
    assert got == want
    assert not any(p.requires_grad for p in model.parameters())
    # N(0, 1) embedding, N(0, 1/fan_in) dense weights, unit norms
    assert abs(float(model.embed["table"].std()) - 1.0) < 0.05
    for w in (model.enc[0]["attn"]["wq"]["w"],
              model.dec[1]["xattn"]["wv"]["w"],
              model.dec[0]["mlp"]["w_gate"]["w"], model.head["w"]):
        assert abs(float(w.std()) * w.shape[0] ** 0.5 - 1.0) < 0.05
    assert abs(float(model.dec[0]["mlp"]["w_down"]["w"].mean())) < 0.01
    for norm in (model.ln_enc, model.ln_f, model.dec[1]["lnx"]):
        assert torch.equal(norm["scale"], torch.ones(cfg.d_model))
    bf = init_encdec(cfg, generator=gen, device="cpu", dtype=torch.bfloat16)
    assert {p.dtype for p in bf.parameters()} == {torch.bfloat16}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            init_encdec(cfg, generator=gen)


def test_lm_refuses_an_encoder_decoder_and_names_init_encdec():
    from repro_torch.models.lm import init_lm, init_lm_cache
    cfg = configs.get_smoke_config(NAME)
    for make in (lambda: init_lm(cfg, generator=torch.Generator(),
                                 device="cpu"),
                 lambda: init_lm_cache(cfg, 1, 8, device="cpu")):
        with pytest.raises(ValueError, match="init_encdec"):
            make()
    with pytest.raises(ValueError, match="init_lm"):
        init_encdec(configs.get_smoke_config("gemma2-9b"),
                    generator=torch.Generator(), device="cpu")


def test_encode_and_encdec_apply_match_the_reference():
    cfg, params, tcfg, model = _ref()
    frames, toks = _inputs(cfg)
    want = ref_encdec.encode(params, jnp.asarray(frames), cfg)
    got = encode(model, T(frames), tcfg)
    assert got.shape == (B, TE, cfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    want, want_aux = ref_encdec.encdec_apply(params, jnp.asarray(frames),
                                             jnp.asarray(toks), cfg)
    got, aux = model(T(frames), T(toks))
    assert got.dtype == torch.float32 and got.shape == (B, S,
                                                        cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert aux.dtype == torch.float32 and float(aux) == float(want_aux) == 0


def test_prefill_step_matches_the_reference():
    cfg, params, tcfg, model = _ref()
    frames, toks = _inputs(cfg, seed=1)
    want = ref_steps.make_prefill_step(cfg)(
        params, {"frames": jnp.asarray(frames), "tokens": jnp.asarray(toks)})
    got = make_prefill_step(tcfg)(model, {"frames": T(frames),
                                          "tokens": T(toks)})
    assert got.shape == (B, cfg.vocab_size) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _caches(cfg, params, tcfg, model, frames, max_len):
    """Both packages' caches with the cross K/V of `frames` (float32)."""
    ref_cache = ref_encdec.init_encdec_cache(cfg, B, max_len,
                                             dtype=jnp.float32)
    ref_cache["cross_kv"] = ref_encdec.precompute_cross_kv(
        params, ref_encdec.encode(params, jnp.asarray(frames), cfg), cfg,
        dtype=jnp.float32)
    cache = init_encdec_cache(tcfg, B, max_len, dtype=torch.float32,
                              device="cpu")
    cache["cross_kv"] = precompute_cross_kv(
        model, encode(model, T(frames), tcfg), tcfg, dtype=torch.float32)
    return ref_cache, cache


def test_cache_and_decode_steps_match_the_reference():
    cfg, params, tcfg, model = _ref()
    frames, toks = _inputs(cfg, seed=2)
    empty = init_encdec_cache(tcfg, B, S, device="cpu")
    ref_empty = jax.eval_shape(lambda: ref_encdec.init_encdec_cache(cfg, B,
                                                                    S))
    for part in ("self", "cross_kv"):
        assert len(empty[part]) == len(ref_empty[part]) == cfg.n_layers
        for c, w in zip(empty[part], ref_empty[part]):
            assert {k: (tuple(v.shape), v.dtype) for k, v in c.items()} == {
                k: (tuple(v.shape), torch.bfloat16) for k, v in w.items()}
    ref_cache, cache = _caches(cfg, params, tcfg, model, frames, S)
    for got, want in zip(cache["cross_kv"], ref_cache["cross_kv"]):
        for k in ("k", "v"):
            assert got[k].shape == (B, TE, cfg.n_kv_heads, cfg.head_dim_)
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       **TOL)
    step = jax.jit(ref_encdec.encdec_decode_step, static_argnums=4)
    for i in range(S):
        want, ref_cache = step(params, ref_cache,
                               jnp.asarray(toks[:, i:i + 1]), jnp.int32(i),
                               cfg)
        got, out = encdec_decode_step(model, cache, T(toks[:, i:i + 1]), i,
                                      tcfg)
        assert out is cache and got.shape == (B, 1, cfg.vocab_size)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for got, want in zip(cache["self"], ref_cache["self"]):
        for k in ("k", "v"):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       **TOL)


def test_serve_step_tokens_match_the_reference():
    """Greedy serving: a prompt fed one token at a time, then the
    generated tokens fed back, against the frames' fixed cross K/V."""
    cfg, params, tcfg, model = _ref()
    frames, prompt = _inputs(cfg, seed=3, n=4)
    n_gen, max_len = 8, 16
    ref_cache, cache = _caches(cfg, params, tcfg, model, frames, max_len)
    serve = jax.jit(ref_steps.make_serve_step(cfg))
    step = make_serve_step(tcfg)
    want_tok = got_tok = None
    for i in range(prompt.shape[1] + n_gen - 1):
        if i < prompt.shape[1]:
            want_tok = jnp.asarray(prompt[:, i:i + 1])
            got_tok = T(prompt[:, i:i + 1])
        want_tok, ref_cache = serve(params, ref_cache, want_tok, jnp.int32(i))
        got_tok, cache = step(model, cache, got_tok, i)
        assert got_tok.dtype == torch.int32 and got_tok.shape == (B, 1)
        np.testing.assert_array_equal(got_tok.numpy(), np.asarray(want_tok))


def test_decode_matches_parallel_apply_in_the_port():
    """The reference's `test_encdec_decode_matches_parallel_apply` on the
    port: its token-by-token decode reproduces its parallel logits."""
    _, _, tcfg, model = _ref()
    frames, toks = _inputs(tcfg, seed=4)
    want, _ = encdec_apply(model, T(frames), T(toks), tcfg)
    cache = init_encdec_cache(tcfg, B, S, dtype=torch.float32, device="cpu")
    cache["cross_kv"] = precompute_cross_kv(
        model, encode(model, T(frames), tcfg), tcfg, dtype=torch.float32)
    for i in range(S):
        got, cache = encdec_decode_step(model, cache, T(toks[:, i:i + 1]), i,
                                        tcfg)
        np.testing.assert_allclose(got[:, 0].numpy(), want[:, i].numpy(),
                                   rtol=2e-3, atol=2e-3)


def _labels(cfg, seed, n=8):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, n + 1)).astype(np.int32)
    frames = rng.normal(size=(B, n, cfg.d_model)).astype(np.float32)
    return frames, toks[:, :-1], toks[:, 1:]


@pytest.mark.parametrize("chunk", [0, 4])
def test_encdec_loss_matches_the_reference(chunk):
    cfg, params, tcfg, model = _ref()
    cfg = dataclasses.replace(cfg, loss_chunk=chunk)
    tcfg = dataclasses.replace(tcfg, loss_chunk=chunk)
    frames, toks, labels = _labels(cfg, seed=5)
    want = ref_encdec.encdec_loss(params, *map(jnp.asarray,
                                               (frames, toks, labels)), cfg)
    with torch.no_grad():
        got = encdec_loss(model, *map(T, (frames, toks, labels)), tcfg)
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), float(want), **TOL)


def _grads(model, batch, cfg):
    model.requires_grad_(True)
    loss = encdec_loss(model, *map(T, batch), cfg)
    loss.backward()
    return loss.detach(), {k: p.grad for k, p in model.named_parameters()}


@pytest.mark.parametrize("chunk", [0, 4])
def test_gradients_match_the_reference(chunk):
    cfg, params, tcfg, _ = _ref()
    cfg = dataclasses.replace(cfg, loss_chunk=chunk)
    tcfg = dataclasses.replace(tcfg, loss_chunk=chunk)
    batch = _labels(cfg, seed=6)
    want_loss, want = jax.value_and_grad(
        lambda p: ref_encdec.encdec_loss(p, *map(jnp.asarray, batch),
                                         cfg))(params)
    want = jax.tree.map(np.asarray, want)
    model = encdec_params_from_reference(
        tcfg, jax.tree.map(np.asarray, params), "cpu")
    loss, got = _grads(model, batch, tcfg)
    np.testing.assert_allclose(float(loss), float(want_loss), **TOL)
    assert len(got) == len(jax.tree.leaves(want))
    for k, g in got.items():
        w = _leaf(want, k)
        assert g is not None and float(g.abs().max()) > 0, k
        scale = float(np.abs(w).max())
        err = float(np.abs(g.numpy() - w).max())
        assert err <= GRAD_TOL * scale, f"{k}: {err} over {GRAD_TOL} x {scale}"


def test_remat_gives_equal_losses_and_gradients(monkeypatch):
    """Remat on and off: equal losses and gradients. With it on,
    `encdec_loss` checkpoints every encoder and decoder layer, and
    `encdec_apply` under autograd only the encoder's, as the reference's
    `_maybe_remat` wraps them."""
    cfg, params, tcfg, _ = _ref()
    tree = jax.tree.map(np.asarray, params)
    batch = _labels(cfg, seed=7)
    calls = []
    real = encdec.checkpoint

    def counted(fn, *args, **kw):
        calls.append(fn.__name__)
        return real(fn, *args, **kw)
    monkeypatch.setattr(encdec, "checkpoint", counted)
    out = []
    for remat in (False, True):
        c = dataclasses.replace(tcfg, remat=remat)
        out.append(_grads(encdec_params_from_reference(c, tree, "cpu"),
                          batch, c))
    assert calls == ["_enc_layer"] * cfg.n_enc_layers + \
        ["_dec_layer"] * cfg.n_layers
    (l0, g0), (l1, g1) = out
    assert torch.equal(l0, l1)
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k
    calls.clear()
    c = dataclasses.replace(tcfg, remat=True)
    model = encdec_params_from_reference(c, tree, "cpu").requires_grad_(True)
    encdec_apply(model, T(batch[0]), T(batch[1]), c)[0].sum().backward()
    assert calls == ["_enc_layer"] * cfg.n_enc_layers
    calls.clear()
    with torch.no_grad():
        encdec_loss(model, *map(T, batch), c)
    assert calls == []


# ---------------------------------------------------------------------------
# The cross and bidirectional attentions, on both branches
# ---------------------------------------------------------------------------

def _attn_params(rng, d_model, H, Hkv, hd):
    return {n: {"w": (rng.normal(size=(di, do)) * di ** -0.5).astype(
        np.float32)} for n, di, do in (("wq", d_model, H * hd),
                                       ("wk", d_model, Hkv * hd),
                                       ("wv", d_model, Hkv * hd),
                                       ("wo", H * hd, d_model))}


@pytest.fixture
def flash_calls(monkeypatch):
    """Counts each package's `flash_attention` calls."""
    calls = {"ref": 0, "port": 0}

    def spy(mod, key):
        real = mod.flash_attention

        def fn(*a, **kw):
            calls[key] += 1
            return real(*a, **kw)
        monkeypatch.setattr(mod, "flash_attention", fn)
    spy(ref_flash, "ref")
    spy(flash, "port")
    return calls


@pytest.mark.parametrize("kind,Sq,Tk,blocked", [
    ("cross", 2048, 2048, True), ("cross", 2048, 1024, True),
    ("cross", 2048, 1500, False), ("bidir", 2048, 2048, True),
    ("bidir", 1500, 1500, False)])
def test_encoder_attentions_match_the_reference(flash_calls, kind, Sq, Tk,
                                                blocked):
    """B 1, H 2, head_dim 16: at S = 2,048 (and T a multiple of 1,024)
    both packages take the blocked attention, else the plain one."""
    rng = np.random.default_rng(Sq + Tk)
    d_model, H, hd = 16, 2, 16
    p = _attn_params(rng, d_model, H, H, hd)
    x = rng.normal(size=(1, Sq, d_model)).astype(np.float32)
    kw = dict(n_heads=H, n_kv_heads=H, head_dim=hd)
    rp, tp = jax.tree.map(jnp.asarray, p), Params(jax.tree.map(T, p))
    if kind == "cross":
        ctx = rng.normal(size=(1, Tk, d_model)).astype(np.float32)
        want = ref_attention.cross_attention_train(rp, jnp.asarray(x),
                                                   jnp.asarray(ctx), **kw)
        got = attention.cross_attention_train(tp, T(x), T(ctx), **kw)
    else:
        want = ref_attention.bidir_attention_train(rp, jnp.asarray(x), **kw)
        got = attention.bidir_attention_train(tp, T(x), **kw)
    assert flash_calls == {"ref": int(blocked), "port": int(blocked)}
    assert got.shape == (1, Sq, d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
