"""The port's training path against the JAX package's, on the CPU in
float32, through weights carried across with `params_from_reference`, for
the nine smoke configs without an encoder-decoder:

- `lm_loss` against the reference's, unchunked and with ``loss_chunk`` 4
  at S = 8 (two chunks): 2e-5, as the serving tests (the same arithmetic
  in another order);
- every parameter's gradient against ``jax.value_and_grad`` of the
  reference's `lm_loss`: within GRAD_TOL of the leaf's largest |g| (the
  backward sums in another order than XLA's; float32 reaches 1e-6 of it);
- three `make_train_step` steps against the reference's jitted step with
  AdamW and Adafactor, 1 and 2 micro-batches (whisper-base among them,
  its batch holding ``frames``; its own loss and gradients are in
  tests/test_torch_encdec.py): losses within 2e-5,
  parameters within STEP_TOL x lr of the reference's (2.4e-4 lr, two
  float32 ulps of an O(1) weight, measured at most). AdamW runs there
  with eps 1e-3: at its default 1e-8 a first step moves a parameter by
  about +-lr whatever |g| is (m / sqrt(v) is about +-1), so where a
  gradient is as small as its rounding noise, the sign of its last bits
  decides the move (0.64 lr measured on one element of jamba's in_proj).
  With eps 1e-3 the update is smooth in g there. The default eps is held
  to the reference step for step on equal gradients in
  tests/test_torch_optim.py;
- remat on and off: equal losses and gradients;
- the selective scan's GPU branch (`SelectiveScan`, its two launches
  replaced by the plain versions) in a falcon-mamba model: the same
  gradients as autograd through the plain scan, the Mamba mixer's
  parameters among them.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro import optim as ref_optim
from repro.launch import steps as ref_steps
from repro.models import encdec as ref_encdec
from repro.models import lm as ref_lm
from repro_torch import configs, optim
from repro_torch.kernels import common
from repro_torch.launch.steps import make_train_step
from repro_torch.models.encdec import encdec_params_from_reference
from repro_torch.models.lm import lm_loss, params_from_reference
from test_torch_kernels_selective_scan import fake_gated_scan_launches

torch.set_num_threads(1)
T = torch.from_numpy
TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = 2e-5          # of the leaf's largest |g|
STEP_TOL = 1e-3          # of lr
ADAMW_EPS = 1e-3         # AdamW's eps in the step test (see above)
ADAFACTOR_EPS = {"kimi-k2-1t-a32b": 1e-8,       # (see STEP_CASES)
                 "llama4-scout-17b-a16e": 1e-8}
ARCHS = ["falcon-mamba-7b", "internvl2-26b", "phi3-medium-14b",
         "deepseek-coder-33b", "gemma2-9b", "qwen2.5-14b", "kimi-k2-1t-a32b",
         "llama4-scout-17b-a16e", "jamba-1.5-large-398b"]
MAMBA_MIXER = ("conv_w", "conv_b", "x_proj.w", "dt_proj.w", "dt_proj.b",
               "a_log", "d_skip", "in_proj.w", "out_proj.w")
B, S = 2, 8


@functools.lru_cache(maxsize=None)
def _ref(name):
    """(reference cfg, its params as numpy, the port's cfg)."""
    cfg = ref_configs.get_smoke_config(name)
    init = ref_encdec.init_encdec if cfg.is_encoder_decoder else \
        ref_lm.init_lm
    params = init(jax.random.PRNGKey(0), cfg)
    return cfg, jax.tree.map(np.asarray, params), configs.get_smoke_config(name)


def _model(name, tcfg=None):
    cfg, tree, tc = _ref(name)
    load = encdec_params_from_reference if cfg.is_encoder_decoder else \
        params_from_reference
    return load(tcfg or tc, tree, "cpu")


def _batch(cfg, seed=0, n=B):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (n, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.frontend == "patch":
        batch["patch_embeds"] = rng.normal(
            size=(n, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)
    if cfg.is_encoder_decoder:            # train: enc_len = dec_len = S
        batch["frames"] = rng.normal(size=(n, S, cfg.d_model)).astype(
            np.float32)
    return batch


def _at(node, parts):
    """`node` under the dotted path `parts` (a list's entries by index)."""
    for k in parts:
        node = node[int(k)] if isinstance(node, (list, tuple)) else node[k]
    return node


def _ref_leaf(tree, name, cfg):
    """The reference's leaf for the port's parameter `name` (layer
    ``p * period + i`` is stacked period ``p``, block ``i``; an
    encoder-decoder's ``enc.i`` / ``dec.i`` are its lists' entries)."""
    parts = name.split(".")
    if parts[0] != "layers":
        return np.asarray(_at(tree, parts))
    layer = int(parts[1])
    node = _at(tree["layers"][layer % cfg.period], parts[2:])
    return np.asarray(node)[layer // cfg.period]


def _loss(loss_fn, params, batch, cfg, to):
    """`loss_fn`(params, tokens, labels, cfg, patch_embeds), the batch's
    arrays through `to`."""
    pe = batch.get("patch_embeds")
    return loss_fn(params, to(batch["tokens"]), to(batch["labels"]), cfg,
                   None if pe is None else to(pe))


@pytest.mark.parametrize("chunk", [0, 4])
@pytest.mark.parametrize("name", ARCHS)
def test_lm_loss_matches_the_reference(name, chunk):
    cfg, tree, tcfg = _ref(name)
    cfg = dataclasses.replace(cfg, loss_chunk=chunk)
    tcfg = dataclasses.replace(tcfg, loss_chunk=chunk)
    batch = _batch(cfg)
    params = jax.tree.map(jnp.asarray, tree)
    want = _loss(ref_lm.lm_loss, params, batch, cfg, jnp.asarray)
    with torch.no_grad():
        got = _loss(lm_loss, _model(name, tcfg), batch, tcfg, T)
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), float(want), **TOL)


def _grads(model, batch, cfg):
    model.requires_grad_(True)
    loss = _loss(lm_loss, model, batch, cfg, T)
    loss.backward()
    # a parameter the loss does not reach (ln2 of a block without an MLP)
    # has no .grad; the reference's gradient there is 0
    return loss.detach(), {
        k: p.grad if p.grad is not None else torch.zeros_like(p)
        for k, p in model.named_parameters()}


def _assert_grads_close(got, want, tol, what=""):
    for k, w in want.items():
        g = got[k]
        assert g is not None, f"{what}{k}: no gradient"
        scale = float(np.abs(w).max())
        err = float(np.abs(g.numpy() - w).max())
        assert err <= tol * max(scale, 1e-30), (
            f"{what}{k}: max abs err {err} over {tol} x {scale}")


@pytest.mark.parametrize("name", ARCHS)
def test_gradients_match_the_reference(name):
    cfg, tree, tcfg = _ref(name)
    batch = _batch(cfg, seed=1)
    params = jax.tree.map(jnp.asarray, tree)
    want_loss, want = jax.value_and_grad(
        lambda p: _loss(ref_lm.lm_loss, p, batch, cfg, jnp.asarray))(params)
    want = jax.tree.map(np.asarray, want)
    model = _model(name)
    loss, got = _grads(model, batch, tcfg)
    np.testing.assert_allclose(float(loss), float(want_loss), **TOL)
    _assert_grads_close(got, {k: _ref_leaf(want, k, cfg) for k in got},
                        GRAD_TOL)
    if any(spec.mixer == "mamba" for spec in cfg.blocks):
        mixer = [k for k in got if ".mamba." in k]
        for leaf in MAMBA_MIXER:
            hits = [k for k in mixer if k.endswith(".mamba." + leaf)]
            assert hits and all(float(got[k].abs().max()) > 0
                                for k in hits), leaf


# Adafactor on one period (gemma2, jamba) and on two (kimi-k2, llama4-scout:
# layers 0 and 1 are one stacked leaf of the reference, factored and
# clipped as one; their MoE experts add a leading axis). The two MoE models
# run Adafactor with eps ADAFACTOR_EPS: Adafactor's update does not scale
# with |g|, and llama4-scout's second router gets a noise-sized gradient
# (max |g| 1.3e-5, the two sides 1.6e-8 apart), which its default 1e-30
# turns into a 4.3e-3 lr difference; 1e-8 keeps such a leaf's move smooth
# in g (1.2e-4 lr measured at most), while leaves kept apart instead of
# stacked still differ by about 2 lr. The default eps is held to the
# reference step for step on equal gradients in tests/test_torch_optim.py
STEP_CASES = [("falcon-mamba-7b", "adamw"), ("qwen2.5-14b", "adamw"),
              ("jamba-1.5-large-398b", "adamw"), ("gemma2-9b", "adafactor"),
              ("jamba-1.5-large-398b", "adafactor"),
              ("kimi-k2-1t-a32b", "adafactor"),
              ("llama4-scout-17b-a16e", "adafactor"),
              ("whisper-base", "adamw"), ("whisper-base", "adafactor")]


@pytest.mark.parametrize("micro", [1, 2])
@pytest.mark.parametrize("name,kind", STEP_CASES)
def test_train_steps_match_the_reference(name, kind, micro):
    lr = 1e-3
    cfg, tree, tcfg = _ref(name)
    if kind == "adamw":
        kw = dict(eps=ADAMW_EPS)
    else:
        kw = dict(eps=ADAFACTOR_EPS[name]) if name in ADAFACTOR_EPS else {}
    ref_opt = ref_optim.get_optimizer(kind, lr=lr, **kw)
    params = jax.tree.map(jnp.asarray, tree)
    ref_state = ref_opt[0](params)
    ref_step = jax.jit(ref_steps.make_train_step(cfg, ref_opt, micro))
    model = _model(name)
    opt = optim.get_optimizer(kind, lr=lr, period=tcfg.period, **kw)
    state = opt[0](dict(model.named_parameters()))
    step_fn = make_train_step(tcfg, opt, micro_batches=micro)
    for step in range(3):
        batch = _batch(cfg, seed=10 + step)
        params, ref_state, want = ref_step(
            params, ref_state, jnp.int32(step),
            {k: jnp.asarray(v) for k, v in batch.items()})
        model, state, got = step_fn(model, state, step,
                                    {k: T(v) for k, v in batch.items()})
        assert got["loss"].dtype == torch.float32
        np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                                   **TOL)
    want = jax.tree.map(np.asarray, params)
    for k, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   _ref_leaf(want, k, cfg), rtol=0,
                                   atol=STEP_TOL * lr, err_msg=k)
    if kind == "adafactor":
        _assert_factors_equal(state["f"], ref_state["f"], cfg)


def _assert_factors_equal(got, want, cfg):
    """Adafactor's factors, keyed by the stack's first layer, against the
    reference's stacked leaves (every period's row), within 1e-5 of each
    factor's largest value."""
    assert len(got) == len(jax.tree.leaves(
        want, is_leaf=lambda n: isinstance(n, dict) and
        ({"v"} == set(n) or {"vr", "vc"} == set(n))))
    for k, s in got.items():
        parts = k.split(".")
        node = _at(want["layers"][int(parts[1])], parts[2:]) \
            if parts[0] == "layers" else _at(want, parts)
        assert set(s) == set(node), k
        for f, v in s.items():
            w = np.asarray(node[f])
            assert tuple(v.shape) == w.shape, (k, f)
            np.testing.assert_allclose(v.numpy(), w, rtol=0,
                                       atol=1e-5 * np.abs(w).max(),
                                       err_msg=f"{k} {f}")


@pytest.mark.parametrize("name", ["falcon-mamba-7b", "gemma2-9b",
                                  "jamba-1.5-large-398b"])
def test_remat_gives_equal_losses_and_gradients(name):
    cfg, tree, tcfg = _ref(name)
    batch = _batch(cfg, seed=3)
    out = []
    for remat in (False, True):
        c = dataclasses.replace(tcfg, remat=remat)
        out.append(_grads(params_from_reference(c, tree, "cpu"), batch, c))
    (l0, g0), (l1, g1) = out
    assert torch.equal(l0, l1)
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k


@pytest.fixture
def scan_gpu_branch(monkeypatch):
    """Call to take the gated selective scan's GPU branch on CPU tensors:
    both bare launches then write the plain versions' results."""
    def enable():
        fake_gated_scan_launches(monkeypatch)
        common.reset_kernel_launch_counts()

    yield enable
    common.reset_kernel_launch_counts()


@pytest.mark.parametrize("remat", [False, True])
def test_kernel_branch_gradients_equal_plain_autograd(scan_gpu_branch,
                                                      remat):
    """falcon-mamba through `SelectiveScanGated` against autograd through
    the plain chain: the same loss and gradients, every Mamba mixer parameter's
    non-zero; one forward launch a layer (two with remat) and one backward
    launch a layer."""
    cfg, tree, tcfg = _ref("falcon-mamba-7b")
    tcfg = dataclasses.replace(tcfg, remat=remat)
    batch = _batch(cfg, seed=4)
    want_loss, want = _grads(params_from_reference(tcfg, tree, "cpu"),
                             batch, tcfg)
    scan_gpu_branch()
    loss, got = _grads(params_from_reference(tcfg, tree, "cpu"), batch, tcfg)
    layers = tcfg.n_layers
    assert common.kernel_launch_counts() == {
        "selective_scan": layers * (2 if remat else 1),
        "selective_scan_bwd": layers}
    np.testing.assert_allclose(float(loss), float(want_loss), **TOL)
    _assert_grads_close(got, {k: v.numpy() for k, v in want.items()}, 1e-6)
    for k, g in got.items():
        if ".mamba." in k:
            assert float(g.abs().max()) > 0, k
