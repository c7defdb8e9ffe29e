"""Jamba's block in the port's language model (``cfg.jamba``), on the CPU
in float32, against the benchmark's plain reference
(``bench/reference/jamba_lm.py``: Jamba's equations in plain PyTorch,
written apart from the port) on the benchmark's seeded weights, at d 64,
one 14-layer period with attention at layer 7, 4 query heads of 16 over
one KV head, vocab 512. Beside it: the blocked attention's CPU loop with
G = 4 at S = 2,048, per-layer remat against none, one AdamW step, decoding
against the full forward, the block's spans and counts, and configs
without the block still computing as the JAX package does.

Tolerances. The loss: 2e-5 relative plus absolute, the same float32
arithmetic in another order (the conv as shifted sums, the attention in
blocks against one softmax), as `tests/test_torch_train.py` holds the port
to the JAX package. The logits: 2e-5 of the largest |logit| plus 2e-5
relative: 14 layers of random weights carry float32's rounding far (over
six seeds each side lies 1.1e-5 - 2.2e-5 from the same logits in float64,
the largest |logit| 3.9 - 5.1; the two 9.5e-6 - 1.6e-5 apart). Every
gradient within GRAD_TOL of its leaf's largest |g|: through the same 14
layers the two float32 computations' gradients part by up to 3.0e-5 of it
(the worst leaf over six seeds, 9.0e-6 - 3.0e-5; a Mamba projection, A's
log or a mixer norm's scale), where a missing norm or a wrong layer rule
moves them by whole units.
"""

import json
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import lm as ref_lm
from repro_torch import configs, tracing
from repro_torch.launch.steps import make_prefill_step, make_train_step
from repro_torch.models import lm
from repro_torch.models.config import JambaBlock
from repro_torch.models.lm import (LM, Block, init_lm, init_lm_cache,
                                   lm_apply, lm_decode_step, lm_loss,
                                   params_from_reference)
from repro_torch.nn import flash
from repro_torch.nn.layers import Params
from repro_torch.optim import get_optimizer

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from bench import jamba_inputs, jamba_yardstick  # noqa: E402
from bench.drivers.jamba_train import model_config  # noqa: E402
from bench.reference import jamba_lm  # noqa: E402

torch.set_num_threads(1)
TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = 2e-4          # of the leaf's largest |g| (see above)
SEED = 2**31 + 37
CFG = dict(json.loads((ROOT / "bench/configs/ai21-jamba2-3b-train.json")
                      .read_text()),
           hidden_size=64, intermediate_size=128, mamba_d_state=4,
           mamba_dt_rank=4, vocab_size=512, num_hidden_layers=14,
           num_attention_heads=4)
JOB = dict(CFG["job"], dtype="float32", loss_chunk=0)
# one Mamba and one attention layer, for the long sequence
CFG2 = dict(CFG, num_hidden_layers=2, attn_layer_period=2,
            attn_layer_offset=1)
B, S = 2, 24


def _port(cfg=CFG, job=JOB, seed=SEED):
    """The port's model with the benchmark's weights, float32."""
    mcfg = model_config(dict(cfg, job=job))
    outer = jamba_inputs.outer_weights(seed, cfg, torch.float32, "cpu")
    layers = [Block(mcfg.blocks[i % mcfg.period], jamba_inputs.layer_weights(
        seed, cfg, i, torch.float32, "cpu")) for i in range(mcfg.n_layers)]
    return mcfg, LM(mcfg, Params(outer["embed"]), layers,
                    Params(outer["ln_f"]), None)


def _reference(cfg=CFG, seed=SEED):
    flat = jamba_lm.initial_weights(seed, cfg, torch.float32, "cpu")
    for v in flat.values():
        v.requires_grad_(True)
    return jamba_lm.Model(cfg), flat


def _tokens(seed, b=B, s=S):
    g = torch.Generator().manual_seed(seed)
    toks = torch.randint(0, 512, (b, s + 1), generator=g, dtype=torch.int32)
    return toks[:, :-1], toks[:, 1:]


def _logits_close(got, want):
    torch.testing.assert_close(got, want, rtol=2e-5,
                               atol=2e-5 * float(want.abs().max()))


def _grads_close(model, flat):
    got = {k: p.grad for k, p in model.named_parameters()}
    assert set(got) == set(flat)
    for k, g in got.items():
        w = flat[k].grad
        assert g is not None and float(g.abs().max()) > 0, k
        scale = float(w.abs().max())
        err = float((g - w).abs().max())
        assert err <= GRAD_TOL * scale, f"{k}: {err} over {GRAD_TOL} x {scale}"


def test_logits_match_the_reference():
    mcfg, model = _port()
    toks, _ = _tokens(1)
    ref, flat = _reference()
    with torch.no_grad():
        got, aux = lm_apply(model, toks, mcfg)
        want = ref.logits(jamba_lm.nest(flat), toks)
    assert got.shape == (B, S, 512) and float(aux) == 0
    _logits_close(got, want)


@pytest.mark.parametrize("remat", [True, False])
def test_loss_and_every_gradient_match_the_reference(remat):
    mcfg, model = _port(job=dict(JOB, remat=remat))
    toks, labels = _tokens(2)
    model.requires_grad_(True)
    loss = lm_loss(model, toks, labels, mcfg)
    loss.backward()
    ref, flat = _reference()
    want = ref.loss(jamba_lm.nest(flat), toks, labels)
    want.backward()
    torch.testing.assert_close(loss, want, **TOL)
    # 1 attention layer of 9 leaves, 13 Mamba layers of 17, the embedding
    # and the final norm
    assert len(flat) == 9 + 13 * 17 + 2
    _grads_close(model, flat)


def test_long_sequence_through_the_blocked_loop_with_groups(monkeypatch):
    """At S = 2,048 the attention takes the CPU's blocked loop (the
    reference's rule), its G = 4 query heads over one KV head, once a
    forward; loss and gradients as the reference's."""
    calls = []
    real = flash.flash_attention

    def spy(q, k, v, **kw):
        calls.append((tuple(q.shape), tuple(k.shape), kw["causal"]))
        return real(q, k, v, **kw)
    monkeypatch.setattr(flash, "flash_attention", spy)
    job = dict(JOB, loss_chunk=1024)
    mcfg, model = _port(CFG2, job)
    toks, labels = _tokens(3, b=1, s=2048)
    model.requires_grad_(True)
    loss = lm_loss(model, toks, labels, mcfg)
    loss.backward()
    assert calls == [((1, 2048, 4, 16), (1, 2048, 1, 16), True)] * 2
    ref, flat = _reference(CFG2)
    want = ref.loss(jamba_lm.nest(flat), toks, labels)
    want.backward()
    torch.testing.assert_close(loss, want, **TOL)
    _grads_close(model, flat)


def test_remat_per_layer_gives_equal_losses_and_gradients():
    """Each layer under its own checkpoint against no remat: the same
    numbers bit for bit."""
    toks, labels = _tokens(4)
    out = []
    for remat in (False, True):
        mcfg, model = _port(job=dict(JOB, remat=remat))
        model.requires_grad_(True)
        loss = lm_loss(model, toks, labels, mcfg)
        loss.backward()
        out.append((loss, {k: p.grad for k, p in model.named_parameters()}))
    (l0, g0), (l1, g1) = out
    assert torch.equal(l0, l1)
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k


def test_one_adamw_step_matches_the_reference():
    """`make_train_step`'s AdamW step against the reference's gradient
    and the same update written out (eps 1e-3, as the JAX package's step
    tests use: at 1e-8 a noise-sized gradient's last bits flip a whole lr
    move). Each master within lr x (its gradient's tolerance / eps), the
    most a gradient's error can move the update (d/dg of g / (|g| + eps)
    is at most 1 / eps), plus two float32 ulps of the weight."""
    o = dict(JOB["optimizer"], eps=1e-3)
    mcfg, model = _port()
    opt = get_optimizer("adamw", lr=o["lr"], b1=o["b1"], b2=o["b2"],
                        eps=o["eps"], weight_decay=o["weight_decay"])
    state = opt[0](dict(model.named_parameters()))
    toks, labels = _tokens(5)
    model, state, out = make_train_step(mcfg, opt)(
        model, state, 0, {"tokens": toks, "labels": labels})
    ref, flat = _reference()
    want = ref.loss(jamba_lm.nest(flat), toks, labels)
    want.backward()
    torch.testing.assert_close(out["loss"], want.detach(), **TOL)
    got = dict(model.named_parameters())
    with torch.no_grad():
        for k, v in flat.items():
            g = v.grad      # step 1: m_hat = g, sqrt(v_hat) = |g|
            upd = v - o["lr"] * (g / (g.abs() + o["eps"])
                                 + o["weight_decay"] * v)
            atol = o["lr"] * GRAD_TOL * float(g.abs().max()) / o["eps"]
            assert bool(((got[k] - upd).abs()
                         <= atol + 2.4e-7 * upd.abs()).all()), k


def test_decoding_matches_the_full_forward():
    """Jamba's block through the caches (the Mamba layers' conv and SSM
    states with the mixer norms, the attention layer's KV cache without
    RoPE): each step's logits equal the full forward's at its position."""
    mcfg, model = _port()
    toks, _ = _tokens(6, b=1, s=10)
    with torch.no_grad():
        full, _ = lm_apply(model, toks, mcfg)
        cache = init_lm_cache(mcfg, 1, 16, dtype=torch.float32, device="cpu")
        for t in range(10):
            got, cache = lm_decode_step(model, cache, toks[:, t:t + 1], t,
                                        mcfg)
            _logits_close(got[:, 0], full[:, t])
        last = make_prefill_step(mcfg)(model, {"tokens": toks})
    _logits_close(last, full[:, -1])


def test_init_lm_draws_the_benchmarks_tree():
    """`init_lm` with Jamba's block: the benchmark's leaves under the same
    names and shapes; no head (tied); the published model about 3.03
    billion parameters."""
    cfg = configs.get_smoke_config("ai21-jamba2-3b")
    assert isinstance(cfg.jamba, JambaBlock)
    model = init_lm(cfg, generator=torch.Generator().manual_seed(0),
                    device="cpu")
    want = jamba_inputs.all_weights(0, CFG, torch.float32, "cpu")
    got = dict(model.named_parameters())
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    assert model.head is None
    n = sum(p.numel() for p in got.values())
    assert n == jamba_yardstick.weights(CFG)
    published = configs.get_config("ai21-jamba2-3b")
    assert 3.02e9 < published.param_count() < 3.04e9


def test_the_block_and_its_head_must_agree():
    mcfg, model = _port()
    with pytest.raises(ValueError, match="tie"):
        LM(mcfg, model.embed, list(model.layers), model.ln_f,
           Params(w=torch.zeros((64, 512))))
    plain = configs.get_smoke_config("jamba-1.5-large-398b")
    with pytest.raises(ValueError, match="tie"):
        LM(plain, model.embed, list(model.layers)[:8], model.ln_f, None)
    with pytest.raises(ValueError, match="no Jamba block"):
        params_from_reference(mcfg, {}, "cpu")


@pytest.mark.parametrize("remat", [False, True])
def test_spans_and_counts_of_a_train_step(remat):
    """Over a train step: one ``lm.attention`` span an attention layer's
    forward (two with remat: the recompute), one ``mamba.mixer_norms`` a
    Mamba layer's forward (two with remat); on the CPU no stream is timed
    and no attention counts as plain."""
    mcfg, model = _port(job=dict(JOB, remat=remat))
    opt = get_optimizer("adamw")
    state = opt[0](dict(model.named_parameters()))
    toks, labels = _tokens(7)
    tracing.clear()
    with tracing.recording():
        make_train_step(mcfg, opt)(model, state, 0,
                                   {"tokens": toks, "labels": labels})
    recs = tracing.records()
    tracing.clear()
    times = 2 if remat else 1
    attn = [r for r in recs if r.name == "lm.attention"]
    assert len(attn) == 1 * times
    assert all(r.device_ms is None for r in attn)
    counts = {}
    for r in recs:
        for name, n in r.counts.items():
            counts[name] = counts.get(name, 0) + n
    assert counts.get("mamba.mixer_norms") == 13 * times
    assert "attn.plain_calls" not in counts


@pytest.mark.parametrize("name", ["jamba-1.5-large-398b", "falcon-mamba-7b",
                                  "gemma2-9b"])
def test_configs_without_the_block_compute_as_before(name):
    """``cfg.jamba`` None: RoPE on, no mixer norms, an untied head, and
    the loss of the JAX package's own weights equal to its `lm_loss`;
    no ``mamba.mixer_norms`` counted."""
    cfg = ref_configs.get_smoke_config(name)
    tcfg = configs.get_smoke_config(name)
    assert tcfg.jamba is None
    assert all(lm._mixer_kw(tcfg, s).get("use_rope", True)
               for s in tcfg.blocks)
    params = ref_lm.init_lm(jax.random.PRNGKey(5), cfg)
    model = params_from_reference(tcfg, jax.tree.map(np.asarray, params),
                                  "cpu")
    assert model.head is not None
    assert not any("_norm." in k for k, _ in model.named_parameters())
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, (B, 17)).astype(np.int32)
    want = ref_lm.lm_loss(params, jnp.asarray(toks[:, :-1]),
                          jnp.asarray(toks[:, 1:]), cfg)
    tracing.clear()
    with tracing.recording(), torch.no_grad():
        got = lm_loss(model, torch.from_numpy(toks[:, :-1]),
                      torch.from_numpy(toks[:, 1:]), tcfg)
    recs = tracing.records()
    tracing.clear()
    np.testing.assert_allclose(float(got), float(want), rtol=2e-5,
                               atol=2e-5)
    assert not any("mamba.mixer_norms" in r.counts for r in recs)
