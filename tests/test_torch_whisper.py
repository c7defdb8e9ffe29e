"""whisper's own block in the port's encoder-decoder (``cfg.whisper``), on
the CPU in float32, against the benchmark's plain reference
(``bench/reference/whisper_lm.py``: whisper's equations in plain PyTorch,
written apart from the port) on the benchmark's seeded weights, at d 64,
2 + 2 layers, 4 heads of 16, 48 mel frames (24 encoder positions) and 12
tokens: lengths that no block divides. Beside it: the default block is
still the JAX package's, the blocked attention's routing keeps the
reference's rule and refusals on the CPU and takes any lengths on the
card's branch, decoding with whisper's block is refused, and its spans.

Tolerances. Loss and logits: 2e-5 relative plus absolute, the same float32
arithmetic in another order (the convolutions as one `F.conv1d` against
three shifted products; the attention as one softmax against blocks), as
`tests/test_torch_encdec.py` holds the port to the JAX package. Every
gradient: within GRAD_TOL of its leaf's largest |g|, as there.
"""

import dataclasses
import pathlib
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import encdec as ref_encdec
from repro.nn import flash as ref_flash
from repro_torch import configs, tracing
from repro_torch.kernels import common
from repro_torch.kernels.flash_attn import ops as flash_ops
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models.encdec import (EncDec, encdec_apply, encdec_loss,
                                       encdec_params_from_reference,
                                       init_encdec, init_encdec_cache,
                                       precompute_cross_kv)
from repro_torch.nn import attention, flash
from repro_torch.nn.layers import Params

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
from bench import whisper_inputs  # noqa: E402
from bench.drivers.whisper_train import model_config  # noqa: E402
from bench.reference import whisper_lm  # noqa: E402
from test_torch_flash_attn import fake_flash_launches  # noqa: E402

torch.set_num_threads(1)
TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = 2e-5          # of the leaf's largest |g|
SEED = 2**31 + 77
CFG = dict(name="whisper-small-test", d_model=64, encoder_layers=2,
           decoder_layers=2, encoder_attention_heads=4,
           decoder_attention_heads=4, encoder_ffn_dim=256,
           decoder_ffn_dim=256, vocab_size=512, num_mel_bins=8,
           max_source_positions=24, max_target_positions=16,
           activation_function="gelu")
JOB = dict(dtype="float32", loss_chunk=0, remat=True)
B, FRAMES, S = 2, 48, 12


def _port(remat=True):
    """The port's model with the benchmark's weights, float32."""
    mcfg = model_config(CFG, dict(JOB, remat=remat))
    w = whisper_inputs.outer_weights(SEED, CFG, torch.float32, "cpu")
    layers = {stack: [Params(whisper_inputs.layer_weights(
        SEED, CFG, stack, i, torch.float32, "cpu")) for i in range(2)]
        for stack in ("enc", "dec")}
    model = EncDec(mcfg, Params(w["embed"]), layers["enc"], layers["dec"],
                   Params(w["ln_enc"]), Params(w["ln_f"]), None,
                   Params(w["frontend"]))
    return mcfg, model


def _batch(seed=0):
    g = torch.Generator().manual_seed(seed)
    mel = torch.randn((B, 8, FRAMES), generator=g)
    toks = torch.randint(0, 512, (B, S + 1), generator=g, dtype=torch.int32)
    return mel, toks[:, :-1], toks[:, 1:]


def _reference():
    ref = whisper_lm.Model(CFG)
    flat = whisper_lm.initial_weights(SEED, CFG, torch.float32, "cpu")
    for v in flat.values():
        v.requires_grad_(True)
    return ref, flat


def test_logits_match_the_reference():
    mcfg, model = _port()
    mel, toks, _ = _batch(1)
    ref, flat = _reference()
    with torch.no_grad():
        got, aux = encdec_apply(model, mel, toks, mcfg)
        want = ref.logits(whisper_lm.nest(flat), mel, toks)
    assert got.shape == (B, S, 512) and float(aux) == 0
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.parametrize("remat", [True, False])
def test_loss_and_every_gradient_match_the_reference(remat):
    mcfg, model = _port(remat)
    mel, toks, labels = _batch(2)
    model.requires_grad_(True)
    loss = encdec_loss(model, mel, toks, labels, mcfg)
    loss.backward()
    got = {k: p.grad for k, p in model.named_parameters()}
    ref, flat = _reference()
    want_loss = ref.loss(whisper_lm.nest(flat), mel, toks, labels)
    want_loss.backward()
    torch.testing.assert_close(loss, want_loss, **TOL)
    assert set(got) == set(flat) and len(got) == 2 * 15 + 2 * 24 + 10
    for k, g in got.items():
        w = flat[k].grad
        assert g is not None and float(g.abs().max()) > 0, k
        scale = float(w.abs().max())
        err = float((g - w).abs().max())
        assert err <= GRAD_TOL * scale, f"{k}: {err} over {GRAD_TOL} x {scale}"


def test_init_encdec_draws_whispers_tree():
    """`init_encdec` with whisper's block: the benchmark's tree of leaves,
    under the same names and shapes; no head (tied); the sinusoids a
    buffer, not a parameter."""
    cfg = configs.get_smoke_config("whisper-large-v3")
    model = init_encdec(cfg, generator=torch.Generator().manual_seed(0),
                        device="cpu")
    want = whisper_inputs.all_weights(0, dict(
        CFG, num_mel_bins=cfg.whisper.n_mels,
        max_source_positions=cfg.enc_context), torch.float32, "cpu")
    got = dict(model.named_parameters())
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    assert model.head is None and "enc_pos" not in got
    assert cfg.param_count() == sum(p.numel() for p in got.values())
    assert model.enc_pos.shape == (cfg.enc_context, cfg.d_model)
    torch.testing.assert_close(model.enc_pos,
                               whisper_lm.sinusoids(24, 64, "cpu"))


def test_prefill_is_the_last_positions_logits():
    mcfg, model = _port()
    mel, toks, _ = _batch(3)
    with torch.no_grad():
        full, _ = encdec_apply(model, mel, toks, mcfg)
    got = make_prefill_step(mcfg)(model, {"frames": mel, "tokens": toks})
    torch.testing.assert_close(got, full[:, -1], **TOL)


def test_decoding_whispers_block_is_refused():
    mcfg, model = _port()
    with pytest.raises(NotImplementedError, match="whisper's own block"):
        init_encdec_cache(mcfg, B, 16, device="cpu")
    with pytest.raises(NotImplementedError, match="whisper's own block"):
        precompute_cross_kv(model, torch.zeros((B, 24, 64)), mcfg)
    serve = make_serve_step(mcfg)
    with pytest.raises(NotImplementedError, match="whisper's own block"):
        serve(model, {}, torch.zeros((B, 1), dtype=torch.int32), 0)


def test_lengths_over_the_positions_are_refused():
    mcfg, model = _port()
    mel, toks, _ = _batch(4)
    with pytest.raises(ValueError, match="positions"):
        encdec_apply(model, torch.cat([mel, mel], 2), toks, mcfg)
    with pytest.raises(ValueError, match="positions"):
        encdec_apply(model, mel, torch.cat([toks, toks], 1), mcfg)


def test_a_block_and_its_leaves_must_agree():
    mcfg, model = _port()
    with pytest.raises(ValueError, match="front end"):
        EncDec(mcfg, model.embed, list(model.enc), list(model.dec),
               model.ln_enc, model.ln_f, Params(w=torch.zeros((64, 512))),
               model.frontend)
    with pytest.raises(ValueError, match="front end"):
        EncDec(dataclasses.replace(mcfg, whisper=None), model.embed,
               list(model.enc), list(model.dec), model.ln_enc, model.ln_f,
               None, model.frontend)


def test_spans_of_the_encoder_and_the_decoder():
    mcfg, model = _port()
    mel, toks, labels = _batch(5)
    tracing.clear()
    with tracing.recording(), torch.no_grad():
        encdec_loss(model, mel, toks, labels, mcfg)
    recs = {r.name: r for r in tracing.records()}
    tracing.clear()
    assert {"encdec.encode", "encdec.frontend", "encdec.decode"} <= set(recs)
    assert recs["encdec.frontend"].parent == recs["encdec.encode"].id
    assert recs["encdec.decode"].parent is None
    assert recs["encdec.encode"].end_ns <= recs["encdec.decode"].start_ns
    # on the CPU no stream is timed, and no attention counts as plain
    assert recs["encdec.encode"].device_ms is None
    assert not any("attn.plain_calls" in r.counts for r in recs.values())


def test_default_block_is_still_the_reference_backbone():
    """``cfg.whisper`` None: the port's encoder-decoder is the JAX
    package's whisper-shaped backbone, its loss equal to the reference's
    on the reference's own weights."""
    cfg = ref_configs.get_smoke_config("whisper-base")
    tcfg = configs.get_smoke_config("whisper-base")
    assert tcfg.whisper is None
    params = ref_encdec.init_encdec(jax.random.PRNGKey(3), cfg)
    model = encdec_params_from_reference(
        tcfg, jax.tree.map(np.asarray, params), "cpu")
    assert model.frontend is None and model.head is not None
    rng = np.random.default_rng(3)
    frames = rng.normal(size=(B, 16, cfg.d_model)).astype(np.float32)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    want = ref_encdec.encdec_loss(params, jnp.asarray(frames),
                                  jnp.asarray(toks[:, :-1]),
                                  jnp.asarray(toks[:, 1:]), cfg)
    with torch.no_grad():
        got = encdec_loss(model, torch.from_numpy(frames),
                          torch.from_numpy(toks[:, :-1]),
                          torch.from_numpy(toks[:, 1:]), tcfg)
    np.testing.assert_allclose(float(got), float(want), **TOL)


# ---------------------------------------------------------------------------
# the blocked attention's routing
# ---------------------------------------------------------------------------

def _stand_in(S, dh=64, dtype=torch.bfloat16, cuda=True):
    """What `_blocked` reads of a tensor: device, shape, type."""
    return types.SimpleNamespace(is_cuda=cuda, shape=(1, S, 4, dh),
                                 dtype=dtype)


@pytest.mark.parametrize("S,T,dh,dtype,cuda,blocked", [
    (1500, 1500, 64, torch.bfloat16, True, True),     # whisper's encoder
    (448, 448, 64, torch.bfloat16, True, True),       # its decoder
    (448, 1500, 64, torch.bfloat16, True, True),      # its cross attention
    (1, 63, 64, torch.float32, True, True),
    (1500, 1500, 16, torch.float32, True, False),     # a head the kernel
    (2048, 2048, 16, torch.float32, True, True),      # lacks: the reference's
    (1500, 1500, 64, torch.bfloat16, False, False),   # the CPU: the
    (2048, 1500, 64, torch.float32, False, False),    # reference's rule
    (2048, 2048, 64, torch.float32, False, True),
    (3072, 1024, 64, torch.float32, False, True),
])
def test_blocked_routing(S, T, dh, dtype, cuda, blocked):
    assert attention._blocked(_stand_in(S, dh, dtype, cuda),
                              _stand_in(T, dh, dtype, cuda)) is blocked


@pytest.mark.parametrize("Sq,Skv", [(1500, 1500), (448, 1500), (2048, 1500)])
def test_cpu_keeps_the_references_refusal(Sq, Skv):
    """On the CPU the plain loop refuses lengths that are not multiples of
    its blocks, as the reference's blocked attention does."""
    rng = np.random.default_rng(Sq)
    q = rng.normal(size=(1, Sq, 2, 16)).astype(np.float32)
    kv = rng.normal(size=(1, Skv, 2, 16)).astype(np.float32)
    with pytest.raises((AssertionError, ValueError)):
        ref_flash.flash_attention(jnp.asarray(q), jnp.asarray(kv),
                                  jnp.asarray(kv), causal=False)
    with pytest.raises(ValueError, match="multiples of the blocks"):
        flash.flash_attention(torch.from_numpy(q), torch.from_numpy(kv),
                              torch.from_numpy(kv), causal=False)


@pytest.mark.parametrize("Sq,Skv,causal", [(24, 24, False), (12, 12, True),
                                           (12, 24, False), (1, 63, False)])
def test_card_branch_takes_any_lengths(monkeypatch, Sq, Skv, causal):
    """The kernel's branch (rehearsed with its launches faked by the plain
    loop) takes whisper's lengths without blocks: one forward launch,
    the plain loop's answer."""
    fake_flash_launches(monkeypatch)
    common.reset_kernel_launch_counts()
    g = torch.Generator().manual_seed(Sq + Skv)
    q = torch.randn((1, Sq, 4, 64), generator=g)
    k, v = (torch.randn((1, Skv, 4, 64), generator=g) for _ in range(2))
    got = flash.flash_attention(q, k, v, causal=causal)
    assert common.kernel_launch_counts() == {"flash_attention": 1}
    want = flash_ops.flash_attention_fwd_ref(q, k, v, causal=causal,
                                             q_block=Sq, kv_block=Skv)[0]
    torch.testing.assert_close(got, want, **TOL)
    common.reset_kernel_launch_counts()
