"""A rehearsal, on the CPU, of `chip_smoke.py`'s `mixed_traffic`,
`si_baselines` and `elastic` phases: their control flow and every check
they make on the card run here at a few thousand rows; of `lm_serve`'s
MoE models and whisper at the smoke configs, with the MoE layer check and
whisper's cross-check; of `lm_train` and whisper's training on the
blocked attention; and the profile's attribution of a range's own events.

The phases take their device as an argument (the CPU here, the card in the
script). The scan wrappers' GPU branch is reached as
tests/test_torch_kernels_fold.py reaches it: ``on_gpu`` patched to True
and the bare launches patched to add the plain versions' results, so the
launch counters the phases check count here as on the card. The mixed
traffic's commit rate is scaled to the smaller stream, so that the
schedule spans the same four-second horizon.
"""

import argparse
import json
import pathlib
import sys

import numpy as np
import pytest
import torch

from repro_torch.core.session import SystemSpec
from repro_torch.kernels import common
from repro_torch.kernels.dict_ops import ops as dict_ops
from repro_torch.kernels.dict_ops import (MAX_CORR_Q, scan_exact_group_ref,
                                          scan_exact_ref,
                                          scan_values_exact_ref)

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402
from test_torch_causal_conv import fake_conv_launches  # noqa: E402
from test_torch_flash_attn import fake_flash_launches  # noqa: E402
from test_torch_kernels_selective_scan import (  # noqa: E402
    fake_gated_scan_launches)

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _fake_launch(fcodes, acodes, fvalid_u8, adict, bounds_dev, out,
                 jcodes=None, jvalid_u8=None, rcount=None, corr_a=None,
                 corr_j=None, vbounds_dev=None):
    if vbounds_dev is None:
        out += scan_exact_ref(fcodes, acodes, fvalid_u8, adict,
                              bounds_dev.tolist(), jcodes, jvalid_u8, rcount)
    else:
        out += scan_exact_group_ref(fcodes, acodes, fvalid_u8, adict,
                                    bounds_dev.tolist(), corr_a,
                                    vbounds_dev.tolist(), jcodes, jvalid_u8,
                                    rcount, corr_j)


def _fake_values_launch(stack, vbounds_dev, out):
    out += scan_values_exact_ref(stack, vbounds_dev.tolist())


def _fake_island_launch(islands, bounds_dev, out, corr_a=None, corr_j=None,
                        vbounds=None):
    assert len(islands) <= dict_ops.MAX_ISLANDS
    assert vbounds is None or len(vbounds) <= MAX_CORR_Q
    for isl in islands:
        out += scan_exact_ref(*isl[:4], bounds_dev.tolist(), *isl[4:])
    if vbounds is not None:
        dict_ops._corr_ref(out, corr_a, corr_j, list(vbounds))


@pytest.fixture
def gpu_branch(monkeypatch):
    monkeypatch.setattr(dict_ops, "on_gpu", lambda *t: True)
    monkeypatch.setattr(dict_ops, "launch_scan_exact", _fake_launch)
    monkeypatch.setattr(dict_ops, "launch_scan_values", _fake_values_launch)
    monkeypatch.setattr(dict_ops, "launch_scan_exact_islands",
                        _fake_island_launch)
    common.reset_kernel_launch_counts()
    yield
    common.reset_kernel_launch_counts()


@pytest.fixture(scope="module")
def small():
    args = argparse.Namespace(rows=3000, cols=4, txns=8000, queries=16,
                              rounds=4, seed=0, delta_capacity=256)
    return args, chip_smoke.make_workload(args)


def _lines(capsys, phase):
    out = capsys.readouterr().out.splitlines()
    return [json.loads(line) for line in out
            if line.startswith("{") and f'"phase": "{phase}"' in line]


def test_mixed_traffic_phase_rehearsed(small, gpu_branch, monkeypatch,
                                       capsys):
    args, wl = small
    monkeypatch.setattr(chip_smoke, "MIXED_TXN_RATE", args.txns / 4.0)
    paths = chip_smoke.phase_mixed_traffic(args, wl, dev=CPU)
    lines = _lines(capsys, "mixed_traffic")
    schedule, runs = lines[0], lines[1:]
    assert schedule["clients"] == 4 and schedule["offered"] == args.queries
    assert 1 < schedule["positions"] <= schedule["arrivals"] <= args.queries
    assert [r["run"] for r in runs] == ["hopper", "hopper async",
                                        "hopper@4/mesh delta async"]
    assert all(r["ok"] for r in runs)
    assert len({r["answers_checksum"] for r in runs}) == 1
    groups, joins = schedule["query_groups"], schedule["join_groups"]
    assert runs[0]["launches"] == {"scan_exact": groups - joins,
                                   "scan_exact_join": joins}
    assert runs[2]["launches"] == {"scan_exact_mesh": groups - joins,
                                   "scan_exact_join_mesh": joins}
    sync, asy = runs[0]["modeled"], runs[1]["modeled"]
    assert asy["txns_per_s"] >= sync["txns_per_s"]
    assert sync["freshness"]["n_batches"] > 0
    assert 0.0 <= sync["latency_p50"] <= sync["latency_p99"]
    for r in runs:
        assert r["batch_seconds"]["max"] <= r["batch_seconds"]["sum"]
        assert r["phase_seconds"] >= r["served_wall_seconds"]
    # each served run is a path of its own, counted from 0: the by-hand
    # drive before it adds nothing
    assert list(paths) == ["mixed_traffic", "mixed_traffic_async",
                           "mixed_traffic_mesh"]
    for (launches, shapes), r in zip(paths.values(), runs):
        assert launches == r["launches"]
        assert set(shapes) == set(launches)
    assert paths["mixed_traffic"][0]["scan_exact"] == groups - joins
    assert paths["mixed_traffic_mesh"][0]["scan_exact_join_mesh"] == joins


def test_mixed_traffic_phase_fails_on_a_wrong_answer(small, gpu_branch,
                                                     monkeypatch):
    """A check that cannot fail proves nothing: an answer off by one in
    the served runs fails the phase."""
    args, wl = small
    monkeypatch.setattr(chip_smoke, "MIXED_TXN_RATE", args.txns / 4.0)
    from repro_torch.core import htap
    real = htap.run_mixed_traffic

    def off_by_one(*a, **kw):
        res = real(*a, **kw)
        res.results[-1] += 1
        return res

    monkeypatch.setattr(htap, "run_mixed_traffic", off_by_one)
    with pytest.raises(AssertionError, match="host evaluation"):
        chip_smoke.phase_mixed_traffic(args, wl, dev=CPU)


def test_mixed_traffic_phase_fails_on_a_second_scan(small, gpu_branch,
                                                    monkeypatch):
    args, wl = small
    monkeypatch.setattr(chip_smoke, "MIXED_TXN_RATE", args.txns / 4.0)
    from repro_torch.core import engine
    real = engine.run_query_group_dsm

    def twice(*a, **kw):
        real(*a, **kw)
        return real(*a, **kw)

    monkeypatch.setattr(engine, "run_query_group_dsm", twice)
    with pytest.raises(AssertionError, match="once a query group"):
        chip_smoke.phase_mixed_traffic(args, wl, dev=CPU)


def test_si_baselines_phase_rehearsed(small, capsys):
    args, wl = small
    answers, _, _, result = chip_smoke.drive_spec(
        SystemSpec.polynesia(backend="hopper"), wl, args, check_host=True,
        device=CPU)
    common.reset_kernel_launch_counts()
    launches, shapes = chip_smoke.phase_si_baselines(args, wl, answers,
                                                     result, dev=CPU)
    assert launches == {} and shapes == {}
    lines = _lines(capsys, "si_baselines")
    assert [ln["system"] for ln in lines] == ["SI-SS", "SI-MVCC"]
    ss, mvcc = lines
    assert ss["rows"] == mvcc["rows"] == args.rows
    assert ss["answers_checksum"] == sum(answers)
    assert ss["stats"]["snapshots"] >= 1
    assert mvcc["stats"]["versions"] > 0
    assert ss["answers_checksum"] != mvcc["answers_checksum"]
    for ln in lines:
        assert ln["polynesia_over_this"]["txn"] > 0
        assert len(ln["round_seconds"]) == args.rounds + 1


def test_si_baselines_phase_fails_on_a_stale_mvcc_read(small, monkeypatch):
    """SI-MVCC held to the round start: reading at "now" instead fails."""
    args, wl = small
    answers, _, _, result = chip_smoke.drive_spec(
        SystemSpec.polynesia(backend="hopper"), wl, args, check_host=True,
        device=CPU)
    from repro_torch.core.mvcc import MVCCStore
    real = MVCCStore.read_column_at
    monkeypatch.setattr(MVCCStore, "read_column_at",
                        lambda self, col, ts, *a: real(self, col, 10**12, *a))
    with pytest.raises(AssertionError, match="round start"):
        chip_smoke.phase_si_baselines(args, wl, answers, result, dev=CPU)


def test_mixed_schedule_is_the_seeded_one(small):
    args, wl = small
    from repro.core.workload import mixed_traffic_schedule as ref_schedule
    got = chip_smoke.mixed_schedule(args, wl)
    clients = [wl["queries"][c::4] for c in range(4)]
    want = ref_schedule(np.random.default_rng(args.seed + 1), clients,
                        args.txns, chip_smoke.MIXED_TXN_RATE, [3.0] * 4)
    assert [(a.time, a.client, a.position) for a in got] == \
        [(a.time, a.client, a.position) for a in want]


@pytest.fixture(scope="module")
def main_path(small):
    """The main path's answers and final columns on the CPU."""
    args, wl = small
    answers, _, session, _ = chip_smoke.drive_spec(
        SystemSpec.polynesia(backend="hopper"), wl, args, check_host=True,
        device=CPU)
    return answers, session.replica.columns


def test_elastic_phase_rehearsed(small, main_path, gpu_branch, capsys):
    args, wl = small
    answers, cols = main_path
    launches, shapes = chip_smoke.phase_elastic(args, wl, answers, cols,
                                                dev=CPU)
    lines = _lines(capsys, "elastic")
    assert [ln.get("part") for ln in lines] == ["resize", "checkpoint",
                                                "crash", None]
    resize, ckpt, crash, total = lines
    assert all(ln["ok"] for ln in lines)
    assert [r["node"] for r in resize["resizes"]] == [
        "r0:reshard0", "r1:reshard1", "r2:reshard2"]
    assert all(r["modeled_seconds"] > 0 for r in resize["resizes"])
    assert 0 < resize["mesh_views_resident"] <= args.cols
    assert resize["answers_checksum"] == sum(answers)
    assert ckpt["live_overlay_rows"] > 0 and ckpt["checkpoint_bytes"] > 0
    assert set(ckpt["restore_seconds"]) == {"same", "hopper@2/mesh",
                                           "eager hopper, refused"}
    assert crash["recovered"] and crash["restored_step"] == 2
    assert crash["answers_checksum"] == sum(answers[:args.queries])
    # the phase is a launch-count path of its own: every scan family ran
    assert total["launches"] == launches and set(shapes) == set(launches)
    for k in ("scan_exact", "scan_exact_sharded", "scan_exact_mesh",
              "scan_exact_group_sharded"):
        assert launches.get(k, 0) > 0, (k, launches)


def test_elastic_phase_fails_on_a_wrong_restored_answer(small, main_path,
                                                        gpu_branch,
                                                        monkeypatch):
    """A restored session whose answers differ fails the phase."""
    args, wl = small
    answers, cols = main_path
    from repro_torch.core import elastic
    real = elastic.restore_session

    def off_by_one(*a, **kw):
        session = real(*a, **kw)
        session.results[0] += 1
        return session

    monkeypatch.setattr(elastic, "restore_session", off_by_one)
    with pytest.raises(AssertionError, match="elastic restore onto same"):
        chip_smoke.phase_elastic(args, wl, answers, cols, dev=CPU)


def test_elastic_phase_fails_on_a_scan_of_the_old_partition(
        small, main_path, gpu_branch, monkeypatch):
    """A resize that records its trail but leaves the session scanning its
    old partition fails the phase: the scans must switch with it."""
    args, wl = small
    answers, cols = main_path
    from repro_torch.core import elastic

    def trail_only(session, n_islands, placement=None, devices=None):
        node = f"r{session.round}:reshard{len(session.resizes)}"
        session.resizes.append({"round": session.round,
                                "from": session.islands, "to": n_islands,
                                "placement": placement or "stacked",
                                "node": node})
        return node

    monkeypatch.setattr(elastic, "resize_islands", trail_only)
    with pytest.raises(AssertionError, match="the partition's are"):
        chip_smoke.phase_elastic(args, wl, answers, cols, dev=CPU)


# ---------------------------------------------------------------------------
# lm_serve's MoE models and the MoE layer check
# ---------------------------------------------------------------------------

MOE_SMOKE = ["kimi-k2-1t-a32b", "llama4-scout-17b-a16e",
             "jamba-1.5-large-398b"]


def _moe_layer(name, seed=0):
    """A smoke config's first MoE layer in bf16, and the decode batch: B =
    4 tokens, S = 1, bf16."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.lm import init_lm
    cfg = get_smoke_config(name)
    gen = torch.Generator().manual_seed(seed)
    model = init_lm(cfg, generator=gen, device=CPU, dtype=torch.bfloat16)
    layer = next(la for la in model.layers if la.spec.mlp == "moe")
    x = torch.randn((4, 1, cfg.d_model), generator=gen).bfloat16()
    return layer["moe"], cfg, x


def _wrong_route(real):
    """`moe.route` with token 0's first expert moved to the next one."""
    def route(p, xg, top_k):
        logits, probs, gates, idx = real(p, xg, top_k)
        idx = idx.clone()
        idx[0, 0, 0] = (idx[0, 0, 0] + 1) % probs.shape[-1]
        return logits, probs, gates, idx
    return route


@pytest.mark.parametrize("name", MOE_SMOKE)
def test_moe_layer_check_passes_on_the_ports_moe_apply(name):
    p, cfg, x = _moe_layer(name)
    out = chip_smoke.moe_layer_check(p, cfg, x)
    assert out["experts_equal"] and out["capacity"] == 4
    assert out["dtype"] == "torch.bfloat16"
    assert out["max_abs_err"] <= chip_smoke.MOE_CHECK_TOL * \
        out["max_abs_oracle"]


@pytest.mark.parametrize("patched", ["route", "moe_apply"])
@pytest.mark.parametrize("name", MOE_SMOKE[:2])
def test_moe_layer_check_fails_on_a_token_sent_to_a_wrong_expert(
        name, patched, monkeypatch):
    """`route` patched (moe_apply and the check both see the wrong
    expert: the exact expert check fails) or only the routing inside
    `moe_apply` (the output check fails)."""
    from repro_torch.nn import moe
    p, cfg, x = _moe_layer(name)
    wrong = _wrong_route(moe.route)
    if patched == "route":
        monkeypatch.setattr(moe, "route", wrong)
        match = "routes tokens \\[0\\]"
    else:
        real = moe.moe_apply

        def apply(*a, **kw):
            with monkeypatch.context() as m:
                m.setattr(moe, "route", wrong)
                return real(*a, **kw)

        monkeypatch.setattr(moe, "moe_apply", apply)
        match = "differs from the float32 oracle"
    with pytest.raises(AssertionError, match=match):
        chip_smoke.moe_layer_check(p, cfg, x)


def test_moe_layer_check_refuses_a_capacity_that_could_drop():
    import dataclasses
    p, cfg, x = _moe_layer("kimi-k2-1t-a32b")
    with pytest.raises(ValueError, match="could drop"):
        chip_smoke.moe_layer_check(
            p, dataclasses.replace(cfg, capacity_factor=1.0),
            x.expand(4, 4, -1).reshape(2, 8, -1))


@pytest.fixture
def decode_gpu_branch(monkeypatch):
    """The decode-attention wrapper's GPU branch with its launch replaced
    by the plain version, so the launch counts run as on the card; the
    `torch.cuda` calls of `lm_serve` made no-ops; no profiler."""
    from repro_torch.kernels.decode_attn import ops as da

    def launch(q, k, v, n, out, scale, cap, *rest):
        out.copy_(da.decode_attention_ref(q, k, v, n, scale, cap))

    monkeypatch.setattr(da, "on_gpu", lambda *t: True)
    monkeypatch.setattr(da, "resident_blocks", lambda *a: 132)
    monkeypatch.setattr(da, "launch_decode_attention", launch)
    for fn in ("synchronize", "empty_cache", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, fn, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    monkeypatch.setattr(chip_smoke, "profile_steps",
                        lambda *a: {"device_time": "not measured (CPU)"})
    common.reset_kernel_launch_counts()
    yield
    common.reset_kernel_launch_counts()


def test_lm_serve_phase_rehearsed_with_the_moe_models(decode_gpu_branch,
                                                      monkeypatch, capsys):
    """kimi-k2 and llama4-scout at their smoke configs through the phase:
    the depth cut (kimi-k2 to one layer), the cross-check with the
    capacity raised to E, serving, the replay, the MoE layer check and the
    launch counts, one decode launch a layer and step."""
    from repro_torch import configs
    monkeypatch.setattr(configs, "get_config", configs.get_smoke_config)
    args = argparse.Namespace(lm_models=MOE_SMOKE[:2], lm_batch=4,
                              lm_prompt=6, lm_gen=3, lm_prefill=32, seed=0)
    launches, shapes = chip_smoke.phase_lm_serve(args, dev=CPU)
    kimi, llama = _lines(capsys, "lm_serve")
    assert (kimi["layers"], kimi["full_layers"]) == (1, 2)
    assert kimi["reduced"] == "depth: one card's memory"
    assert "reduced" not in llama and llama["layers"] == 2
    for line, E in ((kimi, 8), (llama, 4)):
        assert line["ok"] and line["launches"] == {
            "decode_attn": line["layers"] * 8}
        assert line["cross_check"]["capacity_factor"] == E
        assert line["moe_check"]["experts_equal"]
        assert line["weights_read_bound_ms"] > 0
    assert launches == {"decode_attn": 3 * 8}
    heads = {sh[2:5] for sh in shapes["decode_attn"]}
    assert heads == {(4, 2, 16)}


def _whisper_serve_args():
    return argparse.Namespace(lm_models=["whisper-base"], lm_batch=4,
                              lm_prompt=6, lm_gen=3, lm_prefill=32, seed=0)


def test_lm_serve_phase_rehearsed_with_whisper(decode_gpu_branch,
                                               monkeypatch, capsys):
    """whisper-base-smoke through the phase: the float32 cross-check of
    `encdec_decode_step` against `encdec_apply` at LM_CHECK positions over
    `enc_context` frames, the encode and cross K/V, the prefill against
    the frames, serving, the replay and the launch counts: one decode
    launch a decoder layer and step, none in the encoder, the cross K/V
    or the prefill."""
    from repro_torch import configs
    monkeypatch.setattr(configs, "get_config", configs.get_smoke_config)
    launches, shapes = chip_smoke.phase_lm_serve(_whisper_serve_args(),
                                                 dev=CPU)
    (line,) = _lines(capsys, "lm_serve")
    assert line["ok"] and line["model"] == "whisper-base"
    assert (line["layers"], line["full_layers"]) == (4, 4)
    assert (line["enc_layers"], line["dec_layers"]) == (2, 2)
    assert "reduced" not in line
    assert line["launches"] == launches == {"decode_attn": 2 * 8}
    assert {sh[2:5] for sh in shapes["decode_attn"]} == {(4, 4, 16)}
    check = line["cross_check"]
    assert (check["layers"], check["positions"], check["frames"]) == (
        4, chip_smoke.LM_CHECK, 16)
    assert check["max_abs_err"] <= 2e-3
    assert line["frames"] == 16 and line["prefill_tokens"] == 4 * 6
    assert line["finite_checked_steps"] == 6 + 3 - 1
    # a step reads the decoder (without the cross K/V projections), the
    # final norm and the head, in float32 here, and the cross K/V
    cfg = configs.get_smoke_config("whisper-base")
    d, f, V = cfg.d_model, cfg.d_ff, cfg.vocab_size
    layer = 3 * d + 6 * d * d + 3 * d * f      # ln1, lnx, ln2
    assert line["weights_read_bytes"] == 4 * (2 * layer + d + d * V)
    assert line["cross_kv_bytes"] == 2 * 2 * 4 * 16 * d * 4
    assert line["read_bound_ms_with_cross_kv"] > line["weights_read_bound_ms"]


def test_lm_serve_phase_rehearsed_with_falcon_mamba(decode_gpu_branch,
                                                    monkeypatch, capsys):
    """falcon-mamba-7b-smoke through the phase, the scan's and the conv's
    GPU branches faked: its two prefill calls launch the scan and the conv
    once a layer each; the decode steps launch neither (the plain Mamba
    step)."""
    from repro_torch import configs
    monkeypatch.setattr(configs, "get_config", configs.get_smoke_config)
    fake_gated_scan_launches(monkeypatch)
    fake_conv_launches(monkeypatch)
    args = argparse.Namespace(lm_models=["falcon-mamba-7b"], lm_batch=4,
                              lm_prompt=6, lm_gen=3, lm_prefill=32, seed=0)
    launches, shapes = chip_smoke.phase_lm_serve(args, dev=CPU)
    (line,) = _lines(capsys, "lm_serve")
    assert line["ok"] and line["prefill_tokens"] == 4 * 32
    assert line["launches"] == launches == {"selective_scan": 2 * 2,
                                            "causal_conv": 2 * 2}
    assert shapes["causal_conv"] == {(4, 32, 128, 4): 4}
    assert line["cross_check"]["max_abs_err"] <= 2e-3


def _gemma2_prefill(monkeypatch):
    """gemma2-9b-smoke with head_dim 64 (one the blocked kernel takes; the
    smoke config's is 16) through `lm_serve`, its prefill at 4 x 2,048
    tokens (the blocked attention's threshold), the blocked attention's
    GPU branch faked."""
    import dataclasses

    from repro_torch import configs
    monkeypatch.setattr(configs, "get_config", lambda name: dataclasses.replace(
        configs.get_smoke_config(name), head_dim=64))
    fake_flash_launches(monkeypatch)
    monkeypatch.setattr(chip_smoke, "LM_ATTN_PREFILL_LEN", 2048)
    return argparse.Namespace(lm_models=["gemma2-9b"], lm_batch=4,
                              lm_prompt=6, lm_gen=3, lm_prefill=32, seed=0)


def test_lm_serve_phase_rehearsed_with_gemma2s_prefill(decode_gpu_branch,
                                                       monkeypatch, capsys):
    """gemma2-9b-smoke's prefill of 4 x 2,048 tokens, twice: every
    attention layer (one local, one global) takes the blocked kernel, one
    launch a layer and call at each layer's window, never the plain loop
    or the plain attention; finite logits; then serving as before."""
    args = _gemma2_prefill(monkeypatch)
    launches, shapes = chip_smoke.phase_lm_serve(args, dev=CPU)
    (line,) = _lines(capsys, "lm_serve")
    assert line["ok"] and line["model"] == "gemma2-9b"
    assert launches == line["launches"] == {"decode_attn": 2 * 8,
                                            "flash_attention": 2 * 2}
    local = (4, 2048, 2048, 4, 2, 64, 1, 8, 50)
    assert shapes["flash_attention"] == {local: 2,
                                         local[:7] + (0, 50): 2}
    assert line["prefill_tokens"] == 4 * 2048
    assert len(line["prefill_seconds"]) == 2
    assert line["prefill_attention_calls"] == {
        "flash_attention": 4, "_sdpa": 0, "flash_attention_fwd_ref": 0}


def test_lm_serve_phase_fails_when_the_prefill_takes_the_plain_loop(
        decode_gpu_branch, monkeypatch):
    """A prefill whose blocked attention reaches the plain loop (the
    wrapper's GPU branch not taken) fails the phase."""
    from repro_torch.kernels import common as kernels_common
    from repro_torch.kernels.flash_attn import ops as flash_ops
    args = _gemma2_prefill(monkeypatch)
    monkeypatch.setattr(flash_ops, "on_gpu", kernels_common.on_gpu)
    with pytest.raises(AssertionError, match="prefill attention calls"):
        chip_smoke.phase_lm_serve(args, dev=CPU)


def test_lm_serve_phase_frees_each_model_before_the_next(decode_gpu_branch,
                                                        monkeypatch):
    """Nothing of a model outlives its iteration (a MoE layer kept for the
    layer check held kimi-k2's experts under the next model's peak bytes):
    when a model is built, no parameter of a model built before it is
    left."""
    import gc
    import weakref

    from repro_torch import configs
    from repro_torch.models import encdec, lm
    monkeypatch.setattr(configs, "get_config", configs.get_smoke_config)
    built, params = [], []

    def tracked(real):
        def init(*a, **kw):
            gc.collect()
            alive = [r() for r in params if r() is not None]
            assert not alive, f"{len(alive)} earlier parameter(s) alive"
            model = real(*a, **kw)
            built.append(model.cfg.name)
            params.extend(weakref.ref(p) for p in model.parameters())
            return model
        return init
    monkeypatch.setattr(lm, "init_lm", tracked(lm.init_lm))
    monkeypatch.setattr(encdec, "init_encdec", tracked(encdec.init_encdec))
    args = _whisper_serve_args()
    args.lm_models = ["kimi-k2-1t-a32b", "whisper-base"]
    chip_smoke.phase_lm_serve(args, dev=CPU)
    assert len(built) == 4          # each model's cross-check and its run


def test_lm_serve_phase_fails_on_wrong_cross_kv(decode_gpu_branch,
                                               monkeypatch):
    """A cross K/V of zeros (the encoder's output never reaching the
    decoder at decode) makes decode differ from the parallel apply: the
    cross-check fails the phase."""
    from repro_torch import configs
    from repro_torch.models import encdec
    monkeypatch.setattr(configs, "get_config", configs.get_smoke_config)
    real = encdec.precompute_cross_kv

    def zeros(*a, **kw):
        return [{k: torch.zeros_like(v) for k, v in kv.items()}
                for kv in real(*a, **kw)]
    monkeypatch.setattr(encdec, "precompute_cross_kv", zeros)
    with pytest.raises(AssertionError, match="cross-check: decode logits"):
        chip_smoke.phase_lm_serve(_whisper_serve_args(), dev=CPU)


# ---------------------------------------------------------------------------
# lm_train: the benchmark's training cell cut to the tiny sizes of its tests,
# fed by the token pipeline, every kernel's GPU branch faked with its plain
# version
# ---------------------------------------------------------------------------

@pytest.fixture
def train_gpu_branch(monkeypatch):
    """The GPU branch of the wrappers `lm_train` runs - the gated selective
    scan and its backward (`fake_gated_scan_launches`), the k-way merge, the fused apply, the snapshot copy,
    AdamW's update - and whisper's training runs - the blocked attention
    and its backward (`fake_flash_launches`), the causal conv and its
    backward (`fake_conv_launches`) - with each bare launch
    writing its plain version's result, so the launch counts run as on the
    card; the `torch.cuda` calls made no-ops; no profiler; 3 training
    steps, and the gradient cross-check at 2 x 8 tokens."""
    from repro_torch.kernels.adamw import ops as adamw_ops
    from repro_torch.kernels.bitonic_sort import ops as bitonic_ops
    from repro_torch.kernels.merge_runs import ops as merge_ops
    from repro_torch.kernels.snapshot_copy import ops as snap_ops

    def kway(keys, offsets, out_keys, out_idx):
        # runs concatenated in order, each ascending: a stable sort keeps
        # ties in run order, as the kernel does
        order = torch.sort(keys, stable=True).indices
        out_keys.copy_(keys[order])
        out_idx.copy_(order.to(out_idx.dtype))

    def apply(old_rows, val_rows, svals, merged, scratch=None):
        s, m = bitonic_ops.apply_pipeline_batch_ref(old_rows, val_rows)
        svals.copy_(s)
        merged.copy_(m)

    def snap(src, prev, flags_u8, out, block=8192):
        out.copy_(snap_ops.snapshot_copy_ref(src, prev, flags_u8, block))

    for mod, name, fake in ((merge_ops, "launch_merge_kway", kway),
                            (bitonic_ops, "launch_bitonic_apply", apply),
                            (snap_ops, "launch_snapshot_copy", snap),
                            (adamw_ops, "launch_adamw",
                             adamw_ops.adamw_update_ref)):
        monkeypatch.setattr(mod, "on_gpu", lambda *t: True)
        monkeypatch.setattr(mod, name, fake)
    fake_gated_scan_launches(monkeypatch)
    fake_flash_launches(monkeypatch)
    fake_conv_launches(monkeypatch)
    for fn in ("synchronize", "empty_cache", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, fn, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    monkeypatch.setattr(chip_smoke, "profile_device",
                        lambda *a: {"device_time": "not measured (CPU)"})
    for name, value in (("LM_TRAIN_STEPS", 3), ("LM_GRAD_CHECK", (2, 1, 8))):
        monkeypatch.setattr(chip_smoke, name, value)
    common.reset_kernel_launch_counts()
    yield
    common.reset_kernel_launch_counts()


def _tiny_cell(monkeypatch, **job):
    """The training cell's files as the benchmark's tests cut them
    (`bench/tests/tiny.py`: 2 layers at d 64, 2 x 128 tokens a step, a
    4,096-token column, 256 ingested a step), the configuration's ``job``
    updated by `job`: what `harness.load_cell` hands the phase."""
    from bench import harness
    from bench.tests import tiny
    real = harness.load_cell

    def load(bench, name, root=harness.ROOT):
        wl, config, traffic = real(bench, name, root)
        config.update(tiny.TRAIN_CONFIG)
        config["job"] = {**config["job"], **job}
        traffic.update(tiny.TRAIN_TRAFFIC)
        return wl, config, traffic
    monkeypatch.setattr(harness, "load_cell", load)
    return tiny


def test_lm_train_phase_rehearsed(train_gpu_branch, monkeypatch, capsys):
    """The phase on the tiny cell: the gradient cross-check, the kernels'
    launches counted (the scan and the conv twice a layer and micro-batch
    for remat, their backward calls once, AdamW once a group of leaves),
    the pipeline's kernels, finite losses, every ingested token applied,
    every batch the reference's window."""
    _tiny_cell(monkeypatch)
    launches, shapes = chip_smoke.phase_lm_train(argparse.Namespace(seed=0),
                                                 dev=CPU)
    (line,) = _lines(capsys, "lm_train")
    assert line["ok"] and line["cell"] == "fm7b-train"
    assert line["layers"] == 2 and line["remat"]
    assert line["optimizer"]["name"] == "adamw"
    assert "num_hidden_layers" in line["reduced"]
    assert launches["selective_scan"] == 2 * 2 * 2 * 3
    assert launches["selective_scan_bwd"] == 2 * 2 * 3
    assert line["gated_scans"] == launches["selective_scan"]
    assert launches["causal_conv"] == 2 * 2 * 2 * 3
    assert launches["causal_conv_bwd"] == 2 * 2 * 3
    # bf16 leaves with masters, and A's log and the skip in float32
    assert launches["adamw"] == 2 * 3
    for k in ("merge_runs", "bitonic_apply", "snapshot_copy"):
        assert launches[k] > 0, k
    assert line["launches"] == launches
    assert shapes["selective_scan_bwd"] == {(1, 128, 128, 4): 12}
    assert shapes["causal_conv_bwd"] == {(1, 128, 128, 4): 12}
    losses = line["losses"]
    assert len(losses) == 3 and all(np.isfinite(losses))
    pipe = line["pipeline"]
    assert pipe["rows_at_end"] == 4096 + 3 * 256
    assert pipe["batches_equal_ingested_tokens"] == 3
    check = line["grad_check"]
    assert check["max_rel_err"] <= chip_smoke.LM_GRAD_TOL
    assert check["leaves"] == 2 * 10 + 3        # ln2 gets no gradient


@pytest.mark.parametrize("micro", [1, 2])
def test_lm_train_phase_follows_the_cells_files(train_gpu_branch,
                                                monkeypatch, capsys, micro):
    """What the phase runs is what the cell's files say: the tiny cell's
    batch, sequence, initial column and ingest, and its micro-batches
    (the scan's launches and shapes follow them)."""
    tiny = _tiny_cell(monkeypatch, micro_batches=micro)
    launches, shapes = chip_smoke.phase_lm_train(argparse.Namespace(seed=0),
                                                 dev=CPU)
    (line,) = _lines(capsys, "lm_train")
    tr = tiny.TRAIN_TRAFFIC
    assert (line["batch"], line["seq"], line["micro_batches"]) == (
        tr["batch"], tr["seq_len"], micro)
    assert line["pipeline"]["initial_tokens"] == tr["initial_tokens"]
    assert line["pipeline"]["ingest_per_step"] == tr["ingest_per_step"]
    assert line["d_model"] == tiny.TRAIN_CONFIG["hidden_size"]
    assert line["vocab"] == tiny.TRAIN_CONFIG["vocab_size"]
    rows = tr["batch"] // micro
    assert shapes["selective_scan"] == {(rows, tr["seq_len"], 128, 4):
                                        2 * 2 * micro * 3}
    assert launches["selective_scan_bwd"] == 2 * micro * 3


def test_lm_train_phase_fails_on_a_missing_backward_launch(
        train_gpu_branch, monkeypatch):
    """A backward that never reached the kernel (the scan's output without
    a graph, as before `SelectiveScan`) leaves its launches at 0: the
    phase must fail on the counts."""
    from repro_torch.kernels.selective_scan import ops as scan_ops
    _tiny_cell(monkeypatch)
    real = scan_ops.selective_scan_gated

    def no_graph(*args):
        with torch.no_grad():
            return real(*args)
    import repro_torch.nn.mamba as mamba
    monkeypatch.setattr(mamba, "selective_scan_gated", no_graph)
    with pytest.raises(AssertionError, match="gradient|launches"):
        chip_smoke.phase_lm_train(argparse.Namespace(seed=0), dev=CPU)


def test_lm_train_phase_fails_on_a_wrong_token(train_gpu_branch,
                                              monkeypatch):
    """A snapshot that loses one ingested token's code (the apply or the
    copy wrong at the pipeline's size) gives a batch that differs from
    the tokens ingested: the phase must fail on the batch, though the
    losses stay finite."""
    from repro_torch.kernels.snapshot_copy import ops as snap_ops
    _tiny_cell(monkeypatch)
    real = snap_ops.launch_snapshot_copy

    def wrong(src, prev, flags_u8, out, *rest):
        real(src, prev, flags_u8, out, *rest)
        out[0] = (out[0] + 1) % int(out.max() + 1)     # step 0's window
    monkeypatch.setattr(snap_ops, "launch_snapshot_copy", wrong)
    with pytest.raises(AssertionError, match="differ from the ingested"):
        chip_smoke.phase_lm_train(argparse.Namespace(seed=0), dev=CPU)


def test_lm_train_grad_check_fails_on_a_wrong_backward(train_gpu_branch,
                                                       monkeypatch):
    """A backward kernel that loses a term (here gB) is caught by the
    cross-check on the tiny cell's block: the "card" model (the first
    `lm_loss` call) takes the faked GPU branch, the CPU model the plain
    scan and autograd."""
    from bench.drivers import lm_train
    from repro_torch.kernels.selective_scan import ops as scan_ops
    from repro_torch.models import lm
    _tiny_cell(monkeypatch)
    cfg = lm_train.model_config(chip_smoke.train_cell(0, CPU).config)
    real_bwd, real_loss = scan_ops.launch_selective_scan_gated_bwd, lm.lm_loss
    seen = []

    def wrong(*args):
        real_bwd(*args)
        args[14].zero_()                        # gb_part

    def loss(model, *args):
        seen.append(model)
        return real_loss(model, *args)

    monkeypatch.setattr(scan_ops, "launch_selective_scan_gated_bwd", wrong)
    monkeypatch.setattr(lm, "lm_loss", loss)
    monkeypatch.setattr(scan_ops, "on_gpu",
                        lambda *t: len(seen) == 1)
    assert cfg.remat and cfg.d_model == 64
    with pytest.raises(AssertionError, match="gradient differs from the CPU's"):
        chip_smoke.train_grad_check(cfg, argparse.Namespace(seed=0), CPU)
    assert len(seen) == 2
    # the same check passes with the right backward
    seen.clear()
    monkeypatch.setattr(scan_ops, "launch_selective_scan_gated_bwd",
                        real_bwd)
    out = chip_smoke.train_grad_check(cfg, argparse.Namespace(seed=0), CPU)
    assert len(seen) == 2 and out["max_rel_err"] <= chip_smoke.LM_GRAD_TOL


# ---------------------------------------------------------------------------
# whisper's training: every attention on the blocked path at S = 2,048
# ---------------------------------------------------------------------------

def _whisper_train(monkeypatch):
    """whisper-base-smoke with remat, 1,024-token loss chunks and head_dim
    64 (one the blocked kernel takes; the smoke config's is 16), one step
    of 2 x 2,048 tokens: the blocked attention's threshold."""
    import dataclasses

    from repro_torch import configs
    def get(name):
        return dataclasses.replace(configs.get_smoke_config(name),
                                   remat=True, loss_chunk=1024, head_dim=64)
    monkeypatch.setattr(configs, "get_config", get)
    monkeypatch.setattr(chip_smoke, "ENCDEC_TRAIN_SEQ", 2048)
    monkeypatch.setattr(chip_smoke, "ENCDEC_TRAIN_STEPS", 1)


def test_encdec_train_phase_rehearsed(train_gpu_branch, monkeypatch,
                                      capsys):
    """The phase at the smoke config: finite losses, the float32 gradient
    cross-check on the blocked branch, the blocked attention (2 encoder +
    2 x 2 decoder attentions, twice with remat) on every call through its
    kernel, one forward launch a call and two backward launches a
    backward call (6 a step), AdamW's one launch a step, and no other
    launch."""
    _whisper_train(monkeypatch)
    launches, shapes = chip_smoke.phase_encdec_train(
        argparse.Namespace(seed=0), dev=CPU)
    assert launches == {"flash_attention": 12, "flash_attention_bwd": 12,
                        "adamw": 1}
    bidir = (2, 2048, 2048, 4, 4, 64, 0, 0, 0)      # encoder and cross
    causal = bidir[:6] + (1, 0, 0)                   # decoder self
    (line,) = _lines(capsys, "lm_train")
    ((leaves, n, nbytes, master), times), = shapes.pop("adamw").items()
    assert (n, times, master) == (line["params"], 1, 1) and leaves <= 80
    assert nbytes == getattr(torch, line["dtype"].split(".")[-1]).itemsize
    assert shapes == {"flash_attention": {bidir: 8, causal: 4},
                      "flash_attention_bwd": {bidir: 8, causal: 4}}
    assert line["launches"] == launches
    assert line["backward_calls_per_step"] == 6
    check = line["grad_check"]
    assert (check["enc_layers"], check["dec_layers"], check["seq"]) == (
        1, 1, 2048)
    assert check["max_rel_err"] <= chip_smoke.LM_GRAD_TOL
    assert check["blocked_calls_card"] == 3 * 2     # with the recompute
    assert check["backward_launches_card"] == 2 * 3
    assert line["ok"] and line["model"] == "whisper-base"
    assert (line["layers"], line["enc_layers"], line["dec_layers"]) == (
        4, 2, 2)
    assert line["attention_calls_per_step"] == (2 + 2 * 2) * 2
    assert (line["seq"], line["frames"], line["batch"]) == (2048, 2048, 2)
    assert line["remat"] and line["optimizer"] == "adamw"
    assert len(line["losses"]) == 1 and all(np.isfinite(line["losses"]))


def test_encdec_train_phase_fails_on_a_stray_scan_launch(train_gpu_branch,
                                                         monkeypatch):
    """A selective-scan launch inside the step (here from a patched MLP)
    is not on whisper's path: the phase fails on the launch counts."""
    from repro_torch.kernels.selective_scan import ops as scan_ops
    from repro_torch.models import encdec
    _whisper_train(monkeypatch)
    real = encdec.swiglu
    g = torch.Generator().manual_seed(0)
    x, dt = torch.randn(1, 8, 128, generator=g), torch.rand(1, 8, 128)
    a, b = -torch.rand(128, 4), torch.randn(1, 8, 4, generator=g)

    def swiglu(p, h):
        scan_ops.selective_scan_gated(x, dt, torch.zeros(128), a, b, b,
                                      torch.ones(128), x)
        return real(p, h)
    monkeypatch.setattr(encdec, "swiglu", swiglu)
    with pytest.raises(AssertionError, match="no other hand-written kernel"):
        chip_smoke.phase_encdec_train(argparse.Namespace(seed=0), dev=CPU)


def test_encdec_train_phase_fails_on_the_plain_blocked_loop(
        train_gpu_branch, monkeypatch):
    """A blocked attention that reaches the plain loop on the card (its
    wrapper's GPU branch not taken) fails the phase in its gradient
    cross-check, before any step."""
    from repro_torch.kernels import common as kernels_common
    from repro_torch.kernels.flash_attn import ops as flash_ops
    _whisper_train(monkeypatch)
    monkeypatch.setattr(flash_ops, "on_gpu", kernels_common.on_gpu)
    with pytest.raises(AssertionError, match="flash_attention_fwd_ref"):
        chip_smoke.phase_encdec_train(argparse.Namespace(seed=0), dev=CPU)


def test_encdec_grad_check_fails_on_a_wrong_backward(train_gpu_branch,
                                                     monkeypatch):
    """A dK/dV pass that loses dV is caught by the float32 cross-check: the
    "card" model (the first loss) takes the faked kernels, the CPU model
    the plain loop and autograd."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.kernels.flash_attn import ops as flash_ops
    from repro_torch.models import encdec
    real_dkdv, real_loss = (flash_ops.launch_flash_attention_bwd_dkdv,
                            encdec.encdec_loss)
    seen = []

    def wrong(*args):
        real_dkdv(*args)
        args[7].zero_()                                 # dv

    def loss(model, *args):
        seen.append(model)
        return real_loss(model, *args)
    monkeypatch.setattr(flash_ops, "launch_flash_attention_bwd_dkdv", wrong)
    monkeypatch.setattr(encdec, "encdec_loss", loss)
    monkeypatch.setattr(flash_ops, "on_gpu", lambda *t: len(seen) == 1)
    cfg = dataclasses.replace(configs.get_smoke_config("whisper-base"),
                              remat=True, loss_chunk=1024, head_dim=64)
    with pytest.raises(AssertionError, match="gradient differs from the CPU's"):
        chip_smoke.encdec_grad_check(cfg, argparse.Namespace(seed=0), CPU)
    assert len(seen) == 2


# ---------------------------------------------------------------------------
# AdamW's kernel in the kernels phase: its bytes, its expected launches,
# its edge cases on the wrapper's GPU branch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,per_element", [
    ((80, 1000, 2, 1), 28), ((32, 1000, 4, 1), 32), ((3, 1000, 4, 0), 28),
    ((3, 1000, 2, 0), 22)])
def test_adamw_cost_counts_each_byte_once(shape, per_element):
    assert chip_smoke.adamw_cost(shape) == (1000 * per_element, 16 * 1000)


@pytest.mark.parametrize("masters", [True, False])
def test_adamw_launches_follow_the_wrappers_groups(masters, monkeypatch):
    """The expected launches a step are the launches the optimizer's update
    makes: groups of one parameter type and master flag, at most MAX_LEAVES
    leaves, none for a group without an element."""
    from repro_torch.kernels.adamw import ops as adamw_ops
    from repro_torch.optim import adamw
    model = torch.nn.Module()
    shapes = ([((3,), torch.bfloat16)] * (adamw_ops.MAX_LEAVES + 2)
              + [((0,), torch.float32), ((2, 2), torch.float32)])
    for i, (shape, dt) in enumerate(shapes):
        model.register_parameter(f"p{i}", torch.nn.Parameter(
            torch.ones(shape, dtype=dt)))
    params = dict(model.named_parameters())
    init, update = adamw(master_weights=masters)
    state = init(params)
    monkeypatch.setattr(adamw_ops, "on_gpu", lambda *t: True)
    monkeypatch.setattr(adamw_ops, "launch_adamw", adamw_ops.adamw_update_ref)
    common.reset_kernel_launch_counts()
    update(params, {k: torch.ones_like(p) for k, p in params.items()},
           state, 0)
    assert chip_smoke.adamw_launches(model, state) == 3
    assert common.kernel_launch_counts()["adamw"] == 3
    common.reset_kernel_launch_counts()


def test_adamw_edges_rehearsed_and_a_lost_write_caught(monkeypatch):
    """The kernels phase's AdamW edges on the wrapper's GPU branch, the
    bare launch faked with the plain loop: every case passes; a launch
    that drops the master's write fails the bit-for-bit check."""
    from repro_torch.kernels.adamw import ops as adamw_ops
    monkeypatch.setattr(adamw_ops, "on_gpu", lambda *t: True)
    monkeypatch.setattr(adamw_ops, "launch_adamw", adamw_ops.adamw_update_ref)
    gen = torch.Generator().manual_seed(0)
    assert chip_smoke.edge_adamw(gen, CPU) == 14

    def lost_write(leaves, *rest):
        adamw_ops.adamw_update_ref([(p, g, m, v, None if w is None
                                     else w.clone())
                                    for p, g, m, v, w in leaves], *rest)
    monkeypatch.setattr(adamw_ops, "launch_adamw", lost_write)
    with pytest.raises(AssertionError, match="master differs"):
        chip_smoke.edge_adamw(gen, CPU)
    common.reset_kernel_launch_counts()


def test_conv_costs_count_each_byte_once():
    """falcon-mamba-7b's training shape: x read and y written forward, x
    and gy read and dx written backward (bf16), the taps and bias."""
    shape, n, D = (1, 4096, 8192, 4), 4096 * 8192, 8192
    assert chip_smoke.conv_cost(shape) == (4 * n + 2 * 5 * D, 12 * n)
    assert chip_smoke.conv_bwd_cost(shape) == (6 * n + 4 * 5 * D, 33 * n)
    # the least times the kernel table holds: 0.040 and 0.060 ms
    assert round(chip_smoke.conv_cost(shape)[0]
                 / chip_smoke.HBM_BYTES_PER_S * 1e3, 3) == 0.040
    assert round(chip_smoke.conv_bwd_cost(shape)[0]
                 / chip_smoke.HBM_BYTES_PER_S * 1e3, 3) == 0.060


# ---------------------------------------------------------------------------
# the kernels phase's bounds: the benchmark's least times where it has them
# ---------------------------------------------------------------------------

H100_SMS, H100_SM_CLOCK_HZ = 132, 1.98e9      # NVIDIA H100 80GB HBM3


@pytest.fixture
def h100(monkeypatch):
    """The card's SM count and highest SM clock, as `card_sfu` reads them
    on an H100 SXM."""
    class Props:
        multi_processor_count = H100_SMS
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda *a: Props())
    monkeypatch.setattr(chip_smoke, "max_sm_clock_hz",
                        lambda: H100_SM_CLOCK_HZ)
    return chip_smoke.card_sfu()


def _benchmarks_bound(name, shape, card):
    """(ms, which binds) of a launch (a backward call of the blocked
    attention: two launches) by `bench/yardstick.py` and
    `bench/whisper_yardstick.py`."""
    from bench import whisper_yardstick, yardstick
    if name.startswith("scan_exact"):
        nbytes, ops = yardstick.scan_cost(shape)
        by = ("bytes" if nbytes / yardstick.HBM_BYTES_PER_S
              >= ops / yardstick.ALU_OPS_PER_S else "operations")
        return yardstick.scan_bound_s(shape) * 1e3, by
    if name.startswith("selective_scan"):
        s, by = yardstick.ssm_bound_s(shape, name.endswith("_bwd"), *card)
        return s * 1e3, by
    s, by = whisper_yardstick.flash_bound_s(shape, name.endswith("_bwd"),
                                            *card)
    return s * 1e3 * (2 if name.endswith("_bwd") else 1), by


# the paths' shapes: the main path's scans at 10M rows, the training cell's
# K17 launch, whisper-train's three attentions (16 clips, 20 heads of 64)
@pytest.mark.parametrize("name,shape,want", [
    ("scan_exact", (10_000_000, 18_827, 1), (0.0269, "bytes")),
    ("scan_exact_join", (10_000_000, 25_000, 25_000, 1), (0.0419, "bytes")),
    ("selective_scan", (1, 4096, 8192, 16), (0.1284, "sfu")),
    ("selective_scan_bwd", (1, 4096, 8192, 16), (0.2010, "bytes")),
    ("flash_attention", (16, 1500, 1500, 20, 20, 64, 0, 0, 0),
     (0.1864, "products")),
    ("flash_attention", (16, 448, 448, 20, 20, 64, 1, 0, 0),
     (0.0083, "products")),
    ("flash_attention_bwd", (16, 448, 1500, 20, 20, 64, 0, 0, 0),
     (0.1392, "products")),
    ("flash_attention_bwd", (16, 1500, 1500, 20, 20, 64, 0, 0, 0),
     (0.4659, "products")),
])
def test_kernel_bounds_are_the_benchmarks(h100, name, shape, want):
    """`bound_ms` and `bound_by` of the kernels line are the benchmark's
    least time and binding bound at the card's SMs and clock, for every
    kernel the benchmark reckons; K17's backward counts each exponential
    once (0.1284 ms on the SFUs, under its bytes' 0.2010)."""
    m = chip_smoke.with_bound({"ms": 1.0}, shape, 7,
                              chip_smoke.least_ms(name, shape, h100))
    assert (m["shape"], m["launches_at_shape"]) == (list(shape), 7)
    ms, by = _benchmarks_bound(name, shape, h100)
    assert m["bound_ms"] == pytest.approx(ms, rel=1e-12)
    assert m["bound_by"] == by
    assert (round(m["bound_ms"], 4), m["bound_by"]) == want


def test_card_sfu_fails_without_a_clock(monkeypatch):
    """A card whose highest SM clock `nvidia-smi` does not give leaves the
    SFU bounds unreckoned: the kernels phase stops, saying so."""
    monkeypatch.setattr(chip_smoke, "max_sm_clock_hz", lambda: None)
    with pytest.raises(AssertionError, match="clocks.max.sm"):
        chip_smoke.card_sfu()


@pytest.mark.parametrize("fault", ["forward", "repeat"])
def test_conv_edges_rehearsed_and_a_fault_caught(fault, monkeypatch):
    """The kernels phase's causal-conv edges on the wrappers' GPU branch,
    the bare launches faked with the plain versions: every case passes; a
    forward off by a few roundings in one element, or a backward whose
    second call differs in a bit, fails."""
    from repro_torch.kernels.causal_conv import ops as conv_ops
    fake_conv_launches(monkeypatch)
    gen = torch.Generator().manual_seed(0)
    assert chip_smoke.edge_conv(gen, CPU) == 6 * 3 * 2
    fwd, bwd = conv_ops.launch_causal_conv, conv_ops.launch_causal_conv_bwd
    calls = []

    def off(x, w, b, y):
        fwd(x, w, b, y)
        y.view(-1)[-1] = y.view(-1)[-1].float() * 1.05 + 1.0

    def drifts(x, w, b, gy, dx, part, dw, db):
        bwd(x, w, b, gy, dx, part, dw, db)
        calls.append(1)
        if len(calls) % 2 == 0:
            db.view(-1)[0] += 1
    if fault == "forward":
        monkeypatch.setattr(conv_ops, "launch_causal_conv", off)
        match = "differs from its plain version"
    else:
        monkeypatch.setattr(conv_ops, "launch_causal_conv_bwd", drifts)
        match = "different bits in db"
    with pytest.raises(AssertionError, match=match):
        chip_smoke.edge_conv(gen, CPU)
    common.reset_kernel_launch_counts()


def test_own_ops_link_a_range_to_its_backward():
    """On a CPU profile of a remat'd layer: a range's own ops are its
    forward ops, its recompute inside the backward and the autograd nodes
    of its forward ops with the ops under them, and none of the layer's
    other ops or nodes."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from torch.utils.checkpoint import checkpoint
    g = torch.Generator().manual_seed(0)
    w = torch.randn(16, 16, generator=g, requires_grad=True)
    v = torch.randn(16, 16, generator=g, requires_grad=True)

    def layer(x):
        h = x @ w
        with record_function("attn"):
            h = torch.softmax(h @ h.T, dim=-1) @ h
        return torch.tanh(h @ v)
    x = torch.randn(8, 16, generator=g)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        checkpoint(layer, x, use_reentrant=False).sum().backward()
    events = prof.profiler.kineto_results.events()
    names = [e.name() for e in chip_smoke.own_ops(events, "attn")]
    assert names.count("attn") == 2                  # forward and recompute
    assert names.count("aten::softmax") == 2
    assert names.count("aten::_softmax_backward_data") == 1
    for node in ("SoftmaxBackward0", "MmBackward0"):
        assert node in names, node
    assert "TanhBackward0" not in names
    # the two products outside the range: their nodes are not its own
    assert names.count("MmBackward0") == 2
    assert "aten::tanh" not in names
    everything = [e.name() for e in events]
    assert everything.count("MmBackward0") == 4


# ---------------------------------------------------------------------------
# the build phase's reading of the blocked attention's instances
# ---------------------------------------------------------------------------

def _flash_entry(pas: str, dh: int, bf16: bool) -> str:
    """A kernel entry's mangled name as ptxas and cuobjdump print it."""
    if bf16:
        name = f"flash_{pas}_wgmma_kernel"
        return (f"_ZN12_GLOBAL__N_1{len(name)}{name}ILi{dh}EEEvPK13"
                "__nv_bfloat16S3_S3_PS1_Pfiiiiiiiff")
    name = f"flash_{pas}_kernel"
    return f"_ZN12_GLOBAL__N_1{len(name)}{name}ILi{dh}ELi64ELi64EfEEvPKT2_"


def _sass(ops: dict) -> str:
    """cuobjdump -sass text with one function a key of `ops` ((pass, dh,
    bf16) -> the tensor-core opcode it issues, or None), and a scan kernel
    that issues none."""
    lines = ["Fatbin elf code:", "================", "arch = sm_90a"]
    for (pas, dh, bf16), op in ops.items():
        lines += [f"\t\tFunction : {_flash_entry(pas, dh, bf16)}",
                  "        /*0000*/                   LDC R1, c[0x0][0x28] ;"]
        if op == "HGMMA":
            lines.append("        /*0450*/                   HGMMA.64x64x16"
                         ".F32.BF16 R24, gdesc[UR4], R24, gsb0 ;")
        elif op == "HMMA":
            lines.append("        /*0450*/                   HMMA.16816.F32"
                         ".BF16 R4, R8, R12, R4 ;")
        lines.append("        /*0460*/                   EXIT ;")
    lines += ["\t\tFunction : _ZN12_GLOBAL__N_116scan_float_kernelILb1EEEvv",
              "        /*0000*/                   FFMA R1, R2, R3, R4 ;"]
    return "\n".join(lines) + "\n"


def _flash_build(sass_ops: dict, spills: dict | None = None) -> dict:
    """`phase_build`'s reading of the blocked attention: ptxas' registers
    and spills (as its build log gives them) merged with the SASS."""
    regs = {_flash_entry(*k): 128 for k in sass_ops}
    spill = {_flash_entry(*k): n for k, n in (spills or {}).items()}
    old = dict(chip_smoke.REGISTERS), dict(chip_smoke.SPILLS)
    try:
        chip_smoke.REGISTERS.clear()
        chip_smoke.REGISTERS.update(regs)
        chip_smoke.SPILLS.clear()
        chip_smoke.SPILLS.update(spill)
        flash = chip_smoke.flash_registers()
    finally:
        chip_smoke.REGISTERS.clear()
        chip_smoke.REGISTERS.update(old[0])
        chip_smoke.SPILLS.clear()
        chip_smoke.SPILLS.update(old[1])
    for key, ops in chip_smoke.flash_sass(_sass(sass_ops)).items():
        flash.setdefault(key, {}).update(ops)
    return flash


def _designed() -> dict:
    """The instances as this design builds them: bf16 on wgmma, the float32
    FMA kernels with no tensor-core instruction."""
    ops = {(p, d, True): "HGMMA" for p in chip_smoke.FLASH_PASSES
           for d in (64, 112, 128, 256)}
    ops.update({(p, d, False): None for p in chip_smoke.FLASH_PASSES
                for d in (64, 112, 128, 256)})
    return ops


def test_build_phase_reads_the_flash_instances():
    flash = _flash_build(_designed(), spills={("fwd", 112, True): 8})
    assert len(flash) == 24
    assert flash["fwd d64 bf16"] == dict(registers=128, spill_bytes=0,
                                         HGMMA=1, HMMA=0)
    assert flash["bwd_dkdv d256 f32"] == dict(registers=128, spill_bytes=0,
                                              HGMMA=0, HMMA=0)
    assert flash["fwd d112 bf16"]["spill_bytes"] == 8
    # a spill off the paths' head_dims, and HMMA in a backward, pass
    ops = _designed()
    ops[("bwd_dq", 64, True)] = "HMMA"
    chip_smoke.flash_build_check(_flash_build(ops, {("fwd", 112, True): 8}))


@pytest.mark.parametrize("change,match", [
    ({("bwd_dkdv", 128, True): None}, "no HGMMA or HMMA"),
    ({("fwd", 256, True): "HMMA"}, "no HGMMA"),
    ({("bwd_dq", 64, True): "absent"}, "not in the SASS"),
    ("spill", "bytes of spill"),
])
def test_build_phase_fails_on_a_flash_instance_off_the_tensor_cores(change,
                                                                    match):
    ops, spills = _designed(), None
    if change == "spill":
        spills = {("bwd_dkdv", 256, True): 16}
    else:
        for key, op in change.items():
            if op == "absent":
                del ops[key]
            else:
                ops[key] = op
    with pytest.raises(AssertionError, match=match):
        chip_smoke.flash_build_check(_flash_build(ops, spills))
