"""The port's ground rules: what it imports, where it runs, what it refuses.

`repro_torch` imports torch and numpy only - never jax, ml_dtypes or
anything of the JAX package; its entry points mean the GPU when no device is given and
raise when there is none (they never carry on on the CPU by themselves);
everything a spec can name beyond the ported slice raises
`NotImplementedError` naming the ROADMAP.md queue that brings it (and what
once raised, since ported, answers as the reference does).
"""

import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core import backend as ref_backend_mod
from repro.core import session as ref_session
from repro.kernels.dict_ops import scan_filter_agg as ref_scan_filter_agg
from repro_torch import configs
from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.core import engine, htap, schema
from repro_torch.core import session as session_mod
from repro_torch.core.backend import (HopperBackend, TorchBackend,
                                      get_backend)
from repro_torch.core.dsm import DSMReplica
from repro_torch.core.session import HTAPSession, SystemSpec
from repro_torch.data import HTAPTokenPipeline, SyntheticPipeline
from repro_torch.kernels import common
from repro_torch.kernels.dict_ops import scan_filter_agg
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models.lm import init_lm, init_lm_cache
from repro_torch.nn.moe import init_moe, moe_apply

torch.set_num_threads(1)

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
PORT_MODULES = sorted(
    ".".join(p.relative_to(SRC).with_suffix("").parts).removesuffix(".__init__")
    for p in (SRC / "repro_torch").rglob("*.py"))


def _table():
    rng = np.random.default_rng(0)
    return schema.gen_table(rng, schema.make_schema("t", 3, 8), 64)


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import importlib, sys\n"
        f"sys.path.insert(0, {str(SRC)!r})\n"
        f"for m in {PORT_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro', 'ml_dtypes')]\n"
        "assert not bad, bad\n"
        "assert 'torch' in sys.modules and 'triton' not in sys.modules\n")
    done = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True)
    assert done.returncode == 0, done.stderr


def test_every_port_module_is_covered_by_the_import_check():
    assert "repro_torch.core.session" in PORT_MODULES
    assert "repro_torch.core.elastic" in PORT_MODULES
    assert "repro_torch.checkpoint" in PORT_MODULES
    assert "repro_torch.checkpoint.manager" in PORT_MODULES
    assert "repro_torch.kernels.build" in PORT_MODULES
    assert len(PORT_MODULES) >= 25


@pytest.mark.parametrize("entry", ["session", "backend", "replica", "run",
                                   "resolve_device", "init_lm",
                                   "init_lm_cache", "restore",
                                   "restore_checkpoint", "token_pipeline",
                                   "synthetic_pipeline"])
def test_no_device_means_the_gpu_and_raises_without_one(entry, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a GPU")
    table = _table()
    cfg = configs.get_smoke_config("gemma2-9b")
    if entry == "restore":
        HTAPSession(SystemSpec.polynesia(backend="torch"), table,
                    device="cpu").checkpoint(str(tmp_path))
    elif entry == "restore_checkpoint":
        save_checkpoint(str(tmp_path), 1, {"x": torch.arange(3)})
    with pytest.raises(RuntimeError, match="CUDA"):
        if entry == "restore":
            HTAPSession.restore(str(tmp_path))
        elif entry == "restore_checkpoint":
            restore_checkpoint(str(tmp_path), 1, {"x": torch.arange(3)})
        elif entry == "init_lm":
            init_lm(cfg, generator=torch.Generator())
        elif entry == "init_lm_cache":
            init_lm_cache(cfg, 1, 8)
        elif entry == "token_pipeline":
            HTAPTokenPipeline(100, 8, 2, initial_tokens=64)
        elif entry == "synthetic_pipeline":
            SyntheticPipeline(100, 8, 2)
        elif entry == "session":
            HTAPSession(SystemSpec.polynesia(), table)
        elif entry == "backend":
            get_backend("hopper")
        elif entry == "replica":
            DSMReplica.from_table(table)
        elif entry == "run":
            htap.run("Ana-Only", table, queries=[])
        else:
            common.resolve_device(None)


def test_explicit_cuda_device_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a GPU")
    with pytest.raises(RuntimeError, match="CUDA"):
        get_backend("torch", device="cuda")


@pytest.mark.parametrize("name,cls", [("torch", TorchBackend),
                                      ("hopper", HopperBackend),
                                      ("hopper@1", HopperBackend),
                                      ("torch/stacked", TorchBackend)])
def test_get_backend_resolves_names_on_an_explicit_device(name, cls):
    be = get_backend(name, device="cpu")
    assert type(be) is cls and be.device == torch.device("cpu")
    assert get_backend(name, device="cpu") is be      # one instance
    assert get_backend(be) is be                      # instances pass through


def test_get_backend_rejects_unknown_names_and_device_conflicts():
    with pytest.raises(KeyError, match="unknown backend"):
        get_backend("numpy", device="cpu")
    with pytest.raises(KeyError, match="shard count"):      # as the reference
        get_backend("hopper@x", device="cpu")
    if not torch.cuda.is_available():
        be = get_backend("torch", device="cpu")
        with pytest.raises(RuntimeError):
            get_backend(be, device="cuda")


def _float_scan():
    """The float32 scan (K18) on one row, in the port and in the
    reference, as (sum, count) pairs."""
    z = np.zeros(1, np.int32)
    s, c = scan_filter_agg(torch.from_numpy(z), torch.from_numpy(z),
                           torch.ones(1, dtype=torch.bool),
                           torch.from_numpy(z), 0, 1, exact=False)
    rs, rc = ref_scan_filter_agg(z, z, np.ones(1, bool), z, 0, 1,
                                 exact=False)
    return (float(s), int(c)), (float(rs), int(rc))


def _mesh_fields(port, ref):
    """(placement, island count) of a port backend or spec and of the
    reference's."""
    return ((port.placement, port.n_shards or 1),
            (ref.placement, ref.n_shards or 1))


def _timing_spec(**kw):
    """A timing spec's fields and resolved timing, in the port and in the
    reference."""
    from repro.core.timeline import resolve_timing as ref_resolve_timing
    from repro_torch.core.timeline import resolve_timing
    port = SystemSpec.polynesia(**kw)
    ref = ref_session.SystemSpec.polynesia(**kw)
    return ((port.timing, port.async_propagation, resolve_timing(port.timing)),
            (ref.timing, ref.async_propagation,
             ref_resolve_timing(ref.timing)))


def _si_spec(kind):
    """An SI preset's name, kind and normalization switches, in the port
    and in the reference."""
    port = getattr(SystemSpec, kind)()
    ref = getattr(ref_session.SystemSpec, kind)()
    fields = ("name", "kind", "zero_cost_snapshot", "zero_cost_mvcc")
    return ([getattr(port, f) for f in fields],
            [getattr(ref, f) for f in fields])


def _si_run(name):
    """A small SI run's answers, in the port and in the reference."""
    from repro.core import htap as ref_htap
    rng = np.random.default_rng(0)
    sch = schema.make_schema("t", 3, 8)
    table = schema.gen_table(rng, sch, 64)
    stream = schema.gen_update_stream(rng, sch, 64, 200)
    queries = engine.gen_queries(rng, 4, 3)
    got = htap.run(name, table, stream, queries, n_rounds=2, device="cpu")
    want = ref_htap.run(name, table, stream, queries, n_rounds=2,
                        backend="numpy", n_shards=1)
    return got.results, [int(a) for a in want.results]


def _elastic(surface):
    """The resize trail, a checkpoint's keys, or a restored session's
    answers, in the port and in the reference."""
    import tempfile

    from repro.core import engine as ref_engine
    from repro.core import schema as ref_schema
    out = []
    for eng, sch, cls, spec, kw in (
            (engine, schema, HTAPSession,
             SystemSpec.polynesia(backend="torch"), {"device": "cpu"}),
            (ref_engine, ref_schema, ref_session.HTAPSession,
             ref_session.SystemSpec.polynesia(
                 backend="numpy", n_shards=1, placement="stacked",
                 delta_store=False), {})):
        rng = np.random.default_rng(0)
        table = sch.gen_table(rng, sch.make_schema("t", 3, 8), 64)
        stream = sch.gen_update_stream(rng, sch.make_schema("t", 3, 8), 64,
                                       200)
        queries = eng.gen_queries(rng, 4, 3)
        session = cls(spec, table, **kw)
        session.execute(stream)
        session.query_batch(queries[:2])
        if surface == "resize":
            session.resize_islands(2)
            session.query_batch(queries[2:])
            out.append(session.finish().stats["resizes"])
            continue
        d = tempfile.mkdtemp()
        step = session.checkpoint(d)
        if surface == "checkpoint":
            with open(f"{d}/step_{step}/manifest.json") as f:
                out.append(sorted(json.load(f)["arrays"]))
            continue
        restored = cls.restore(d, spec=spec, **kw)
        out.append([int(a) for a in restored.query_batch(queries[2:])])
    return tuple(out)


def _lm(name, make):
    return make(configs.get_smoke_config(name))


def _shapes(tree):
    """A reference pytree's leaves (or abstract leaves) by dotted path:
    (shape, dtype name)."""
    import jax
    return {".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): (tuple(leaf.shape), str(leaf.dtype))
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _torch_shapes(named):
    return {n: (tuple(t.shape), str(t.dtype).removeprefix("torch."))
            for n, t in named}


def _lm_params(name):
    """A smoke MoE LM's parameters (name, shape, type) layer by layer, in
    the port's `init_lm` and the reference's (stacked block i % period,
    without the stacked axis)."""
    import jax
    from repro.configs import get_smoke_config as ref_smoke
    from repro.models import lm as ref_lm
    cfg = configs.get_smoke_config(name)
    model = init_lm(cfg, generator=torch.Generator(), device="cpu")
    tree = jax.eval_shape(lambda: ref_lm.init_lm(jax.random.PRNGKey(0),
                                                 ref_smoke(name)))
    got = [_torch_shapes(layer.named_parameters()) for layer in model.layers]
    want = [{k: (s[1:], d) for k, (s, d) in _shapes(
        tree["layers"][i % cfg.period]).items()}
        for i in range(cfg.n_layers)]
    return got, want


def _lm_cache(name):
    """A smoke MoE LM's cache shapes and types, layer by layer."""
    import jax
    from repro.configs import get_smoke_config as ref_smoke
    from repro.models import lm as ref_lm
    cfg = configs.get_smoke_config(name)
    cache = init_lm_cache(cfg, 1, 8, device="cpu")
    ref = jax.eval_shape(lambda: ref_lm.init_lm_cache(ref_smoke(name), 1, 8))
    got = [_torch_shapes(c.items()) for c in cache]
    want = [{k: (s[1:], d) for k, (s, d) in _shapes(
        ref[i % cfg.period]).items()} for i in range(cfg.n_layers)]
    return got, want


def _init_moe():
    """`init_moe(8, 16, 4 experts, top 2)`'s parameters in both."""
    import jax
    from repro.nn import moe as ref_moe
    want = jax.eval_shape(lambda: ref_moe.init_moe(jax.random.PRNGKey(0), 8,
                                                   16, 4, 2))
    return (_torch_shapes(init_moe(torch.Generator(), 8, 16, 4,
                                   2).named_parameters()), _shapes(want))


def _moe_apply():
    """`moe_apply` on the reference's parameters: shape, type and whether
    y and aux equal the reference's (2e-5)."""
    import jax
    from repro.nn import moe as ref_moe
    from repro_torch.models.lm import _tree
    from repro_torch.nn.layers import Params
    p = ref_moe.init_moe(jax.random.PRNGKey(0), 8, 16, 4, 2)
    x = np.random.default_rng(0).normal(size=(1, 2, 8)).astype(np.float32)
    want, want_aux = ref_moe.moe_apply(p, x, n_experts=4, top_k=2)
    got, aux = moe_apply(Params(_tree(jax.tree.map(np.asarray, p), "cpu")),
                         torch.from_numpy(x), n_experts=4, top_k=2)
    close = bool(np.allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                             atol=2e-5)) and bool(np.isclose(
        float(aux), float(want_aux), rtol=2e-5, atol=2e-5))
    return ((tuple(got.shape), str(got.dtype), close),
            (tuple(want.shape), "torch." + str(want.dtype), True))


def _encdec():
    """whisper-base-smoke in both packages: (reference cfg, its params,
    the port's cfg, the port's model from the reference's weights)."""
    import jax
    from repro.configs import get_smoke_config as ref_smoke
    from repro.models import encdec as ref_encdec
    from repro_torch.models.encdec import encdec_params_from_reference
    cfg = ref_smoke("whisper-base")
    params = ref_encdec.init_encdec(jax.random.PRNGKey(0), cfg)
    tcfg = configs.get_smoke_config("whisper-base")
    return cfg, params, tcfg, encdec_params_from_reference(
        tcfg, jax.tree.map(np.asarray, params), "cpu")


def _encdec_params():
    """`init_encdec`'s parameters (name, shape, type) in both."""
    import jax
    from repro.configs import get_smoke_config as ref_smoke
    from repro.models import encdec as ref_encdec
    from repro_torch.models.encdec import init_encdec
    model = init_encdec(configs.get_smoke_config("whisper-base"),
                        generator=torch.Generator(), device="cpu")
    want = jax.eval_shape(lambda: ref_encdec.init_encdec(
        jax.random.PRNGKey(0), ref_smoke("whisper-base")))
    return _torch_shapes(model.named_parameters()), _shapes(want)


def _encdec_prefill():
    """The prefill step's last-position logits on the reference's weights:
    shape, type and whether they equal the reference's (2e-5)."""
    import jax.numpy as jnp
    from repro.launch import steps as ref_steps
    cfg, params, tcfg, model = _encdec()
    rng = np.random.default_rng(0)
    frames = rng.normal(size=(2, 16, cfg.d_model)).astype(np.float32)
    toks = rng.integers(0, cfg.vocab_size, (2, 6)).astype(np.int32)
    want = np.asarray(ref_steps.make_prefill_step(cfg)(
        params, {"frames": jnp.asarray(frames), "tokens": jnp.asarray(toks)}))
    got = make_prefill_step(tcfg)(model, {"frames": torch.from_numpy(frames),
                                          "tokens": torch.from_numpy(toks)})
    close = bool(np.allclose(got.numpy(), want, rtol=2e-5, atol=2e-5))
    return ((tuple(got.shape), str(got.dtype), close),
            (want.shape, "torch." + str(want.dtype), True))


def _encdec_serve():
    """Greedy tokens of the serve step, four prompt tokens and four
    generated, against the frames' cross K/V, in both."""
    import jax.numpy as jnp
    from repro.launch import steps as ref_steps
    from repro.models import encdec as ref_encdec
    from repro_torch.models.encdec import (encode, init_encdec_cache,
                                           precompute_cross_kv)
    cfg, params, tcfg, model = _encdec()
    rng = np.random.default_rng(1)
    frames = rng.normal(size=(2, 16, cfg.d_model)).astype(np.float32)
    prompt = rng.integers(0, cfg.vocab_size, (2, 4)).astype(np.int32)
    ref_cache = ref_encdec.init_encdec_cache(cfg, 2, 8, dtype=jnp.float32)
    ref_cache["cross_kv"] = ref_encdec.precompute_cross_kv(
        params, ref_encdec.encode(params, jnp.asarray(frames), cfg), cfg,
        dtype=jnp.float32)
    cache = init_encdec_cache(tcfg, 2, 8, dtype=torch.float32, device="cpu")
    cache["cross_kv"] = precompute_cross_kv(
        model, encode(model, torch.from_numpy(frames), tcfg), tcfg,
        dtype=torch.float32)
    ref_step, step = ref_steps.make_serve_step(cfg), make_serve_step(tcfg)
    want, got = [], []
    w, g = None, None
    for i in range(7):
        if i < 4:
            w = jnp.asarray(prompt[:, i:i + 1])
            g = torch.from_numpy(prompt[:, i:i + 1])
        w, ref_cache = ref_step(params, ref_cache, w, jnp.int32(i))
        g, cache = step(model, cache, g, i)
        want.append(np.asarray(w).tolist())
        got.append(g.tolist())
    return got, want


def _delta_spec(**kw):
    """A delta-store spec's fields and resolved plane, in the port and in
    the reference."""
    port = SystemSpec.polynesia(**kw)
    ref = ref_session.SystemSpec.polynesia(**kw)
    return ((port.delta_store, port.delta_capacity,
             session_mod._resolve_delta(port)),
            (ref.delta_store, ref.delta_capacity,
             ref_session._resolve_delta(ref)))


@pytest.mark.parametrize("make,queue", [
    (lambda: (get_backend("hopper@4", device="cpu").filter_agg_values_delta(
        None, []), ref_backend_mod.get_backend(
            "pallas", n_shards=4, placement="stacked").filter_agg_values_delta(
        None, [])), "item 9"),
    (lambda: _mesh_fields(get_backend("hopper@2/mesh", devices=["cpu"] * 2),
                          ref_backend_mod.parse_backend_spec("pallas@2/mesh")),
     "item 13"),
    (lambda: _mesh_fields(get_backend("hopper/mesh", devices=["cpu"]),
                          ref_backend_mod.get_backend("pallas/mesh")),
     "item 13"),
    (lambda: _mesh_fields(SystemSpec.polynesia(n_shards=4, placement="mesh"),
                          ref_session.SystemSpec.polynesia(
                              n_shards=4, placement="mesh")), "item 13"),
    (lambda: _mesh_fields(SystemSpec.polynesia(placement="mesh"),
                          ref_session.SystemSpec.polynesia(
                              placement="mesh")), "item 13"),
    (lambda: _delta_spec(delta_store=True), "item 9"),
    (lambda: _delta_spec(delta_capacity=64), "item 9"),
    (lambda: _timing_spec(timing="timeline"), "item 10"),
    (lambda: _timing_spec(timing="timeline", async_propagation=True),
     "item 10"),
    (lambda: _si_spec("si_ss"), "item 12"),
    (lambda: _si_spec("si_mvcc"), "item 12"),
    (lambda: _si_run("SI-SS"), "item 12"),
    (lambda: _elastic("resize"), "item 11"),
    (lambda: _elastic("checkpoint"), "item 11"),
    (lambda: _elastic("restore"), "item 11"),
    (_float_scan, "K18"),
    (lambda: _lm_params("kimi-k2-1t-a32b"), "item 14 (MoE)"),
    (lambda: _lm_cache("llama4-scout-17b-a16e"), "item 14 (MoE)"),
    (lambda: _lm_params("jamba-1.5-large-398b"), "item 14 (MoE)"),
    (lambda: _init_moe(), "item 14 (MoE)"),
    (lambda: _moe_apply(), "item 14 (MoE)"),
    (lambda: _encdec_params(), "item 14 (whisper)"),
    (lambda: _encdec_prefill(), "item 14 (whisper)"),
    (lambda: _encdec_serve(), "item 14 (whisper)"),
])
def test_unported_features_raise_and_name_their_roadmap_queue(make, queue):
    if queue in ("item 9", "K18", "item 13", "item 10", "item 12",
                 "item 11", "item 14 (MoE)", "item 14 (whisper)"):
        # the delta store, the float32 scan, the mesh placement, the
        # timeline, the single-instance baselines, the elastic lifecycle,
        # the MoE layer and the encoder-decoder are ported: the call that
        # raised now answers as the reference's does
        got, want = make()
        assert got == want
        return
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue") as err:
        make()
    assert queue in str(err.value)


def test_bad_spec_values_are_still_value_errors():
    with pytest.raises(ValueError, match="unknown system kind"):
        SystemSpec(name="x", kind="nope")
    with pytest.raises(ValueError, match="unknown timing"):
        SystemSpec.polynesia(timing="wallclock")
    with pytest.raises(ValueError, match="n_shards"):
        SystemSpec.polynesia(n_shards=0)
    with pytest.raises(KeyError, match="unknown system preset"):
        htap.run("Nope", _table(), device="cpu")


def test_wrappers_refuse_tensors_on_mixed_devices():
    a = torch.zeros(4, dtype=torch.int32)
    meta = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="different devices"):
        common.on_gpu(a, meta)
    assert common.on_gpu(a, a) is False


def test_launch_counters_stay_zero_on_the_cpu():
    """On CPU tensors a wrapper runs its plain version: it launches no
    kernel, so it counts none."""
    common.reset_kernel_launch_counts()
    rng = np.random.default_rng(1)
    table = schema.gen_table(rng, schema.make_schema("t", 3, 8), 500)
    stream = schema.gen_update_stream(rng, schema.make_schema("t", 3, 8),
                                      500, 3000)
    queries = engine.gen_queries(rng, 6, 3)
    res = htap.run("Polynesia", table, stream, queries, n_rounds=2,
                   backend="hopper", device="cpu")
    assert common.kernel_launch_counts() == {}
    assert res.stats["kernel_launches"] == {}
    assert common.kernel_launch_shapes() == {}
    common.count_launch("x", (3, 4))
    common.count_launch("x", (3, 4))
    common.count_launch("x", (5,))
    assert common.kernel_launch_counts() == {"x": 3}
    assert common.kernel_launch_shapes() == {"x": {(3, 4): 2, (5,): 1}}
    common.reset_kernel_launch_counts()
    assert common.kernel_launch_counts() == {}
    assert common.kernel_launch_shapes() == {}


@pytest.mark.parametrize("n,floor,want", [(0, 8, 8), (1, 8, 8), (9, 8, 16),
                                          (1024, 8, 1024), (1025, 8, 2048),
                                          (3, 1, 4)])
def test_width_bucket(n, floor, want):
    assert common.width_bucket(n, floor) == want
    assert common.next_pow2(want) == want


def test_build_module_names_every_c_entry_and_needs_nvcc_only_at_first_use():
    from repro_torch.kernels import build
    text = "".join(p.read_text() for p in build.CSRC.glob("*.cu"))
    for entry in build._SIGNATURES:
        assert f'extern "C" int {entry}(' in text
    assert len(list(build.CSRC.glob("*.cu"))) == 11
    assert build.build_dir().parts[-2:] == ("build", "repro_torch_kernels")
