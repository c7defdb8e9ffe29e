"""The port's ground rules: what it imports, where it runs, what it refuses.

`repro_torch` imports torch and numpy only - never jax and nothing of the
JAX package; its entry points mean the GPU when no device is given and
raise when there is none (they never carry on on the CPU by themselves);
everything a spec can name beyond the ported slice raises
`NotImplementedError` naming the ROADMAP.md queue that brings it (and what
once raised, since ported, answers as the reference does).
"""

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
from repro_torch.core import engine, htap, schema
from repro_torch.core import session as session_mod
from repro_torch.core.backend import (HopperBackend, TorchBackend,
                                      get_backend)
from repro_torch.core.dsm import DSMReplica
from repro_torch.core.session import HTAPSession, SystemSpec
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
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n"
        "assert 'torch' in sys.modules and 'triton' not in sys.modules\n")
    done = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True)
    assert done.returncode == 0, done.stderr


def test_every_port_module_is_covered_by_the_import_check():
    assert "repro_torch.core.session" in PORT_MODULES
    assert "repro_torch.kernels.build" in PORT_MODULES
    assert len(PORT_MODULES) >= 25


@pytest.mark.parametrize("entry", ["session", "backend", "replica", "run",
                                   "resolve_device", "init_lm",
                                   "init_lm_cache"])
def test_no_device_means_the_gpu_and_raises_without_one(entry):
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a GPU")
    table = _table()
    cfg = configs.get_smoke_config("gemma2-9b")
    with pytest.raises(RuntimeError, match="CUDA"):
        if entry == "init_lm":
            init_lm(cfg, generator=torch.Generator())
        elif entry == "init_lm_cache":
            init_lm_cache(cfg, 1, 8)
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


def _lm(name, make):
    return make(configs.get_smoke_config(name))


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
    (lambda: SystemSpec.polynesia(timing="timeline"), "item 10"),
    (lambda: SystemSpec.polynesia(async_propagation=True), "item 10"),
    (lambda: SystemSpec.si_ss(), "item 12"),
    (lambda: SystemSpec.si_mvcc(), "item 12"),
    (lambda: htap.run("SI-SS", _table(), device="cpu"), "item 12"),
    (lambda: HTAPSession(SystemSpec.polynesia(backend="torch"), _table(),
                         device="cpu").resize_islands(2), "item 11"),
    (lambda: HTAPSession(SystemSpec.polynesia(backend="torch"), _table(),
                         device="cpu").checkpoint("/nonexistent"), "item 11"),
    (lambda: HTAPSession.restore("/nonexistent"), "item 11"),
    (_float_scan, "K18"),
    (lambda: _lm("kimi-k2-1t-a32b", lambda c: init_lm(
        c, generator=torch.Generator(), device="cpu")), "item 14 (MoE)"),
    (lambda: _lm("llama4-scout-17b-a16e", lambda c: init_lm_cache(
        c, 1, 8, device="cpu")), "item 14 (MoE)"),
    (lambda: _lm("jamba-1.5-large-398b", lambda c: init_lm(
        c, generator=torch.Generator(), device="cpu")), "item 14 (MoE)"),
    (lambda: init_moe(torch.Generator(), 8, 16, 4, 2), "item 14 (MoE)"),
    (lambda: moe_apply({}, torch.zeros(1, 2, 8), n_experts=4, top_k=2),
     "item 14 (MoE)"),
    (lambda: _lm("whisper-base", lambda c: init_lm(
        c, generator=torch.Generator(), device="cpu")), "item 14 (whisper)"),
    (lambda: _lm("whisper-base", make_prefill_step), "item 14 (whisper)"),
    (lambda: _lm("whisper-base", make_serve_step), "item 14 (whisper)"),
])
def test_unported_features_raise_and_name_their_roadmap_queue(make, queue):
    if queue in ("item 9", "K18", "item 13"):
        # the delta store, the float32 scan and the mesh placement are
        # ported: the call that raised now answers as the reference's does
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
    assert len(list(build.CSRC.glob("*.cu"))) == 8
    assert build.build_dir().parts[-2:] == ("build", "repro_torch_kernels")
