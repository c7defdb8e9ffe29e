"""The mesh placement of the port (`hopper@N/mesh`: island s resident on
its own device) against the JAX package's `pallas@N/mesh`.

Mirrors tests/test_mesh_backend.py and tests/test_distributed.py in their
port form: the spec grammar, placement resolution and their failure modes,
the island-device context, then every MI preset at N in {1, 2, 4} end to
end - answers, final replica columns, modeled seconds and energy, and the
stats both report - on the eager plane and on the delta plane. The port's
islands are CPU devices (``devices=["cpu"] * N``, the plain versions);
the reference needs one device per island, so at N = 1 it runs in
process, and at N in {2, 4} once, in one module-scoped subprocess with
four emulated host devices (``--xla_force_host_platform_device_count=4``,
which must be set before JAX is imported), as its own mesh tests run it.
Integers and the hardware model's floats: tolerance 0.
"""

import json
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro.core import backend as ref_backend_mod
from repro.core import engine as ref_engine
from repro.core import htap as ref_htap
from repro.core import schema as ref_schema
from repro.core import session as ref_session
from repro_torch import distributed
from repro_torch.core import engine, htap, schema
from repro_torch.core.backend import (PLACEMENTS, BackendSpec, MeshBackend,
                                      ShardedBackend, counting_kernel_calls,
                                      get_backend, parse_backend_spec)
from repro_torch.core.dsm import MeshView, column_to_numpy
from repro_torch.core.session import HTAPSession, SystemSpec

torch.set_num_threads(1)
_REPO = pathlib.Path(__file__).parent.parent

ROWS, COLS, TXNS, QUERIES = 4000, 4, 8000, 12      # tests/conftest.py sizes
N_ROUNDS = 4
MI = ["Polynesia", "MI+SW", "MI+SW+HB", "PIM-Only"]
DELTA_CAPS = [64, None]


def _cpu(n):
    return ["cpu"] * n


# ---------------------------------------------------------------------------
# spec grammar, placement resolution, island devices
# ---------------------------------------------------------------------------

def test_mesh_spec_resolves_to_mesh_backend():
    """'hopper@1/mesh' is a one-island mesh, as 'pallas@1/mesh' is."""
    be = get_backend("hopper@1/mesh", devices=_cpu(1))
    ref = ref_backend_mod.get_backend("pallas@1/mesh")
    assert isinstance(be, MeshBackend) and isinstance(be, ShardedBackend)
    assert (be.placement, be.n_shards) == (ref.placement, ref.n_shards)
    assert be.name == "hopper@1/mesh" and ref.name == "pallas@1/mesh"
    assert be.devices == (torch.device("cpu"),) and be.device == be.devices[0]
    assert be.inner is get_backend("hopper", device="cpu")
    assert get_backend("hopper@1/mesh", devices=_cpu(1)) is be    # cached
    # the island count may come from the device list alone
    assert get_backend("hopper/mesh", devices=_cpu(3)) is \
        get_backend("hopper@3/mesh", devices=_cpu(3))
    st = get_backend("hopper@4/stacked", device="cpu")
    assert isinstance(st, ShardedBackend) and not isinstance(st, MeshBackend)
    assert st.placement == "stacked"
    # stacked and mesh islands of one count are two instances
    assert get_backend("hopper@4", device="cpu") is st
    assert get_backend("hopper@4/mesh", devices=_cpu(4)) is not st


def test_mesh_requires_the_kernel_inner():
    """torch islands cannot be a mesh, as numpy islands cannot in the
    reference; the error names the fix, and comes before any device is
    looked for."""
    for n in (1, 2):
        with pytest.raises(ValueError, match="mesh placement"):
            get_backend(f"torch@{n}/mesh")
        with pytest.raises(ValueError, match=f"hopper@{n}/mesh"):
            get_backend(f"torch@{n}/mesh", devices=_cpu(n))
    with pytest.raises(ValueError, match="pallas@2/mesh"):
        ref_backend_mod.get_backend("numpy@2/mesh")
    with pytest.raises(ValueError, match="hopper@2/mesh"):
        MeshBackend("torch", 2, _cpu(2))


def test_mesh_insufficient_devices_is_actionable():
    want = (torch.cuda.device_count() if torch.cuda.is_available() else 0) + 1
    with pytest.raises(RuntimeError, match="devices=") as err:
        get_backend(f"hopper@{want}/mesh")
    assert f"hopper@{want}'" in str(err.value)          # the stacked form
    with pytest.raises(RuntimeError, match="repeat a device"):
        distributed.island_mesh(want)


def test_placement_argument_and_contradictions():
    be = get_backend("hopper@1", placement="mesh", devices=_cpu(1))
    assert isinstance(be, MeshBackend)
    assert get_backend(be, placement="mesh") is be
    assert get_backend(be, devices=_cpu(1)) is be
    with pytest.raises(ValueError, match="was requested"):
        get_backend(be, placement="stacked")
    with pytest.raises(ValueError, match="was requested"):
        get_backend(be, devices=_cpu(2))
    with pytest.raises(ValueError, match="was requested"):
        get_backend(get_backend("hopper@2", device="cpu"), placement="mesh")
    with pytest.raises(ValueError, match="contradicts"):
        get_backend("hopper@1/mesh", placement="stacked", devices=_cpu(1))
    with pytest.raises(ValueError, match="island devices"):
        get_backend("hopper@2/mesh", devices=_cpu(3))
    with pytest.raises(ValueError, match="devices="):
        get_backend("hopper@2", device="cpu", devices=_cpu(2))
    with pytest.raises(ValueError, match="island 0"):
        get_backend("hopper@2/mesh", device="meta", devices=_cpu(2))
    # the reference's spec-level contradiction raises the same way
    with pytest.raises(ValueError):
        ref_backend_mod.get_backend("pallas@1/mesh", placement="stacked")


def test_property_backend_spec_roundtrip():
    pytest.importorskip(
        "hypothesis",
        reason="property tests need hypothesis (pip install .[test])")
    from hypothesis import given, settings, strategies as st

    @settings(max_examples=60, deadline=None)
    @given(name=st.sampled_from(["torch", "hopper"]),
           n=st.one_of(st.none(), st.integers(1, 64)),
           p=st.one_of(st.none(), st.sampled_from(PLACEMENTS)))
    def prop(name, n, p):
        spec = BackendSpec(name, n, p)
        assert parse_backend_spec(str(spec)) == spec
        assert str(parse_backend_spec(str(spec))) == str(spec)
        ref = ref_backend_mod.BackendSpec("pallas", n, p)
        assert str(ref).replace("pallas", name) == str(spec)

    prop()


@pytest.mark.parametrize("bad", ["@4", "", "hopper@", "hopper@4.0",
                                 "hopper@4/ring", "hopper/", "hopper@4/MESH",
                                 "/mesh", "hopper@0/mesh", "torch@-2/stacked"])
def test_malformed_placement_specs_rejected_as_the_reference(bad):
    try:
        ref_backend_mod.parse_backend_spec(bad.replace("hopper", "pallas"))
    except (KeyError, ValueError) as err:
        with pytest.raises(type(err)):
            parse_backend_spec(bad)
    else:
        pytest.fail(f"the reference accepted {bad!r}")
    with pytest.raises(ValueError):
        BackendSpec("hopper", 4, "ring")


def test_island_devices_context_installs_and_restores(small_workload):
    """A mesh session installs its island devices for the process and
    restores the previous ones when it closes; a backend resolved without
    a list in between lands on them."""
    assert distributed.current_island_mesh() is None
    table, _, _ = small_workload
    devs = _cpu(2)
    session = HTAPSession(SystemSpec.polynesia(backend="hopper@2/mesh"),
                          table, devices=devs)
    assert distributed.current_island_mesh() == session.be.devices
    assert get_backend("hopper@2/mesh") is session.be
    assert distributed.island_mesh(2) == (torch.device("cpu"),) * 2
    inner = HTAPSession(SystemSpec.polynesia(backend="hopper@3/mesh"), table,
                        devices=_cpu(3))
    assert len(distributed.current_island_mesh()) == 3
    inner.abort()
    inner.abort()                                  # idempotent
    assert distributed.current_island_mesh() == session.be.devices
    session.finish()
    assert distributed.current_island_mesh() is None
    distributed.install_island_mesh(["cpu"])
    assert distributed.island_mesh(1) == (torch.device("cpu"),)
    assert distributed.island_mesh(1, devices=["meta"]) == \
        (torch.device("meta"),)
    distributed.clear_island_mesh()
    with pytest.raises(ValueError, match="at least one"):
        distributed.install_island_mesh([])
    with pytest.raises(ValueError, match="n_islands"):
        distributed.island_mesh(0)
    with pytest.raises(ValueError, match="3 island devices"):
        distributed.island_mesh(2, devices=_cpu(3))


def test_system_spec_takes_the_mesh(small_workload):
    table, _, _ = small_workload
    for spec in (SystemSpec.polynesia(backend="hopper@2/mesh"),
                 SystemSpec.polynesia(n_shards=2, placement="mesh")):
        ref = ref_session.SystemSpec.polynesia(
            backend=spec.backend and spec.backend.replace("hopper", "pallas"),
            n_shards=spec.n_shards, placement=spec.placement)
        assert (spec.n_shards, spec.placement) == (ref.n_shards,
                                                   ref.placement)
        session = HTAPSession(spec, table, devices=_cpu(2))
        assert isinstance(session.be, MeshBackend)
        assert session.islands == 2 and session.hw.n_ana_islands == 2
        session.finish()
    with pytest.raises(ValueError, match="bad placement"):
        SystemSpec.polynesia(placement="ring")


# ---------------------------------------------------------------------------
# every MI preset at N in {1, 2, 4}, end to end, against pallas@N/mesh
# ---------------------------------------------------------------------------

def _workload(mod, eng, delete_frac=0.0):
    """The conftest workload; the delta runs turn a fraction of the writes
    into deletes so the overlays carry invalid rows (as
    tests/test_torch_delta.py does)."""
    rng = np.random.default_rng(0)
    sch = mod.make_schema("t", COLS, 32)
    table = mod.gen_table(rng, sch, ROWS)
    stream = mod.gen_update_stream(rng, sch, ROWS, TXNS, write_ratio=0.5)
    qs = eng.gen_queries(rng, QUERIES, COLS)
    if delete_frac:
        dels = (stream.op == 1) & (rng.random(len(stream)) < delete_frac)
        stream.op[dels] = 3
    return table, stream, qs


# The reference's runs: (preset, islands, capacity or "eager") -> its
# answers, modeled numbers and stats as JSON, and its final replica columns
# and overlays as arrays. Run as a program both in process (N = 1) and in
# the subprocess with four host devices (N in {2, 4}).
_PROG = textwrap.dedent("""
    import json
    import sys

    import numpy as np

    from repro.core import engine, htap, schema


    def workload(delete_frac):
        rng = np.random.default_rng(0)
        sch = schema.make_schema("t", {cols}, 32)
        table = schema.gen_table(rng, sch, {rows})
        stream = schema.gen_update_stream(rng, sch, {rows}, {txns},
                                          write_ratio=0.5)
        qs = engine.gen_queries(rng, {queries}, {cols})
        if delete_frac:
            dels = (stream.op == 1) & (rng.random(len(stream)) < delete_frac)
            stream.op[dels] = 3
        return table, stream, qs


    def run(name, n, cap):
        made = []

        class Kept(htap.HTAPSession):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                made.append(self)

        htap.HTAPSession = Kept
        delta = cap != "eager"
        table, stream, qs = workload(0.05 if delta else 0.0)
        res = htap.run(name, table, stream, qs, n_rounds={rounds},
                       backend=f"pallas@{{n}}/mesh", timing="phase",
                       delta_store=delta,
                       delta_capacity=None if cap in ("eager", "default")
                       else int(cap))
        htap.HTAPSession = Kept.__mro__[1]
        [session] = made
        arrays = {{}}
        for c, col in session.replica.columns.items():
            for f in ("codes", "dictionary", "valid"):
                arrays[f"col{{c}}_{{f}}"] = np.asarray(getattr(col, f))
            arrays[f"col{{c}}_version"] = np.asarray(col.version)
        for c, d in session._deltas.items():
            for f in ("rows", "values", "valid", "cids", "n_base",
                      "n_entries"):
                arrays[f"delta{{c}}_{{f}}"] = np.asarray(getattr(d, f))
        meta = dict(results=[int(a) for a in res.results],
                    n_txn=res.n_txn, n_ana=res.n_ana,
                    txn_seconds=res.txn_seconds, ana_seconds=res.ana_seconds,
                    energy_joules=res.energy_joules,
                    stats={{k: v for k, v in res.stats.items()
                           if k != "traces"}})
        return meta, arrays


    def main(out_dir, keys):
        metas = {{}}
        for key in keys:
            name, n, cap = key.split("|")
            meta, arrays = run(name, int(n), cap)
            metas[key] = meta
            np.savez(f"{{out_dir}}/{{len(metas)}}.npz", **arrays)
            metas[key]["file"] = f"{{len(metas)}}.npz"
        with open(f"{{out_dir}}/meta.json", "w") as f:
            json.dump(metas, f)


    if __name__ == "__main__":
        main(sys.argv[1], sys.argv[2:])
""").format(cols=COLS, rows=ROWS, txns=TXNS, queries=QUERIES,
            rounds=N_ROUNDS)

_KEYS = ([f"{name}|{n}|eager" for name in MI for n in (1, 2, 4)]
         + [f"Polynesia|{n}|{'default' if c is None else c}"
            for n in (1, 2, 4) for c in DELTA_CAPS])


@pytest.fixture(scope="module")
def ref_runs(tmp_path_factory):
    """{key: (meta, arrays)} of the reference's pallas@N/mesh runs."""
    out = tmp_path_factory.mktemp("ref_mesh")
    prog = out / "ref_mesh.py"
    prog.write_text(_PROG)
    many = [k for k in _KEYS if k.split("|")[1] != "1"]
    env = {**os.environ, "PYTHONPATH": str(_REPO / "src"),
           "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    for var in ("REPRO_DELTA", "REPRO_DELTA_CAPACITY", "REPRO_BACKEND",
                "REPRO_SHARDS", "REPRO_PLACEMENT", "REPRO_TIMING"):
        env.pop(var, None)
    proc = subprocess.run([sys.executable, str(prog), str(out), *many],
                          cwd=_REPO, capture_output=True, text=True,
                          timeout=600, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    metas = json.loads((out / "meta.json").read_text())
    # one island: in this process, through the same program
    namespace = {"__name__": "ref_mesh"}
    exec(compile(_PROG, str(prog), "exec"), namespace)
    for key in _KEYS:
        if key.split("|")[1] == "1":
            name, _, cap = key.split("|")
            metas[key], arrays = namespace["run"](name, 1, cap)
        else:
            arrays = dict(np.load(out / metas[key]["file"]))
        metas[key] = (metas[key], arrays)
    return metas


def _run_keeping_session(*args, **kwargs):
    made = []

    class Kept(htap.HTAPSession):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(htap, "HTAPSession", Kept)
        result = htap.run(*args, **kwargs)
    [session] = made
    return result, session


def _same_state(session, arrays: dict) -> None:
    """Final replica columns (and live overlays) equal the reference's."""
    for c, col in session.replica.columns.items():
        codes, dictionary, valid, version = column_to_numpy(col)
        np.testing.assert_array_equal(codes, arrays[f"col{c}_codes"])
        np.testing.assert_array_equal(dictionary, arrays[f"col{c}_dictionary"])
        np.testing.assert_array_equal(valid, arrays[f"col{c}_valid"])
        assert version == int(arrays[f"col{c}_version"])
    deltas = getattr(session, "_deltas", {})
    assert sorted(deltas) == sorted(
        int(k[5:].split("_")[0]) for k in arrays if k.endswith("_rows"))
    for c, d in deltas.items():
        for f in ("rows", "values", "valid", "cids"):
            want = arrays[f"delta{c}_{f}"]
            assert getattr(d, f).dtype == want.dtype
            np.testing.assert_array_equal(getattr(d, f), want)
        assert (d.n_base, d.n_entries) == (int(arrays[f"delta{c}_n_base"]),
                                           int(arrays[f"delta{c}_n_entries"]))


def _check(got, session, ref) -> None:
    meta, arrays = ref
    assert got.results == meta["results"]
    assert (got.n_txn, got.n_ana) == (meta["n_txn"], meta["n_ana"])
    assert (got.txn_seconds, got.ana_seconds, got.energy_joules) == (
        meta["txn_seconds"], meta["ana_seconds"], meta["energy_joules"])
    assert {k: v for k, v in got.stats.items() if k != "kernel_launches"} \
        == meta["stats"]
    _same_state(session, arrays)
    assert got.stats["placement"] == "mesh"
    assert got.stats["views_resident"] > 0 and got.stats["sharded_views"] == 0


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("name", MI)
def test_presets_match_reference_mesh(ref_runs, name, n):
    table, stream, queries = _workload(schema, engine)
    got, session = _run_keeping_session(
        name, table, stream, queries, n_rounds=N_ROUNDS,
        backend=f"hopper@{n}/mesh", devices=_cpu(n))
    _check(got, session, ref_runs[f"{name}|{n}|eager"])
    assert got.stats["islands"] == n and session.hw.n_ana_islands == n
    # the placement is answer-neutral: the one-island run answers the same
    one = htap.run(name, table, stream, queries, n_rounds=N_ROUNDS,
                   backend="hopper", device="cpu")
    assert got.results == one.results


@pytest.mark.parametrize("cap", DELTA_CAPS, ids=["cap64", "default"])
@pytest.mark.parametrize("n", [1, 2, 4])
def test_delta_plane_on_the_mesh_matches_reference(ref_runs, n, cap):
    """The reference's test_delta_matches_eager_mesh, at every island
    count: the delta plane's answers equal the eager plane's, and its
    stats, modeled numbers, final columns and overlays the reference's
    delta run on pallas@N/mesh."""
    table, stream, queries = _workload(schema, engine, delete_frac=0.05)
    got, session = _run_keeping_session(
        "Polynesia", table, stream, queries, n_rounds=N_ROUNDS,
        backend=f"hopper@{n}/mesh", devices=_cpu(n), delta_store=True,
        delta_capacity=cap)
    eager = htap.run("Polynesia", table, stream, queries, n_rounds=N_ROUNDS,
                     backend=f"hopper@{n}/mesh", devices=_cpu(n))
    assert got.results == eager.results
    assert got.stats["delta_appends"] > 0
    meta, arrays = ref_runs[f"Polynesia|{n}|{'default' if cap is None else cap}"]
    assert got.results == meta["results"]
    assert (got.txn_seconds, got.ana_seconds, got.energy_joules) == (
        meta["txn_seconds"], meta["ana_seconds"], meta["energy_joules"])
    assert {k: v for k, v in got.stats.items() if k != "kernel_launches"} \
        == meta["stats"]
    _same_state(session, arrays)


def test_mesh_scans_ride_the_mesh_entry_points(small_workload):
    """Every query group goes through the mesh scans, never the stacked
    ones; views are adopted from the Phase-2 install, never re-sharded;
    and the ship batch's value encodes never reach the bucket probe (the
    staged encoder is a binary search, as in the reference)."""
    table, stream, queries = small_workload
    with counting_kernel_calls() as counts:
        res = htap.run("Polynesia", table, stream, queries, n_rounds=4,
                       backend="hopper@4/mesh", devices=_cpu(4))
    assert counts.get("scan_filter_agg_mesh", 0) > 0
    assert counts.get("scan_filter_agg_join_mesh", 0) > 0
    for name in ("scan_filter_agg_sharded", "scan_filter_agg_join_sharded",
                 "scan_filter_agg_group_sharded", "probe", "probe_sharded",
                 "scan_filter_agg", "scan_filter_agg_batch",
                 "scan_filter_agg_join"):
        assert counts.get(name, 0) == 0, (name, counts)
    assert res.stats["views_resident"] > 0 and res.stats["sharded_views"] == 0


def test_ana_only_on_the_mesh_shards_once_and_probes():
    table, _, queries = _workload(schema, engine)
    session = HTAPSession(SystemSpec.ana_only(backend="hopper@2/mesh"),
                          table, devices=_cpu(2))
    assert all(isinstance(v, MeshView) for v in session._view.values())
    with counting_kernel_calls() as counts:
        got = session.query_batch(queries)
    session.finish()
    ref_table, _, ref_queries = _workload(ref_schema, ref_engine)
    want = ref_htap.run("Ana-Only", ref_table, queries=ref_queries,
                        backend="pallas").results
    assert got == [int(a) for a in want]
    assert counts.get("probe", 0) == sum(q.join_col is not None
                                         for q in queries)
