"""The port's elastic island lifecycle (`core/elastic.py`) against the JAX
package's: online resharding, checkpoint/restore, crash-recovery replay,
and the closed-session guards.

Mirrors tests/test_elastic.py case by case. Each session runs in the port
(``torch``, ``torch@N``, ``hopper``, and ``hopper@N/mesh`` on
``["cpu"] * N``) and in the reference (``numpy``, ``numpy@N``; the mesh
trips as ``pallas@N/mesh`` in one module-scoped subprocess with four
emulated host devices, as tests/test_torch_mesh.py runs them) on the same
seeded input, and these are compared with ``==``: answers, the resize
trail, the visibility nodes after a resize, the timeline's ``reshard``
node, and every modeled number of the `RunResult` (the modeled plane is
analytic and the same on every backend, so it ports exactly and the
reference's ``numpy`` stands beside the port's ``hopper`` too; a restored
session's snapshot and view counters start afresh in both packages, so a
restored run is held to an uninterrupted one by `_modeled`). Then
checkpoints cross the packages both
ways - the reference's, with live overlays and a pending backlog, restored
in the port, and the port's restored in the reference - and
`benchmarks/fig_elastic.py`'s three runs at a small size. Tolerance 0.
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

from repro.core import elastic as ref_elastic
from repro.core import engine as ref_engine
from repro.core import schema as ref_schema
from repro.core import session as ref_session_mod
from repro_torch.checkpoint import latest_step
from repro_torch.core import elastic, engine, schema
from repro_torch.core.backend import TorchBackend
from repro_torch.core.hwmodel import HardwareModel
from repro_torch.core.session import (HTAPSession, SessionClosedError,
                                      SystemSpec, resolve_spec)
from repro_torch.core.timeline import simulate_timeline
from repro_torch.core.workload import split_queries, split_stream
from repro_torch.distributed import current_island_mesh

torch.set_num_threads(1)
_REPO = pathlib.Path(__file__).parent.parent
CPU = "cpu"
N_ROUNDS = 4


def _workload(mod, eng):
    """tests/test_elastic.py's tiny workload, from either package."""
    rng = np.random.default_rng(0)
    sch = mod.make_schema("t", 3, 32)
    table = mod.gen_table(rng, sch, 600)
    stream = mod.gen_update_stream(rng, sch, 600, 1500, write_ratio=0.5)
    queries = eng.gen_queries(rng, 6, 3)
    return table, stream, queries


@pytest.fixture(scope="module")
def tiny():
    return _workload(schema, engine)


@pytest.fixture(scope="module")
def tiny_ref():
    return _workload(ref_schema, ref_engine)


def _rounds(stream, queries, n_rounds=N_ROUNDS):
    return (split_stream(stream, n_rounds),
            split_queries(list(queries), n_rounds))


def _ref_rounds(stream, queries, n_rounds=N_ROUNDS):
    from repro.core.workload import split_queries as rq, split_stream as rs
    return rs(stream, n_rounds), rq(list(queries), n_rounds)


def _drive(session, chunks, qchunks, resize=None, start=0):
    """Round loop with an optional {round: n | (n, placement[, devices])}
    resize schedule applied after each round's query batch (either
    package's session; devices only for the port's)."""
    for r in range(start, len(chunks)):
        if r > start:
            session.advance_round()
        session.execute(chunks[r])
        session.query_batch(qchunks[r])
        if resize and r in resize:
            tgt = resize[r]
            n, pl, *devs = tgt if isinstance(tgt, tuple) else (tgt, None)
            kw = {"devices": devs[0]} if devs and devs[0] else {}
            session.resize_islands(n, placement=pl, **kw)
    return session.finish()


def _spec(backend="torch", n=1, **kw):
    return SystemSpec.polynesia(backend=backend, n_shards=n, **kw)


def _ref_spec(backend="numpy", n=1, **kw):
    return ref_session_mod.SystemSpec.polynesia(
        backend=backend, n_shards=n, placement="stacked",
        **{"delta_store": False, **kw})


def _meta(res) -> dict:
    """A RunResult as plain data (each package's own launch counters and
    jit-trace ledger left out), through JSON as the subprocess's are."""
    return json.loads(json.dumps(dict(
        name=res.name, results=[int(a) for a in res.results],
        n_txn=res.n_txn, n_ana=res.n_ana, txn_seconds=res.txn_seconds,
        ana_seconds=res.ana_seconds, energy_joules=res.energy_joules,
        freshness_seconds=res.freshness_seconds,
        stats={k: v for k, v in res.stats.items()
               if k not in ("traces", "kernel_launches")})))


# the snapshot and view counters: a checkpoint does not carry them (nor
# does the reference's), so a restored session counts from its restore
COUNTERS = ("snapshots", "shared", "sharded_views", "views_shared",
            "views_resident")


def _modeled(res) -> dict:
    """`_meta` without the counters a restore starts afresh: answers and
    every modeled number."""
    m = _meta(res)
    m["stats"] = {k: v for k, v in m["stats"].items() if k not in COUNTERS}
    return m


# ---------------------------------------------------------------------------
# the reference's mesh trips (four emulated host devices, one subprocess)
# ---------------------------------------------------------------------------

_PROG = textwrap.dedent("""
    import json
    import sys
    import tempfile

    import numpy as np

    from repro.core import elastic, engine, schema
    from repro.core.session import HTAPSession, SystemSpec
    from repro.core.workload import split_queries, split_stream


    def meta(res):
        return dict(name=res.name, results=[int(a) for a in res.results],
                    n_txn=res.n_txn, n_ana=res.n_ana,
                    txn_seconds=res.txn_seconds, ana_seconds=res.ana_seconds,
                    energy_joules=res.energy_joules,
                    freshness_seconds=res.freshness_seconds,
                    stats={k: v for k, v in res.stats.items()
                           if k != "traces"})


    def workload():
        rng = np.random.default_rng(0)
        sch = schema.make_schema("t", 3, 32)
        table = schema.gen_table(rng, sch, 600)
        stream = schema.gen_update_stream(rng, sch, 600, 1500,
                                          write_ratio=0.5)
        return table, stream, engine.gen_queries(rng, 6, 3)


    def spec(backend, n, delta):
        return SystemSpec.polynesia(backend=backend, n_shards=n,
                                    placement="stacked", timing="timeline",
                                    delta_store=delta)


    if __name__ == "__main__":
        table, stream, queries = workload()
        chunks = split_stream(stream, 4)
        qchunks = split_queries(list(queries), 4)
        out = {}
        for delta in (False, True):
            s = HTAPSession(spec("pallas", 1, delta), table)
            for r in range(4):
                if r:
                    s.advance_round()
                s.execute(chunks[r])
                s.query_batch(qchunks[r])
                if r == 0:
                    s.resize_islands(4, placement="mesh")
                elif r == 1:
                    s.resize_islands(2, placement="mesh")
                elif r == 2:
                    s.resize_islands(1, placement="stacked")
            out[f"resize|{delta}"] = meta(s.finish())
        res, rec = elastic.run_with_recovery(
            spec("numpy", 1, False), table, stream, queries, 4,
            tempfile.mkdtemp(), crash_after_ships=3,
            restore_spec=SystemSpec.polynesia(
                backend="pallas@4/mesh", timing="timeline",
                delta_store=False))
        out["crash"] = dict(meta(res), recovered=rec)
        with open(sys.argv[1], "w") as f:
            json.dump(out, f)
""")


@pytest.fixture(scope="module")
def ref_mesh(tmp_path_factory):
    """{key: RunResult data} of the reference's pallas@N/mesh trips."""
    out = tmp_path_factory.mktemp("ref_mesh_elastic")
    prog = out / "ref_mesh_elastic.py"
    prog.write_text(_PROG)
    env = {**os.environ, "PYTHONPATH": str(_REPO / "src"),
           "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    for var in ("REPRO_DELTA", "REPRO_DELTA_CAPACITY", "REPRO_BACKEND",
                "REPRO_SHARDS", "REPRO_PLACEMENT", "REPRO_TIMING",
                "REPRO_CRASH_AFTER"):
        env.pop(var, None)
    proc = subprocess.run([sys.executable, str(prog), str(out / "r.json")],
                          cwd=_REPO, capture_output=True, text=True,
                          timeout=600, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads((out / "r.json").read_text())


# ---------------------------------------------------------------------------
# online resharding
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["torch", "hopper"])
@pytest.mark.parametrize("delta", [False, True])
def test_resize_roundtrip_matches_reference(tiny, tiny_ref, backend, delta):
    """1 -> 4 -> 2 mid-session: answers equal the static one-island run's,
    and the answers, resize trail and modeled numbers the reference's."""
    table, stream, queries = tiny
    chunks, qchunks = _rounds(stream, queries)
    spec = _spec(backend, timing="timeline", delta_store=delta)
    base = _drive(HTAPSession(spec, table, device=CPU), chunks, qchunks)
    res = _drive(HTAPSession(spec, table, device=CPU), chunks, qchunks,
                 resize={0: 4, 1: 2})
    assert res.results == base.results
    trail = res.stats["resizes"]
    assert [(r["from"], r["to"]) for r in trail] == [(1, 4), (4, 2)]
    assert all(r["node"].endswith(f"reshard{i}")
               for i, r in enumerate(trail))
    assert "resizes" not in base.stats
    rt, rs, rq = tiny_ref
    rchunks, rqchunks = _ref_rounds(rs, rq)
    rspec = _ref_spec(timing="timeline", delta_store=delta)
    want = _drive(ref_session_mod.HTAPSession(rspec, rt), rchunks, rqchunks,
                  resize={0: 4, 1: 2})
    assert _meta(res) == _meta(want)


def _two_rounds(session, chunks, qchunks):
    for r in range(2):
        if r:
            session.advance_round()
        session.execute(chunks[r])
        session.query_batch(qchunks[r])
    return session


def test_resize_is_priced_on_the_accel_lane(tiny, tiny_ref):
    """The reshard node lands on the fixed-function lane with the
    reference's duration, and queries (not transactions) wait on it."""
    from repro.core.hwmodel import HardwareModel as RefHardwareModel
    from repro.core.timeline import simulate_timeline as ref_simulate
    table, stream, queries = tiny
    session = _two_rounds(HTAPSession(_spec(timing="timeline"), table,
                                      device=CPU), *_rounds(stream, queries))
    node = session.resize_islands(4)
    assert node == "r1:reshard0"
    assert set(session._vis_node.values()) == {node}
    assert node not in session._round_prop
    tl = simulate_timeline(session.cost, HardwareModel(session.hw))
    sched = {n.tag.node: n for n in tl.nodes}
    assert sched[node].lane == "accel" and sched[node].seconds > 0
    rt, rs, rq = tiny_ref
    ref = _two_rounds(ref_session_mod.HTAPSession(
        _ref_spec(timing="timeline"), rt), *_ref_rounds(rs, rq))
    assert ref.resize_islands(4) == node
    assert session._vis_node == ref._vis_node
    assert session._round_prop == ref._round_prop
    rtl = ref_simulate(ref.cost, RefHardwareModel(ref.hw))
    rsched = {n.tag.node: n for n in rtl.nodes}
    assert (sched[node].lane, sched[node].start, sched[node].seconds) == \
        (rsched[node].lane, rsched[node].start, rsched[node].seconds)
    assert session.cost.tags[node].meta == ref.cost.tags[node].meta
    assert session.cost.tags[node].deps == ref.cost.tags[node].deps
    session.finish()
    ref.finish()


def test_resize_placement_transitions_single_device(tiny, tiny_ref):
    """stacked -> mesh -> stacked on one device: answers and modeled
    numbers the reference's, the island devices installed on entry and
    released on exit, and the shards placed resident at the swap."""
    table, stream, queries = tiny
    chunks, qchunks = _rounds(stream, queries)
    spec = _spec("hopper", timing="timeline")
    prev = current_island_mesh()
    session = HTAPSession(spec, table, device=CPU)
    session.execute(chunks[0])
    session.query_batch(qchunks[0])
    session.resize_islands(1, placement="mesh", devices=[CPU])
    assert session.be.placement == "mesh" and session.mesh
    assert current_island_mesh() == session.be.devices
    assert set(session.cons._resident) == set(session.replica.columns)
    session.advance_round()
    session.execute(chunks[1])
    session.query_batch(qchunks[1])
    session.resize_islands(1, placement="stacked")
    assert current_island_mesh() is prev and not session.mesh
    for r in range(2, N_ROUNDS):
        session.advance_round()
        session.execute(chunks[r])
        session.query_batch(qchunks[r])
    res = session.finish()
    assert current_island_mesh() is prev
    rt, rs, rq = tiny_ref
    rchunks, rqchunks = _ref_rounds(rs, rq)
    want = _drive(ref_session_mod.HTAPSession(
        _ref_spec("pallas", timing="timeline"), rt), rchunks, rqchunks,
        resize={0: (1, "mesh"), 1: (1, "stacked")})
    assert _meta(res) == _meta(want)


@pytest.mark.parametrize("delta", [False, True])
def test_resize_across_mesh_islands(tiny, ref_mesh, delta):
    """1 -> 4 mesh islands -> 2 -> 1 stacked, the mesh islands on
    ``["cpu"] * N``: every number the reference's pallas@N/mesh trip's."""
    table, stream, queries = tiny
    chunks, qchunks = _rounds(stream, queries)
    spec = _spec("hopper", timing="timeline", delta_store=delta)
    session = HTAPSession(spec, table, device=CPU)
    resident = []
    for r in range(N_ROUNDS):
        if r:
            session.advance_round()
        session.execute(chunks[r])
        session.query_batch(qchunks[r])
        if r < 3:
            n, pl = [(4, "mesh"), (2, "mesh"), (1, "stacked")][r]
            session.resize_islands(n, placement=pl,
                                   devices=[CPU] * n if pl == "mesh"
                                   else None)
            resident.append(len(session.cons._resident))
    res = session.finish()
    assert resident == [3, 3, 0]
    assert res.stats["views_resident"] > 0
    assert _meta(res) == ref_mesh[f"resize|{delta}"]


def test_resize_matches_golden_answers():
    """The golden-pinned Polynesia answers survive a 1 -> 4 -> 2 resize
    trip on tests/conftest.py's seed workload, and the trip's modeled
    numbers are the reference's."""
    golden = json.load(open(_REPO / "tests" / "golden_answers.json")
                       )["results"]["Polynesia"]

    def wl(mod, eng):
        rng = np.random.default_rng(0)
        sch = mod.make_schema("t", 4, 32)
        table = mod.gen_table(rng, sch, 4000)
        stream = mod.gen_update_stream(rng, sch, 4000, 8000,
                                       write_ratio=0.5)
        return table, stream, eng.gen_queries(rng, 12, 4)

    table, stream, queries = wl(schema, engine)
    chunks, qchunks = _rounds(stream, queries, n_rounds=8)
    spec = resolve_spec("Polynesia", n_shards=1, timing="timeline")
    res = _drive(HTAPSession(spec, table, device=CPU), chunks, qchunks,
                 resize={1: 4, 4: 2})
    assert res.results == golden
    rt, rs, rq = wl(ref_schema, ref_engine)
    rchunks, rqchunks = _ref_rounds(rs, rq, n_rounds=8)
    want = _drive(ref_session_mod.HTAPSession(
        _ref_spec(timing="timeline"), rt), rchunks, rqchunks,
        resize={1: 4, 4: 2})
    assert _meta(res) == _meta(want)


def test_resize_guards(tiny):
    table, stream, queries = tiny
    chunks, qchunks = _rounds(stream, queries)
    session = HTAPSession(_spec(), table, device=CPU)
    session.execute(chunks[0])
    with pytest.raises(ValueError, match="n_islands"):
        session.resize_islands(0)
    # same count + placement: explicit no-op, no reshard node emitted
    assert session.resize_islands(1) is None
    assert session.resizes == []
    session.finish()
    with pytest.raises(SessionClosedError):
        session.resize_islands(2)
    # non-MI kinds have no analytical islands to repartition
    si = HTAPSession(resolve_spec("SI-SS", backend="torch"), table,
                     device=CPU)
    with pytest.raises(ValueError, match="multi"):
        si.resize_islands(2)
    si.finish()
    # ad-hoc backend instances cannot be re-resolved by registered name
    adhoc = HTAPSession(SystemSpec.polynesia(backend=TorchBackend(CPU)),
                        table, device=CPU)
    with pytest.raises(ValueError, match="registered"):
        adhoc.resize_islands(2)
    adhoc.finish()


@pytest.mark.parametrize("case", ["other_device", "stacked_devices",
                                  "torch_mesh", "pinned", "too_few"])
def test_resize_refuses_before_any_state_moves(tiny, case):
    """A resize the port cannot make raises before the backlog flushes or
    the backend changes: the replica stays on the session's device (a mesh
    target's island 0 must be it), a stacked target takes no device list,
    only the kernel backend drives the mesh, no pinned handle may be in
    flight, and a mesh needs a device per island."""
    table, stream, queries = tiny
    chunks, _ = _rounds(stream, queries)
    prev = current_island_mesh()
    session = HTAPSession(_spec("torch" if case == "torch_mesh"
                                else "hopper"), table, device=CPU)
    session.execute(chunks[0])
    pending, be = session.store.pending_updates, session.be
    err, kw = {
        "other_device": (ValueError, dict(n_islands=2, placement="mesh",
                                          devices=["meta", CPU])),
        "stacked_devices": (ValueError, dict(n_islands=2,
                                             devices=[CPU] * 2)),
        "torch_mesh": (ValueError, dict(n_islands=2, placement="mesh",
                                        devices=[CPU] * 2)),
        "pinned": (RuntimeError, dict(n_islands=2)),
        "too_few": (ValueError, dict(n_islands=4, placement="mesh",
                                     devices=[CPU] * 3)),
    }[case]
    if case == "pinned":
        session.cons.begin_query([0])
    with pytest.raises(err):
        session.resize_islands(**kw)
    assert session.store.pending_updates == pending
    assert session.be is be and session.resizes == []
    assert current_island_mesh() is prev
    session.abort()


# ---------------------------------------------------------------------------
# checkpoint / restore
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["torch", "hopper"])
def test_checkpoint_restore_continues_bit_identically(tiny, tiny_ref,
                                                      tmp_path, backend):
    """Same-spec restore: answers AND modeled numbers equal the
    uninterrupted session's; both runs, counters too, the reference's."""
    table, stream, queries = tiny
    chunks, qchunks = _rounds(stream, queries)
    spec = _spec(backend, timing="timeline", async_propagation=True)
    ref = _two_rounds(HTAPSession(spec, table, device=CPU), chunks, qchunks)
    cut = _two_rounds(HTAPSession(spec, table, device=CPU), chunks, qchunks)
    step = cut.checkpoint(str(tmp_path / "p"))
    assert latest_step(str(tmp_path / "p")) == step == 1
    restored = HTAPSession.restore(str(tmp_path / "p"), device=CPU)
    a = _drive(ref, chunks, qchunks, start=2)
    b = _drive(restored, chunks, qchunks, start=2)
    assert _modeled(b) == _modeled(a)
    assert b.stats["timeline"] == a.stats["timeline"]
    assert b.stats["latency"] == a.stats["latency"]
    # the interrupted original keeps running too (checkpoint is a pure read)
    cut.finish()
    rt, rs, rq = tiny_ref
    rchunks, rqchunks = _ref_rounds(rs, rq)
    rspec = _ref_spec(timing="timeline", async_propagation=True)
    want = [_two_rounds(ref_session_mod.HTAPSession(rspec, rt), rchunks,
                        rqchunks) for _ in range(2)]
    want[1].checkpoint(str(tmp_path / "r"))
    want[1] = ref_session_mod.HTAPSession.restore(str(tmp_path / "r"))
    want = [_drive(w, rchunks, rqchunks, start=2) for w in want]
    assert [_meta(a), _meta(b)] == [_meta(w) for w in want]


@pytest.mark.parametrize("target", ["hopper", "torch@4", "hopper@2",
                                    "hopper@2/mesh"])
def test_restore_onto_different_target(tiny, tiny_ref, tmp_path, target):
    """Elastic restart: a checkpoint taken on torch@1 restores onto a
    different backend / island count / placement and replays to the
    reference's answers."""
    table, stream, queries = tiny
    chunks, qchunks = _rounds(stream, queries)
    spec = _spec(timing="timeline")
    ref = HTAPSession(spec, table, device=CPU)
    cut = HTAPSession(spec, table, device=CPU)
    for s in (ref, cut):
        s.execute(chunks[0])
        s.query_batch(qchunks[0])
    cut.checkpoint(str(tmp_path), step=1)
    devices = [CPU] * 2 if target.endswith("mesh") else None
    restored = HTAPSession.restore(
        str(tmp_path), spec=SystemSpec.polynesia(backend=target,
                                                 timing="timeline"),
        device=None if devices else CPU, devices=devices)
    assert restored.be.name == target and restored.device.type == CPU
    a = _drive(ref, chunks, qchunks, start=1)
    b = _drive(restored, chunks, qchunks, start=1)
    assert b.results == a.results
    cut.finish()
    rt, rs, rq = tiny_ref
    want = _drive(ref_session_mod.HTAPSession(_ref_spec(timing="timeline"),
                                              rt), *_ref_rounds(rs, rq))
    assert b.results == [int(x) for x in want.results]


def test_checkpoint_preserves_pending_backlog(tiny, tmp_path):
    """The executed-but-unshipped update backlog survives the round trip:
    checkpoint right after execute (before any query flushes), restore,
    and the restored session's queries see every executed update."""
    table, stream, queries = tiny
    chunks, qchunks = _rounds(stream, queries)
    s = HTAPSession(_spec(timing="timeline"), table, device=CPU)
    s.execute(chunks[0])
    assert s.store.pending_updates > 0
    s.checkpoint(str(tmp_path), step=0)
    restored = HTAPSession.restore(str(tmp_path), device=CPU)
    assert restored.store.pending_updates == s.store.pending_updates
    assert restored.query_batch(qchunks[0]) == s.query_batch(qchunks[0])
    s.finish()
    restored.finish()


def test_delta_checkpoint_refuses_eager_target(tiny, tmp_path):
    table, stream, queries = tiny
    chunks, qchunks = _rounds(stream, queries)
    spec = _spec(timing="timeline", delta_store=True)
    s = HTAPSession(spec, table, device=CPU)
    s.execute(chunks[0])
    s.query_batch(qchunks[0])
    assert sum(d.n_overlay for d in s._deltas.values()) > 0
    s.checkpoint(str(tmp_path))
    with pytest.raises(ValueError, match="delta-overlay"):
        HTAPSession.restore(str(tmp_path), spec=_spec(
            timing="timeline", delta_store=False), device=CPU)
    # the delta-plane target works and continues bit-identically
    restored = HTAPSession.restore(str(tmp_path), device=CPU)
    a = _drive(s, chunks, qchunks, start=1)
    b = _drive(restored, chunks, qchunks, start=1)
    assert _modeled(b) == _modeled(a)


def test_failed_mesh_restore_releases_its_devices(tiny, tmp_path,
                                                  monkeypatch):
    """A restore onto an eager target is refused before a session is
    built; one that fails after building its session closes it, so the
    island devices it installed are released."""
    table, stream, queries = tiny
    chunks, qchunks = _rounds(stream, queries)
    s = HTAPSession(_spec("hopper", delta_store=True), table, device=CPU)
    s.execute(chunks[0])
    s.query_batch(qchunks[0])
    s.checkpoint(str(tmp_path))
    s.finish()
    prev = current_island_mesh()
    built = []
    real_init = HTAPSession.__init__

    def init(self, *a, **kw):
        built.append(self)
        real_init(self, *a, **kw)

    monkeypatch.setattr(HTAPSession, "__init__", init)
    mesh = SystemSpec.polynesia(backend="hopper@2/mesh")
    with pytest.raises(ValueError, match="delta-overlay"):
        HTAPSession.restore(str(tmp_path), spec=mesh, devices=[CPU] * 2)
    assert built == [] and current_island_mesh() is prev

    def broken(*a):
        assert current_island_mesh() == (torch.device(CPU),) * 2
        raise RuntimeError("torn checkpoint")

    monkeypatch.setattr(elastic, "_restore_state", broken)
    with pytest.raises(RuntimeError, match="torn"):
        HTAPSession.restore(str(tmp_path), spec=mesh.replace(
            delta_store=True), devices=[CPU] * 2)
    assert len(built) == 1 and built[0]._finished
    assert current_island_mesh() is prev


def test_restore_requires_committed_checkpoint(tmp_path):
    with pytest.raises(FileNotFoundError):
        HTAPSession.restore(str(tmp_path), device=CPU)


def test_reference_checkpoint_restores_in_the_port(tiny, tiny_ref,
                                                   tmp_path):
    """A checkpoint the reference wrote mid-round - live delta overlays,
    an unshipped backlog, the cost log's tags - restored in the port with
    a port spec continues to the reference's uninterrupted answers and
    modeled numbers. Without a spec its backend name is refused."""
    table, stream, queries = tiny
    chunks, qchunks = _rounds(stream, queries)
    rt, rs, rq = tiny_ref
    rchunks, rqchunks = _ref_rounds(rs, rq)
    rspec = _ref_spec(timing="timeline", delta_store=True)
    ref = ref_session_mod.HTAPSession(rspec, rt)
    ref.execute(rchunks[0])
    ref.query_batch(rqchunks[0])
    ref.advance_round()
    ref.execute(rchunks[1])
    assert ref.store.pending_updates > 0
    assert sum(d.n_overlay for d in ref._deltas.values()) > 0
    ref.checkpoint(str(tmp_path))
    with pytest.raises(KeyError, match="unknown backend"):
        HTAPSession.restore(str(tmp_path), device=CPU)
    port = HTAPSession.restore(str(tmp_path), spec=_spec(
        "hopper", timing="timeline", delta_store=True), device=CPU)
    assert port.store.pending_updates == ref.store.pending_updates
    got = port.query_batch(qchunks[1])
    assert got == [int(x) for x in ref.query_batch(rqchunks[1])]
    port.advance_round()
    ref.advance_round()
    a = _drive(port, chunks, qchunks, start=2)
    b = _drive(ref, rchunks, rqchunks, start=2)
    assert _modeled(a) == _modeled(b)


def test_port_checkpoint_restores_in_the_reference(tiny, tiny_ref,
                                                   tmp_path):
    """And the other way: the port's checkpoint, restored by the
    reference with a reference spec, continues to the port's
    uninterrupted answers and modeled numbers."""
    table, stream, queries = tiny
    chunks, qchunks = _rounds(stream, queries)
    spec = _spec("hopper", timing="timeline", delta_store=True)
    s = _two_rounds(HTAPSession(spec, table, device=CPU), chunks, qchunks)
    s.advance_round()
    s.execute(chunks[2])
    assert s.store.pending_updates > 0
    assert sum(d.n_overlay for d in s._deltas.values()) > 0
    s.checkpoint(str(tmp_path), step=2)
    rt, rs, rq = tiny_ref
    rchunks, rqchunks = _ref_rounds(rs, rq)
    ref = ref_session_mod.HTAPSession.restore(str(tmp_path), spec=_ref_spec(
        timing="timeline", delta_store=True))
    assert s.query_batch(qchunks[2]) == [
        int(x) for x in ref.query_batch(rqchunks[2])]
    s.advance_round()
    ref.advance_round()
    a = _drive(s, chunks, qchunks, start=3)
    b = _drive(ref, rchunks, rqchunks, start=3)
    assert _modeled(a) == _modeled(b)


# ---------------------------------------------------------------------------
# crash-recovery replay
# ---------------------------------------------------------------------------

def _ref_recovery(tiny_ref, tmp, **kw):
    rt, rs, rq = tiny_ref
    return ref_elastic.run_with_recovery(
        _ref_spec(timing="timeline"), rt, rs, rq, N_ROUNDS, str(tmp), **kw)


def test_crash_recovery_replays_to_same_answers(tiny, tiny_ref, tmp_path):
    table, stream, queries = tiny
    spec = _spec(timing="timeline")
    base = _drive(HTAPSession(spec, table, device=CPU),
                  *_rounds(stream, queries))
    res, recovered = elastic.run_with_recovery(
        spec, table, stream, queries, N_ROUNDS, str(tmp_path / "p"),
        crash_after_ships=2, device=CPU)
    assert recovered and res.results == base.results
    want, ref_recovered = _ref_recovery(tiny_ref, tmp_path / "r",
                                        crash_after_ships=2)
    assert ref_recovered and _meta(res) == _meta(want)


def test_crash_before_first_commit_cold_restarts(tiny, tiny_ref, tmp_path):
    """crash_after_ships=0 dies before anything is checkpointed: recovery
    degenerates to a clean cold restart from round 0."""
    table, stream, queries = tiny
    spec = _spec(timing="timeline")
    res, recovered = elastic.run_with_recovery(
        spec, table, stream, queries, N_ROUNDS, str(tmp_path / "p"),
        crash_after_ships=0, device=CPU)
    assert recovered
    assert latest_step(str(tmp_path / "p")) is None
    want, _ = _ref_recovery(tiny_ref, tmp_path / "r", crash_after_ships=0)
    assert _meta(res) == _meta(want)


def test_crash_recovery_onto_resized_target(tiny, tiny_ref, tmp_path):
    """The elastic restart: crash on 1 island, recover onto 4."""
    table, stream, queries = tiny
    res, recovered = elastic.run_with_recovery(
        _spec(timing="timeline"), table, stream, queries, N_ROUNDS,
        str(tmp_path / "p"), crash_after_ships=3, device=CPU,
        restore_spec=_spec(n=4, timing="timeline"))
    assert recovered
    want, _ = _ref_recovery(
        tiny_ref, tmp_path / "r", crash_after_ships=3,
        restore_spec=_ref_spec(n=4, timing="timeline"))
    assert _meta(res) == _meta(want)
    assert res.stats["islands"] == 4


def test_crash_recovery_onto_mesh_islands(tiny, ref_mesh, tmp_path):
    """Crash on 1 island, recover onto 4 mesh islands on ``["cpu"] * 4``:
    the reference's pallas@4/mesh recovery, number for number."""
    table, stream, queries = tiny
    prev = current_island_mesh()
    res, recovered = elastic.run_with_recovery(
        _spec(timing="timeline"), table, stream, queries, N_ROUNDS,
        str(tmp_path), crash_after_ships=3, device=CPU,
        restore_spec=SystemSpec.polynesia(backend="hopper@4/mesh",
                                          timing="timeline"),
        restore_devices=[CPU] * 4)
    want = dict(ref_mesh["crash"])
    assert recovered is want.pop("recovered") is True
    assert _meta(res) == want
    assert current_island_mesh() is prev


def test_crash_hook_is_set_by_the_caller(tiny, monkeypatch):
    """The limit is the session's attribute (no environment variable arms
    it): at 0 the first ship batch raises SessionCrash; abort closes."""
    table, stream, queries = tiny
    monkeypatch.setenv("REPRO_CRASH_AFTER", "0")
    session = HTAPSession(_spec(), table, device=CPU)
    assert session.crash_after_ships is None
    session.crash_after_ships = 0
    with pytest.raises(elastic.SessionCrash):
        session.execute(stream)
        session.query_batch(list(queries))
    session.abort()
    with pytest.raises(SessionClosedError):
        session.query_batch(list(queries))
    session.abort()  # idempotent


def test_abort_releases_mesh_context(tiny):
    table, _, _ = tiny
    prev = current_island_mesh()
    session = HTAPSession(SystemSpec.polynesia(backend="hopper@1/mesh"),
                          table, devices=[CPU])
    assert current_island_mesh() == session.be.devices
    session.abort()
    assert current_island_mesh() is prev


# ---------------------------------------------------------------------------
# closed-session error matrix
# ---------------------------------------------------------------------------

CLOSED_CALLS = {
    "execute": lambda s, st, q, d: s.execute(st),
    "query": lambda s, st, q, d: s.query(q[0]),
    "query_batch": lambda s, st, q, d: s.query_batch(list(q)),
    "advance_round": lambda s, st, q, d: s.advance_round(),
    "flush_updates": lambda s, st, q, d: s.flush_updates(),
    "finish": lambda s, st, q, d: s.finish(),
    "checkpoint": lambda s, st, q, d: s.checkpoint(d),
    "resize_islands": lambda s, st, q, d: s.resize_islands(2),
}


@pytest.mark.parametrize("call", list(CLOSED_CALLS))
def test_session_closed_error_matrix(tiny, tmp_path, call):
    """Every post-close surface raises SessionClosedError (a RuntimeError
    subclass, so pre-existing `except RuntimeError` guards still work)."""
    table, stream, queries = tiny
    session = HTAPSession(_spec(), table, device=CPU)
    session.execute(stream)
    session.finish()
    assert issubclass(SessionClosedError, RuntimeError)
    with pytest.raises(SessionClosedError, match="finished"):
        CLOSED_CALLS[call](session, stream, queries, str(tmp_path))
    # abort after finish is a no-op, not an error
    session.abort()


# ---------------------------------------------------------------------------
# benchmarks/fig_elastic.py's three runs, at a small size
# ---------------------------------------------------------------------------

def test_fig_elastic_runs_match_reference(monkeypatch):
    """static@1, elastic 1->4 (after round 0) and static@4: equal answers,
    the reference's modeled analytical throughputs, the elastic run
    between the two static ones, and its post-resize rounds faster."""
    sys.path.insert(0, str(_REPO))
    from benchmarks import fig_elastic
    for name, value in (("N_ROWS", 2000), ("N_TXN", 4000),
                        ("N_QUERIES", 12)):
        monkeypatch.setattr(fig_elastic, name, value)
    rt, rs, rq = fig_elastic._workload()
    n = fig_elastic.N_ROUNDS
    rchunks, rqchunks = _ref_rounds(rs, rq, n)
    want = {k: fig_elastic._drive(rt, rchunks, rqchunks, *a)
            for k, a in (("1", (1,)), ("4", (4,)), ("el", (1, 4)))}

    rng = np.random.default_rng(0)
    sch = schema.make_schema("t", fig_elastic.N_COLS, 32)
    table = schema.gen_table(rng, sch, fig_elastic.N_ROWS)
    stream = schema.gen_update_stream(rng, sch, fig_elastic.N_ROWS,
                                      fig_elastic.N_TXN, write_ratio=0.5)
    queries = engine.gen_queries(rng, fig_elastic.N_QUERIES,
                                 fig_elastic.N_COLS)
    chunks, qchunks = _rounds(stream, queries, n)
    got = {}
    for key, n_shards, resize_to in (("1", 1, None), ("4", 4, None),
                                     ("el", 1, 4)):
        session = HTAPSession(_spec(n=n_shards, timing="timeline"), table,
                              device=CPU)
        res = _drive(session, chunks, qchunks,
                     resize={fig_elastic.RESIZE_AFTER_ROUND: resize_to}
                     if resize_to else None)
        got[key] = (session, res)
    for key, (session, res) in got.items():
        assert _meta(res) == _meta(want[key][1])
        assert res.ana_throughput == want[key][1].ana_throughput
    qps = {k: got[k][1].ana_throughput for k in got}
    assert got["el"][1].results == got["1"][1].results == got["4"][1].results
    assert qps["1"] <= qps["el"] <= qps["4"]

    def segments(session):
        tl = simulate_timeline(session.cost, HardwareModel(session.hw))
        seg = {"pre": [0, 0.0], "post": [0, 0.0]}
        for node in tl.nodes:
            if node.tag.kind != "ana":
                continue
            key = ("post" if node.tag.round > fig_elastic.RESIZE_AFTER_ROUND
                   else "pre")
            seg[key][0] += int(node.tag.meta.get("n", 1))
            seg[key][1] += node.seconds
        return {k: q / s for k, (q, s) in seg.items() if s > 0}

    seg = segments(got["el"][0])
    assert seg == fig_elastic._segment_qps(want["el"][0])
    assert seg["post"] > seg["pre"]
