"""The port's timeline timing model (`core/timeline.py`, `htap._price`'s
timeline branch, async propagation) against the JAX package's, on the
same seeded inputs.

Mirrors tests/test_timeline.py. Every `RunResult` field - answers, modeled
txn and ana seconds, energy, freshness - and every stats key both report
(``stats["timeline"]`` and ``stats["latency"]`` among them) must equal the
reference's for timing in {phase, timeline} x async propagation:

* every preset on one island and on ``hopper@4`` against ``pallas@4``;
* ``hopper@4/mesh`` on ``["cpu"] * 4`` against ``pallas@4/mesh``, run in
  one module-scoped subprocess with four emulated host devices, as
  tests/test_torch_mesh.py runs it;
* the delta store on one island, ``hopper@4`` and ``hopper@4/mesh`` (the
  folded join group and the mesh correction slice price as the
  reference's compositions).

Then the replay itself on the reference's own cost logs, the commit
clock's monotonicity, duplicate nodes, partly tagged logs, the
async-requires-timeline error, and the overlap and freshness contracts.
The timeline is plain float arithmetic over the same events: tolerance 0.
"""

import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro.core import htap as ref_htap
from repro.core import session as ref_session_mod
from repro.core import timeline as ref_timeline
from repro_torch.core import engine, htap, schema
from repro_torch.core import session as session_mod
from repro_torch.core.hwmodel import (CostEvent, CostLog, HardwareModel,
                                      HardwareParams, HMC_PARAMS,
                                      TimelineTag)
from repro_torch.core.timeline import (TIMINGS, _CommitClock,
                                       query_latencies, resolve_timing,
                                       simulate_timeline)

torch.set_num_threads(1)
_REPO = pathlib.Path(__file__).parent.parent

ROWS, COLS, TXNS, QUERIES = 4000, 4, 8000, 12      # tests/conftest.py sizes
N_ROUNDS = 4
PRESETS = list(ref_htap.ALL_PRESETS)
MI = ["Polynesia", "MI+SW", "MI+SW+HB", "PIM-Only"]
TIMING_CASES = [("phase", False), ("timeline", False), ("timeline", True)]
TIMING_IDS = ["phase", "timeline", "async"]


def _workload(mod, eng, delete_frac=0.0):
    """The conftest workload; the delta runs turn a fraction of the writes
    into deletes so the overlays carry invalid rows."""
    rng = np.random.default_rng(0)
    sch = mod.make_schema("t", COLS, 32)
    table = mod.gen_table(rng, sch, ROWS)
    stream = mod.gen_update_stream(rng, sch, ROWS, TXNS, write_ratio=0.5)
    qs = eng.gen_queries(rng, QUERIES, COLS)
    if delete_frac:
        dels = (stream.op == 1) & (rng.random(len(stream)) < delete_frac)
        stream.op[dels] = 3
    return table, stream, qs


@pytest.fixture(scope="module")
def workload():
    return _workload(schema, engine)


def _ref_run(name, n, timing, asy, delta=None, cap=None, delete_frac=0.0):
    from repro.core import engine as ref_engine
    from repro.core import schema as ref_schema
    table, stream, queries = _workload(ref_schema, ref_engine, delete_frac)
    return ref_htap.run(name, table, stream, queries, n_rounds=N_ROUNDS,
                        backend="pallas", n_shards=n, placement="stacked",
                        timing=timing, async_propagation=asy,
                        delta_store=(delta if name in ref_htap.PRESETS
                                     else None),
                        delta_capacity=cap)


def _meta(res) -> dict:
    """A RunResult as plain data (the reference's jit-trace ledger and the
    port's launch counters left out: they are each package's own)."""
    return dict(name=res.name, results=[int(a) for a in res.results],
                n_txn=res.n_txn, n_ana=res.n_ana,
                txn_seconds=res.txn_seconds, ana_seconds=res.ana_seconds,
                energy_joules=res.energy_joules,
                freshness_seconds=res.freshness_seconds,
                stats={k: v for k, v in res.stats.items()
                       if k not in ("traces", "kernel_launches")})


def _check(got, want: dict, timing: str) -> None:
    assert _meta(got) == want
    if timing == "timeline":
        assert "timeline" in got.stats and "accel_seconds" not in got.stats
    else:
        assert got.freshness_seconds is None
        assert "timeline" not in got.stats and "latency" not in got.stats


# ---------------------------------------------------------------------------
# every preset, one island and hopper@4, under every timing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("timing,asy", TIMING_CASES, ids=TIMING_IDS)
@pytest.mark.parametrize("n", [1, 4])
@pytest.mark.parametrize("name", PRESETS)
def test_presets_match_reference_timing(workload, name, n, timing, asy):
    table, stream, queries = workload
    got = htap.run(name, table, stream, queries, n_rounds=N_ROUNDS,
                   backend=f"hopper@{n}", device="cpu", timing=timing,
                   async_propagation=asy)
    _check(got, _meta(_ref_run(name, n, timing, asy, delta=False)), timing)
    if timing == "timeline" and name in MI:
        f = got.freshness_seconds
        assert f["n_batches"] > 0 and f["max"] >= f["mean"] > 0.0
        assert got.stats["latency"]["n_queries"] == QUERIES
        assert got.stats["timeline"]["async"] is asy


@pytest.mark.parametrize("timing,asy", TIMING_CASES, ids=TIMING_IDS)
@pytest.mark.parametrize("cap", [64, None], ids=["cap64", "default"])
@pytest.mark.parametrize("n", [1, 4])
def test_delta_store_matches_reference_timing(n, cap, timing, asy):
    """The delta plane on one island and stacked hopper@4 (its join group
    one launch, the reference's three): compaction nodes take part in
    freshness, and every modeled number equals the reference's."""
    table, stream, queries = _workload(schema, engine, delete_frac=0.05)
    got = htap.run("Polynesia", table, stream, queries, n_rounds=N_ROUNDS,
                   backend=f"hopper@{n}", device="cpu", timing=timing,
                   async_propagation=asy, delta_store=True,
                   delta_capacity=cap)
    want = _ref_run("Polynesia", n, timing, asy, delta=True, cap=cap,
                    delete_frac=0.05)
    _check(got, _meta(want), timing)
    assert got.stats["delta_appends"] > 0
    if cap == 64:
        assert got.stats["compactions"] > 0


# ---------------------------------------------------------------------------
# hopper@4/mesh against pallas@4/mesh (four emulated host devices)
# ---------------------------------------------------------------------------

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


    def run(name, cap, timing, asy):
        delta = cap != "eager"
        table, stream, qs = workload(0.05 if delta else 0.0)
        res = htap.run(name, table, stream, qs, n_rounds={rounds},
                       backend="pallas@4/mesh", timing=timing,
                       async_propagation=asy, delta_store=delta,
                       delta_capacity=None if cap in ("eager", "default")
                       else int(cap))
        return dict(name=res.name, results=[int(a) for a in res.results],
                    n_txn=res.n_txn, n_ana=res.n_ana,
                    txn_seconds=res.txn_seconds, ana_seconds=res.ana_seconds,
                    energy_joules=res.energy_joules,
                    freshness_seconds=res.freshness_seconds,
                    stats={{k: v for k, v in res.stats.items()
                           if k != "traces"}})


    if __name__ == "__main__":
        out = {{}}
        for key in sys.argv[2:]:
            name, cap, timing, asy = key.split("|")
            out[key] = run(name, cap, timing, asy == "async")
        with open(sys.argv[1], "w") as f:
            json.dump(out, f)
""").format(cols=COLS, rows=ROWS, txns=TXNS, queries=QUERIES,
            rounds=N_ROUNDS)

MESH_TIMINGS = [("timeline", False), ("timeline", True)]
MESH_IDS = ["timeline", "async"]
_KEYS = ([f"{name}|eager|{t}|{'async' if a else 'sync'}"
          for name in MI for t, a in MESH_TIMINGS]
         + [f"Polynesia|{cap}|{t}|{'async' if a else 'sync'}"
            for cap in ("64", "default") for t, a in MESH_TIMINGS])


@pytest.fixture(scope="module")
def ref_mesh(tmp_path_factory):
    """{key: RunResult data} of the reference's pallas@4/mesh runs."""
    out = tmp_path_factory.mktemp("ref_mesh_timeline")
    prog = out / "ref_mesh_timeline.py"
    prog.write_text(_PROG)
    env = {**os.environ, "PYTHONPATH": str(_REPO / "src"),
           "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    for var in ("REPRO_DELTA", "REPRO_DELTA_CAPACITY", "REPRO_BACKEND",
                "REPRO_SHARDS", "REPRO_PLACEMENT", "REPRO_TIMING"):
        env.pop(var, None)
    proc = subprocess.run([sys.executable, str(prog), str(out / "r.json"),
                           *_KEYS], cwd=_REPO, capture_output=True,
                          text=True, timeout=600, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    # JSON turns the lane dicts' keys into strings already (they are), and
    # tuples into lists; the port's data goes through the same round trip
    return json.loads((out / "r.json").read_text())


def _json(meta: dict) -> dict:
    return json.loads(json.dumps(meta))


@pytest.mark.parametrize("timing,asy", MESH_TIMINGS, ids=MESH_IDS)
@pytest.mark.parametrize("name", MI)
def test_mesh_matches_reference_timing(ref_mesh, name, timing, asy):
    """Each node keeps the session's island count in its meta, so the
    replay prices the mesh's nodes as the reference's (which installs a
    process-global mesh; the port does not)."""
    table, stream, queries = _workload(schema, engine)
    got = htap.run(name, table, stream, queries, n_rounds=N_ROUNDS,
                   backend="hopper@4/mesh", devices=["cpu"] * 4,
                   timing=timing, async_propagation=asy)
    key = f"{name}|eager|{timing}|{'async' if asy else 'sync'}"
    assert _json(_meta(got)) == ref_mesh[key]
    assert got.stats["placement"] == "mesh" and got.stats["islands"] == 4


@pytest.mark.parametrize("timing,asy", MESH_TIMINGS, ids=MESH_IDS)
@pytest.mark.parametrize("cap", ["64", "default"])
def test_mesh_delta_store_matches_reference_timing(ref_mesh, cap, timing,
                                                   asy):
    table, stream, queries = _workload(schema, engine, delete_frac=0.05)
    got = htap.run("Polynesia", table, stream, queries, n_rounds=N_ROUNDS,
                   backend="hopper@4/mesh", devices=["cpu"] * 4,
                   timing=timing, async_propagation=asy, delta_store=True,
                   delta_capacity=None if cap == "default" else int(cap))
    key = f"Polynesia|{cap}|{timing}|{'async' if asy else 'sync'}"
    assert _json(_meta(got)) == ref_mesh[key]


# ---------------------------------------------------------------------------
# the replay itself, on the reference's own cost logs
# ---------------------------------------------------------------------------

def _port_log(ref_log) -> CostLog:
    """The reference's CostLog as the port's: the same events and tags."""
    log = CostLog()
    log.events = [CostEvent(**dataclasses.asdict(e)) for e in ref_log.events]
    log.tags = {node: TimelineTag(node=t.node, kind=t.kind, round=t.round,
                                  seq=t.seq, deps=t.deps,
                                  sync_deps=t.sync_deps, meta=dict(t.meta))
                for node, t in ref_log.tags.items()}
    return log


def _ref_session_log(name, **kw):
    from repro.core import engine as ref_engine
    from repro.core import schema as ref_schema
    table, stream, queries = _workload(ref_schema, ref_engine, 0.05)
    made = []

    class Kept(ref_htap.HTAPSession):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_htap, "HTAPSession", Kept)
        ref_htap.run(name, table, stream, queries, n_rounds=N_ROUNDS,
                     backend="pallas", placement="stacked", **kw)
    [session] = made
    return session.cost, session.hw


@pytest.mark.parametrize("concurrent", [True, False])
@pytest.mark.parametrize("asy", [False, True])
@pytest.mark.parametrize("name,kw", [
    ("Polynesia", dict(n_shards=4, delta_store=True, delta_capacity=64)),
    ("MI+SW", dict(n_shards=1, delta_store=False)),
    ("SI-SS", dict(n_shards=1)),
    ("SI-MVCC", dict(n_shards=1))])
def test_replay_of_the_reference_log_is_the_reference_schedule(name, kw, asy,
                                                               concurrent):
    """The port's simulate_timeline on the reference's own tagged log
    schedules every node on the same lane at the same start and finish."""
    ref_log, hw = _ref_session_log(name, timing="timeline", **kw)
    want = ref_timeline.simulate_timeline(
        ref_log, ref_htap.HardwareModel(hw), async_propagation=asy,
        concurrent_islands=concurrent)
    got = simulate_timeline(_port_log(ref_log),
                            HardwareModel(HardwareParams(
                                **dataclasses.asdict(hw))),
                            async_propagation=asy,
                            concurrent_islands=concurrent)
    assert (got.makespan, got.lane_finish, got.lane_busy, got.freshness,
            got.utilization) == (want.makespan, want.lane_finish,
                                 want.lane_busy, want.freshness,
                                 want.utilization)
    assert [(n.tag.node, n.lane, n.seconds, n.start, n.finish)
            for n in got.nodes] == [(n.tag.node, n.lane, n.seconds, n.start,
                                     n.finish) for n in want.nodes]
    assert query_latencies(got) == ref_timeline.query_latencies(want)


def test_the_sessions_tag_graph_is_the_references(workload):
    """Node names, kinds, deps, sync deps and meta in emission order: the
    replay prices tags in seq order, so they must be the reference's."""
    from repro.core import engine as ref_engine
    from repro.core import schema as ref_schema
    table, stream, queries = _workload(schema, engine, 0.05)
    sess = session_mod.HTAPSession(session_mod.SystemSpec.polynesia(
        backend="hopper@4", delta_store=True, delta_capacity=64,
        timing="timeline"), table, device="cpu")
    rt, rs_, rq = _workload(ref_schema, ref_engine, 0.05)
    ref = ref_session_mod.HTAPSession(ref_session_mod.SystemSpec.polynesia(
        backend="pallas", n_shards=4, placement="stacked", delta_store=True,
        delta_capacity=64, timing="timeline"), rt)
    from repro_torch.core.workload import split_queries, split_stream
    from repro.core.workload import (split_queries as rsplit_q,
                                     split_stream as rsplit_s)
    for r, (c, q, rc, rqq) in enumerate(zip(
            split_stream(stream, N_ROUNDS), split_queries(queries, N_ROUNDS),
            rsplit_s(rs_, N_ROUNDS), rsplit_q(rq, N_ROUNDS))):
        if r:
            sess.advance_round()
            ref.advance_round()
        sess.execute(c)
        ref.execute(rc)
        sess.query_batch(q)
        ref.query_batch(rqq)

    def graph(log):
        return [(t.node, t.kind, t.round, t.deps, t.sync_deps, t.meta)
                for t in sorted(log.tags.values(), key=lambda t: t.seq)]
    assert graph(sess.cost) == graph(ref.cost)
    assert [dataclasses.asdict(e) for e in sess.cost.events] == \
        [dataclasses.asdict(e) for e in ref.cost.events]
    assert any(t.kind == "compact" for t in sess.cost.tags.values())
    sess.finish()
    ref.finish()


# ---------------------------------------------------------------------------
# timing selection and guard rails
# ---------------------------------------------------------------------------

def test_resolve_timing_has_no_process_default(monkeypatch):
    """None is "phase" whatever the environment says (the reference reads
    REPRO_TIMING and a process-wide default; the port has neither)."""
    assert TIMINGS == ref_timeline.TIMINGS
    assert resolve_timing("phase") == "phase"
    assert resolve_timing("timeline") == "timeline"
    monkeypatch.setenv("REPRO_TIMING", "timeline")
    assert resolve_timing(None) == "phase"
    with pytest.raises(ValueError, match="unknown timing"):
        resolve_timing("bogus")
    assert not hasattr(htap, "set_default_timing")
    from repro_torch.core import timeline
    assert not hasattr(timeline, "set_default_timing")


def test_async_requires_timeline(workload):
    table, stream, queries = workload
    with pytest.raises(ValueError, match="timeline"):
        htap.run("Polynesia", table, stream, queries, device="cpu",
                 timing="phase", async_propagation=True)
    with pytest.raises(ValueError, match="timeline"):
        ref_htap.run("Polynesia", table, stream, queries, backend="numpy",
                     timing="phase", async_propagation=True)


def test_partially_tagged_log_rejected():
    cost = CostLog()
    with cost.tagged("r0:txn", "txn", round=0):
        cost.add(phase="txn", island="txn", resource="cpu", cycles=1e6)
    cost.add(phase="ana", island="ana", resource="cpu", cycles=1e6)  # untagged
    with pytest.raises(ValueError, match="untagged"):
        simulate_timeline(cost, HardwareModel(HMC_PARAMS))


def test_untagged_log_is_the_empty_schedule():
    cost = CostLog()
    cost.add(phase="ana", island="ana", resource="cpu", cycles=1e6)
    tl = simulate_timeline(cost, HardwareModel(HMC_PARAMS))
    assert (tl.makespan, tl.lane_finish, tl.freshness, tl.nodes) == \
        (0.0, {}, None, [])
    assert query_latencies(tl) == []


def test_duplicate_node_rejected():
    cost = CostLog()
    with cost.tagged("n0", "txn"):
        pass
    with pytest.raises(ValueError, match="duplicate"):
        with cost.tagged("n0", "txn"):
            pass


# ---------------------------------------------------------------------------
# commit clock: commit-id -> time map must be monotone for ANY span list
# ---------------------------------------------------------------------------

def _clocks(spans):
    """The port's and the reference's commit clock over the same spans."""
    from repro.core.hwmodel import TimelineTag as RefTag
    port, ref = _CommitClock(), ref_timeline._CommitClock()
    for i, (lo, hi, a, b) in enumerate(spans):
        meta = {"cid_lo": min(lo, hi), "cid_hi": max(lo, hi)}
        port.observe(TimelineTag(node=f"n{i}", kind="txn", meta=meta),
                     min(a, b), max(a, b))
        ref.observe(RefTag(node=f"n{i}", kind="txn", meta=meta),
                    min(a, b), max(a, b))
    return port, ref


def _clock_props(spans):
    port, ref = _clocks(spans)
    times = [port.time_of(c) for c in range(-5, 215)]
    assert times == [ref.time_of(c) for c in range(-5, 215)]
    assert all(t0 <= t1 for t0, t1 in zip(times, times[1:]))
    assert all(t >= 0.0 for t in times)


def test_commit_clock_seeded_sweep():
    for seed in range(30):
        rng = np.random.default_rng(seed)
        k = int(rng.integers(0, 9))
        spans = [(int(rng.integers(0, 200)), int(rng.integers(0, 200)),
                  float(rng.uniform(0, 1e3)), float(rng.uniform(0, 1e3)))
                 for _ in range(k)]
        _clock_props(spans)


def test_commit_clock_monotone_property():
    pytest.importorskip(
        "hypothesis",
        reason="property tests need hypothesis (pip install .[test])")
    from hypothesis import given, settings, strategies as st

    span = st.tuples(st.integers(0, 200), st.integers(0, 200),
                     st.floats(0.0, 1e3), st.floats(0.0, 1e3))

    @settings(max_examples=50, deadline=None)
    @given(spans=st.lists(span, min_size=0, max_size=8))
    def prop(spans):
        _clock_props(spans)

    prop()


# ---------------------------------------------------------------------------
# overlap + async-propagation contract (Polynesia)
# ---------------------------------------------------------------------------

def _poly(workload, **kw):
    table, stream, queries = workload
    return htap.run("Polynesia", table, stream, queries, device="cpu", **kw)


def test_timeline_total_le_phase_sum(workload):
    phase = _poly(workload, timing="phase")
    tl = _poly(workload, timing="timeline")
    phase_sum = (phase.txn_seconds + phase.ana_seconds
                 + phase.stats["accel_seconds"])
    makespan = tl.stats["timeline"]["makespan"]
    assert makespan <= phase_sum * (1 + 1e-9)
    assert makespan >= max(tl.stats["timeline"]["lane_busy"].values())


def test_async_beats_sync_txn_throughput(workload):
    sync = _poly(workload, timing="timeline")
    asy = _poly(workload, timing="timeline", async_propagation=True)
    assert asy.results == sync.results
    assert asy.energy_joules == sync.energy_joules
    assert asy.txn_throughput >= sync.txn_throughput
    assert (asy.stats["timeline"]["makespan"]
            <= sync.stats["timeline"]["makespan"] * (1 + 1e-9))


def test_freshness_grows_with_final_log_capacity(workload, monkeypatch):
    """Bigger final log -> fewer, larger ship batches -> staler data; each
    capacity's freshness equals the reference's at that capacity."""
    table, stream, queries = workload
    means = []
    answers = None
    for cap in (64, 256, 1024):
        monkeypatch.setattr(session_mod, "FINAL_LOG_CAPACITY", cap)
        monkeypatch.setattr(ref_session_mod, "FINAL_LOG_CAPACITY", cap)
        r = htap.run("Polynesia", table, stream, queries, device="cpu",
                     timing="timeline", async_propagation=True)
        ref = ref_htap.run("Polynesia", table, stream, queries,
                           backend="numpy", n_shards=1, delta_store=False,
                           timing="timeline", async_propagation=True)
        assert r.freshness_seconds == ref.freshness_seconds
        if answers is None:
            answers = r.results
        assert r.results == answers
        means.append(r.freshness_seconds["mean"])
    assert means[0] < means[1] < means[2]


def test_utilization_reported_per_lane(workload):
    r = _poly(workload, timing="timeline")
    util = r.stats["timeline"]["utilization"]
    assert set(util) >= {"txn", "ana", "accel"}
    for lane, u in util.items():
        assert 0.0 <= u <= 1.0 + 1e-9, lane


def test_query_latency_stats_reported(workload):
    r = _poly(workload, timing="timeline", async_propagation=True)
    lat = r.stats["latency"]
    assert lat["n_queries"] == QUERIES
    assert 0.0 <= lat["p50"] <= lat["p99"] <= lat["max"]
    assert 0.0 <= lat["mean"] <= lat["max"]
    assert "latency" not in _poly(workload, timing="phase").stats


def test_query_latencies_weight_fused_groups():
    log = CostLog()
    with log.tagged("r0:txn", "txn", round=0):
        log.add(phase="txn", island="txn", resource="cpu", cycles=1e6)
    with log.tagged("r0:snap0", "snapshot", round=0, deps=("r0:txn",)):
        log.add(phase="snapshot", island="ana", resource="copy",
                bytes_local=1e6)
    with log.tagged("r0:ana0", "ana", round=0, deps=("r0:snap0",), n=3):
        log.add(phase="ana", island="ana", resource="pim", cycles=1e6)
    tl = simulate_timeline(log, HardwareModel(HMC_PARAMS))
    lats = query_latencies(tl)
    assert len(lats) == 3 and len(set(lats)) == 1
    sched = {n.tag.node: n for n in tl.nodes}
    assert lats[0] == sched["r0:ana0"].finish - sched["r0:snap0"].start
