"""The single-instance baselines of the port (SI-SS: `core/snapshot.py`,
SI-MVCC: `core/mvcc.py`, their NSM scans `engine.run_query_nsm`, and the
session's SI branches) against the JAX package's, on the same seeded
inputs.

Mirrors tests/test_golden_answers.py (the SI-SS and SI-MVCC answers of
tests/golden_answers.json and the three consistency points),
tests/test_mvcc.py (snapshot reads against a brute-force oracle, the chain
cost) and the reference's session semantics: modeled seconds and energy
under both timings with the ``zero_cost_*`` normalization switches,
SI-MVCC's round-start timestamp (and "now" for a round with no
transactions yet), SI-SS's dirty-only snapshots. The baselines keep the
table in one host row store: they build no replica on the device and
launch no kernel. Integers and the hardware model's floats: tolerance 0.
"""

import dataclasses
import json
import pathlib

import numpy as np
import pytest
import torch

from repro.core import engine as ref_engine
from repro.core import htap as ref_htap
from repro.core import mvcc as ref_mvcc
from repro.core import schema as ref_schema
from repro.core import session as ref_session_mod
from repro.core import snapshot as ref_snapshot
from repro.core.hwmodel import CostLog as RefCostLog
from repro_torch.core import engine, htap, schema
from repro_torch.core.hwmodel import CostLog
from repro_torch.core.mvcc import MVCCStore
from repro_torch.core.schema import UpdateStream
from repro_torch.core.session import HTAPSession, SystemSpec
from repro_torch.core.snapshot import SnapshotStore
from repro_torch.core.workload import slice_stream, split_stream

torch.set_num_threads(1)

GOLDEN = json.loads((pathlib.Path(__file__).parent /
                     "golden_answers.json").read_text())["results"]
SI = ["SI-SS", "SI-MVCC"]


def _events(log) -> list[dict]:
    return [dataclasses.asdict(e) for e in log.events]


def _meta(res) -> dict:
    return dict(name=res.name, results=[int(a) for a in res.results],
                n_txn=res.n_txn, n_ana=res.n_ana,
                txn_seconds=res.txn_seconds, ana_seconds=res.ana_seconds,
                energy_joules=res.energy_joules,
                freshness_seconds=res.freshness_seconds,
                stats={k: v for k, v in res.stats.items()
                       if k not in ("traces", "kernel_launches")})


# ---------------------------------------------------------------------------
# golden answers and consistency points
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["hopper", "torch", "hopper@4"])
@pytest.mark.parametrize("name", SI)
def test_si_golden_answers(small_workload, name, backend):
    """The backend is validated, never used: every spec answers the
    golden vector from the host row store."""
    table, stream, queries = small_workload
    res = htap.run(name, table, stream, queries, backend=backend,
                   device="cpu")
    assert res.results == GOLDEN[name]
    assert res.stats["kernel_launches"] == {}


def test_three_consistency_points(small_workload):
    """Round end (SI-SS and the MI family), round start (SI-MVCC) and the
    initial table (Ana-Only)."""
    table, stream, queries = small_workload
    got = {name: htap.run(name, table, stream, queries, device="cpu").results
           for name in htap.ALL_PRESETS if name != "Ideal-Txn"}
    assert got["SI-SS"] == got["Polynesia"] == got["MI+SW"]
    assert got["SI-MVCC"] != got["SI-SS"]
    assert len({tuple(v) for v in got.values()}) == 3
    assert list(htap.PRESETS) == list(ref_htap.PRESETS)
    assert list(htap.ALL_PRESETS) == list(ref_htap.ALL_PRESETS)


# ---------------------------------------------------------------------------
# modeled numbers under both timings, with the normalization switches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("timing,asy", [("phase", False),
                                        ("timeline", False),
                                        ("timeline", True)],
                         ids=["phase", "timeline", "async"])
@pytest.mark.parametrize("zero_cost", [False, True])
@pytest.mark.parametrize("name", SI)
def test_si_modeled_numbers_match_reference(small_workload, name, zero_cost,
                                            timing, asy):
    table, stream, queries = small_workload
    flag = "zero_cost_snapshot" if name == "SI-SS" else "zero_cost_mvcc"
    got = htap.run(name, table, stream, queries, device="cpu",
                   timing=timing, async_propagation=asy, **{flag: zero_cost})
    want = ref_htap.run(name, table, stream, queries, backend="numpy",
                        n_shards=1, timing=timing, async_propagation=asy,
                        **{flag: zero_cost})
    assert _meta(got) == _meta(want)
    key = "snapshots" if name == "SI-SS" else "versions"
    assert set(_meta(got)["stats"]) - {"timeline", "latency",
                                       "accel_seconds"} == {key}
    free = htap.run(name, table, stream, queries, device="cpu",
                    timing=timing, async_propagation=asy, **{flag: True})
    assert free.results == got.results
    if timing == "phase":
        # the switch removes exactly the snapshot / chain-traversal cost
        assert free.energy_joules <= got.energy_joules


def test_si_sessions_build_no_replica_and_launch_nothing(small_workload):
    table, stream, queries = small_workload
    for spec in (SystemSpec.si_ss(), SystemSpec.si_mvcc()):
        session = HTAPSession(spec, table, device="cpu")
        session.execute(stream)
        session.query_batch(queries)
        assert not hasattr(session, "replica") and not hasattr(session,
                                                               "cons")
        res = session.finish()
        assert res.stats["kernel_launches"] == {}


def test_si_default_device_is_the_gpu(small_workload):
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a GPU")
    table, _, _ = small_workload
    with pytest.raises(RuntimeError, match="CUDA"):
        HTAPSession(SystemSpec.si_ss(), table)


# ---------------------------------------------------------------------------
# session semantics: interleavings the batch runner never makes
# ---------------------------------------------------------------------------

def _drive(session_mod, spec, table, stream, queries, **kw):
    """An open-system interleaving: queries before a round's first chunk,
    several chunks and batches a round, an empty chunk, a batch that
    follows a read-only chunk."""
    session = session_mod.HTAPSession(spec, table, **kw)
    chunks = split_stream(stream, 6)
    qs = [queries[i:i + 2] for i in range(0, len(queries), 2)]
    session.execute(chunks[0])
    session.query_batch(qs[0])
    session.advance_round()
    session.query_batch(qs[1])            # no transactions this round yet
    session.execute(chunks[1])
    session.execute(chunks[2])
    session.query_batch(qs[2])
    session.query_batch(qs[3])            # a second batch: snap.1
    session.advance_round()
    session.execute(slice_stream(chunks[3], 0, 0))     # an empty chunk
    session.query_batch(qs[4])
    c = chunks[4]                         # a read-only chunk dirties nothing
    session.execute(UpdateStream(c.thread_id, c.commit_id,
                                 np.zeros_like(c.op), c.row, c.col, c.value))
    session.query_batch(qs[5])
    session.advance_round()
    session.execute(chunks[5])
    return session.finish()


@pytest.mark.parametrize("timing,asy", [("phase", False),
                                        ("timeline", False),
                                        ("timeline", True)],
                         ids=["phase", "timeline", "async"])
@pytest.mark.parametrize("name", SI)
def test_si_open_interleavings_match_reference(small_workload, name, timing,
                                               asy):
    from repro_torch.core import session as session_mod
    table, stream, queries = small_workload
    got = _drive(session_mod, htap.resolve_spec(name, timing=timing,
                                                async_propagation=asy),
                 table, stream, queries, device="cpu")
    want = _drive(ref_session_mod, ref_htap.resolve_spec(
        name, backend="numpy", n_shards=1, timing=timing,
        async_propagation=asy), table, stream, queries)
    assert _meta(got) == _meta(want)
    if name == "SI-SS":
        # dirty-only: the first batch and the one after chunks 1-2 copy;
        # the batches after no chunk, an empty chunk or a read-only chunk
        # reuse the snapshot
        assert got.stats["snapshots"] == 2


def test_si_mvcc_query_nodes_wait_only_on_the_previous_round(small_workload):
    table, stream, queries = small_workload
    session = HTAPSession(SystemSpec.si_mvcc(), table, device="cpu")
    chunks = split_stream(stream, 3)
    session.execute(chunks[0])
    session.query_batch(queries[:1])
    session.advance_round()
    session.execute(chunks[1])
    session.execute(chunks[2])
    session.query_batch(queries[1:2])
    tags = session.cost.tags
    assert tags["r0:ana0"].deps == ()
    assert tags["r1:ana0"].deps == ("r0:txn",)
    session.advance_round()
    session.query_batch(queries[2:3])
    assert tags["r2:ana0"].deps == ("r1:txn.1",)
    session.finish()


# ---------------------------------------------------------------------------
# the stores and the NSM scan against the reference's
# ---------------------------------------------------------------------------

def _stream(rng, n, n_rows, n_cols):
    return UpdateStream(
        thread_id=rng.integers(0, 4, n).astype(np.int32),
        commit_id=np.arange(n, dtype=np.int64),
        op=np.ones(n, dtype=np.int8),
        row=rng.integers(0, n_rows, n).astype(np.int64),
        col=rng.integers(0, n_cols, n).astype(np.int32),
        value=rng.integers(0, 1000, n).astype(np.int32),
    )


def _ref_stream(s: UpdateStream):
    return ref_schema.UpdateStream(s.thread_id, s.commit_id, s.op, s.row,
                                   s.col, s.value)


def _mvcc_case(n_writes, ts, seed=7):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 100, size=(20, 3)).astype(np.int32)
    store, ref = MVCCStore(base), ref_mvcc.MVCCStore(base)
    stream = _stream(rng, n_writes, 20, 3)
    cost, ref_cost = CostLog(), RefCostLog()
    store.execute(stream, cost)
    ref.execute(_ref_stream(stream), ref_cost)
    assert store.n_versions == ref.n_versions
    for col in range(3):
        for hops in (True, False):
            got = store.read_column_at(col, ts, cost, hops)
            np.testing.assert_array_equal(
                got, ref.read_column_at(col, ts, ref_cost, hops))
        oracle = base[:, col].copy()
        for i in range(n_writes):
            if stream.col[i] == col and stream.commit_id[i] <= ts:
                oracle[stream.row[i]] = stream.value[i]
        np.testing.assert_array_equal(got, oracle)
    assert _events(cost) == _events(ref_cost)


@pytest.mark.parametrize("n_writes,ts", [(0, 0), (1, 0), (300, 150),
                                         (300, 0), (300, 10**9), (37, -1)])
def test_mvcc_reads_match_oracle_and_reference(n_writes, ts):
    _mvcc_case(n_writes, ts)


def test_mvcc_read_at_timestamp_property():
    pytest.importorskip(
        "hypothesis",
        reason="property tests need hypothesis (pip install .[test])")
    from hypothesis import given, settings, strategies as st

    @settings(max_examples=15, deadline=None)
    @given(st.integers(0, 300), st.integers(0, 300))
    def prop(n_writes, ts):
        _mvcc_case(n_writes, ts)

    prop()


def test_chain_cost_grows_with_newer_versions():
    """The paper's Fig. 1-left effect: older snapshots pay more hops."""
    rng = np.random.default_rng(1)
    base = rng.integers(0, 10, size=(50, 1)).astype(np.int32)
    store = MVCCStore(base)
    store.execute(_stream(rng, 5000, 50, 1))
    c_old, c_new = CostLog(), CostLog()
    store.read_column_at(0, ts=0, cost=c_old)       # everything is "newer"
    store.read_column_at(0, ts=10**9, cost=c_new)   # nothing newer
    assert c_old.events[0].cycles > c_new.events[0].cycles * 10


def test_snapshot_store_matches_reference():
    rng = np.random.default_rng(3)
    table = rng.integers(0, 100, size=(30, 4)).astype(np.int32)
    snap, ref = SnapshotStore(table), ref_snapshot.SnapshotStore(table)
    cost, ref_cost = CostLog(), RefCostLog()
    views = []
    for step in range(6):
        if step % 3 == 1:
            snap.data[step, 0] = ref.data[step, 0] = -step
            snap.mark_dirty()
            ref.mark_dirty()
        view = snap.take_snapshot_if_needed(cost if step % 2 else None)
        np.testing.assert_array_equal(
            view, ref.take_snapshot_if_needed(ref_cost if step % 2 else None))
        assert view is not snap.data
        views.append(view)
    assert snap.snapshots_taken == ref.snapshots_taken == 3
    assert views[0] is not views[1] and views[2] is views[1]
    assert _events(cost) == _events(ref_cost)
    table[0, 0] = 999                  # the store copied its table
    assert snap.data[0, 0] != 999


@pytest.mark.parametrize("seed", range(4))
def test_nsm_scan_matches_reference(seed):
    rng = np.random.default_rng(seed)
    sch = schema.make_schema("t", 5, 32)
    table = schema.gen_table(rng, sch, 3000)
    queries = engine.gen_queries(rng, 8, 5, join_fraction=0.5)
    for q in queries:
        cost, ref_cost = CostLog(), RefCostLog()
        got = engine.run_query_nsm(table, q, cost, backend=_cpu_backend())
        want = ref_engine.run_query_nsm(table, q, ref_cost, backend="numpy")
        assert got == want
        assert _events(cost) == _events(ref_cost)
    assert engine.query_task_rows(queries, 3000) == \
        ref_engine.query_task_rows(queries, 3000)
    assert engine.NSM_BYTES_PER_TOUCHED_COL == \
        ref_engine.NSM_BYTES_PER_TOUCHED_COL


def _cpu_backend():
    from repro_torch.core.backend import get_backend
    return get_backend("torch", device="cpu")


def test_nsm_scan_validates_its_backend():
    table = np.zeros((4, 2), np.int32)
    q = engine.Query(0, 0, 0, 1, 1)
    with pytest.raises(KeyError, match="unknown backend"):
        engine.run_query_nsm(table, q, backend="numpy")
    with pytest.raises(KeyError):
        ref_engine.run_query_nsm(table, q, backend="bogus")
