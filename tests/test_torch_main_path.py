"""The ported slice as a whole against the JAX package: one HTAP session
(execute -> ship -> apply -> snapshot -> fused scan) on the seed-0
workload, for every preset of the slice and both port backends.

Query answers, final replica columns and the phase model's seconds and
energy must equal the reference's exactly (integers, and floats produced
by the same arithmetic: tolerance 0), and the answers must equal the
committed golden answers.
"""

import json
import pathlib

import numpy as np
import pytest
import torch

from repro.core import engine as ref_engine
from repro.core import htap as ref_htap
from repro.core import schema as ref_schema
from repro.core.session import HTAPSession as RefSession
from repro.core.session import resolve_spec as ref_resolve_spec
from repro_torch.core import engine, htap, schema
from repro_torch.core.dsm import column_to_numpy
from repro_torch.core.nsm import make_entries
from repro_torch.core.session import (HTAPSession, SessionClosedError,
                                      SystemSpec, resolve_spec)
from repro_torch.core.workload import slice_stream, split_queries, split_stream

torch.set_num_threads(1)

ROWS, COLS, TXNS, QUERIES = 4000, 4, 8000, 12      # tests/conftest.py sizes
MI = ["Polynesia", "MI+SW", "MI+SW+HB", "PIM-Only"]
SLICE = MI + ["Ana-Only", "Ideal-Txn"]
PORT_BACKENDS = ("torch", "hopper")
GOLDEN = json.loads((pathlib.Path(__file__).parent /
                     "golden_answers.json").read_text())["results"]


def _workload(mod, eng, seed=0):
    rng = np.random.default_rng(seed)
    sch = mod.make_schema("t", COLS, 32)
    table = mod.gen_table(rng, sch, ROWS)
    stream = mod.gen_update_stream(rng, sch, ROWS, TXNS, write_ratio=0.5)
    queries = eng.gen_queries(rng, QUERIES, COLS)
    return table, stream, queries


@pytest.fixture(scope="module")
def workload():
    return _workload(schema, engine)


@pytest.fixture(scope="module")
def ref_workload():
    return _workload(ref_schema, ref_engine)


@pytest.fixture(scope="module")
def ref_runs(ref_workload):
    """The reference's results, computed once per (preset, n_rounds)."""
    table, stream, queries = ref_workload
    cache = {}

    def get(name, n_rounds):
        if (name, n_rounds) not in cache:
            cache[name, n_rounds] = ref_htap.run(
                name, table, stream, queries, n_rounds=n_rounds,
                backend="pallas", n_shards=1, placement="stacked",
                timing="phase", delta_store=False
                if name in ref_htap.PRESETS and name in MI else None)
        return cache[name, n_rounds]
    return get


def test_generators_produce_the_reference_arrays(workload, ref_workload):
    (t, s, q), (rt, rs, rq) = workload, ref_workload
    np.testing.assert_array_equal(t, rt)
    for field in ("thread_id", "commit_id", "op", "row", "col", "value"):
        a, b = getattr(s, field), getattr(rs, field)
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    assert [(x.query_id, x.filter_col, x.lo, x.hi, x.agg_col, x.join_col)
            for x in q] == [(x.query_id, x.filter_col, x.lo, x.hi, x.agg_col,
                             x.join_col) for x in rq]
    rng, rrng = np.random.default_rng(5), np.random.default_rng(5)
    sch, rsch = schema.make_schema("z", 3, (4, 8, 16)), \
        ref_schema.make_schema("z", 3, (4, 8, 16))
    np.testing.assert_array_equal(schema.gen_table(rng, sch, 50),
                                  ref_schema.gen_table(rrng, rsch, 50))
    a = schema.gen_update_stream(rng, sch, 50, 200, write_ratio=0.8,
                                 zipf_skew=1.1)
    b = ref_schema.gen_update_stream(rrng, rsch, 50, 200, write_ratio=0.8,
                                     zipf_skew=1.1)
    np.testing.assert_array_equal(a.row, b.row)
    np.testing.assert_array_equal(a.value, b.value)


@pytest.mark.parametrize("n_rounds", [4, 8])
@pytest.mark.parametrize("be", PORT_BACKENDS)
@pytest.mark.parametrize("name", SLICE)
def test_slice_matches_reference(workload, ref_runs, name, be, n_rounds):
    table, stream, queries = workload
    got = htap.run(name, table, stream, queries, n_rounds=n_rounds,
                   backend=be, device="cpu")
    ref = ref_runs(name, n_rounds)
    assert [int(a) for a in got.results] == [int(a) for a in ref.results]
    assert all(type(a) is int for a in got.results)
    assert (got.name, got.n_txn, got.n_ana) == (ref.name, ref.n_txn, ref.n_ana)
    # the phase model: floats from the same arithmetic, so exactly equal
    assert got.txn_seconds == ref.txn_seconds
    assert got.ana_seconds == ref.ana_seconds
    assert got.energy_joules == ref.energy_joules
    assert got.stats["accel_seconds"] == ref.stats["accel_seconds"]
    assert got.freshness_seconds is None and ref.freshness_seconds is None
    for key in ("applications", "snapshots", "shared", "islands", "placement"):
        assert got.stats.get(key) == ref.stats.get(key), key
    if n_rounds == 8 and name in GOLDEN:
        assert [int(a) for a in got.results] == GOLDEN[name]


def test_golden_answers_cover_the_slices_query_systems():
    # the single-instance baselines joined the port's presets with the
    # timeline slice; their sessions are held in tests/test_torch_si.py
    si = ["SI-SS", "SI-MVCC"]
    assert set(MI + si + ["Ana-Only"]) <= set(GOLDEN)
    assert set(htap.ALL_PRESETS) == set(SLICE + si)
    assert list(htap.PRESETS) == list(ref_htap.PRESETS)
    assert list(htap.ALL_PRESETS) == list(ref_htap.ALL_PRESETS)


def _drive(session_cls, spec, table, chunks, q_chunks, **kw):
    session = session_cls(spec, table, **kw)
    for r, (chunk, qs) in enumerate(zip(chunks, q_chunks)):
        if r:
            session.advance_round()
        for piece in chunk:
            session.execute(piece)
        session.query_batch(qs)
    return session


@pytest.mark.parametrize("be", PORT_BACKENDS)
@pytest.mark.parametrize("name", MI)
def test_final_replica_columns_match_reference(workload, ref_workload, name,
                                               be):
    table, stream, queries = workload
    rtable, rstream, rqueries = ref_workload
    chunks = [[c] for c in split_stream(stream, 4)]
    rchunks = [[c] for c in ref_htap.split_stream(rstream, 4)]
    sess = _drive(HTAPSession, resolve_spec(name, backend=be), table, chunks,
                  split_queries(queries, 4), device="cpu")
    ref = _drive(RefSession, ref_resolve_spec(
        name, backend="pallas", n_shards=1, placement="stacked",
        timing="phase", delta_store=False), rtable, rchunks,
        ref_htap.split_queries(rqueries, 4))
    assert sess.results == [int(a) for a in ref.results]
    np.testing.assert_array_equal(sess.store.data, ref.store.data)
    for c, rcol in ref.replica.columns.items():
        codes, dictionary, valid, version = column_to_numpy(
            sess.replica.columns[c])
        np.testing.assert_array_equal(codes, np.asarray(rcol.codes))
        np.testing.assert_array_equal(dictionary, np.asarray(rcol.dictionary))
        np.testing.assert_array_equal(valid, np.asarray(rcol.valid))
        assert version == rcol.version
    np.testing.assert_array_equal(sess.replica.to_table(), sess.store.data)
    assert sess.cons.chain_lengths() == ref.cons.chain_lengths()
    sess.finish(), ref.finish()


@pytest.mark.parametrize("be", PORT_BACKENDS)
@pytest.mark.parametrize("name", ["Polynesia", "MI+SW"])
def test_incremental_session_with_uneven_chunks_equals_batch_run(workload,
                                                                 name, be):
    table, stream, queries = workload
    batch = htap.run(name, table, stream, queries, n_rounds=4, backend=be,
                     device="cpu")
    cuts = [0, 1, 2, 1500, 1501, 2600, TXNS]       # uneven, incl. tiny pieces
    bounds = np.linspace(0, TXNS, 5).astype(int)
    chunks = []
    for lo, hi in zip(bounds, bounds[1:]):
        inner = sorted({lo, hi} | {c for c in cuts if lo < c < hi})
        chunks.append([slice_stream(stream, a, b)
                       for a, b in zip(inner, inner[1:])]
                      + [slice_stream(stream, hi, hi)])      # an empty chunk
    sess = _drive(HTAPSession, resolve_spec(name, backend=be), table, chunks,
                  split_queries(queries, 4), device="cpu")
    inc = sess.finish()
    assert inc.results == batch.results
    assert (inc.txn_seconds, inc.ana_seconds, inc.energy_joules) == (
        batch.txn_seconds, batch.ana_seconds, batch.energy_joules)
    assert inc.stats["accel_seconds"] == batch.stats["accel_seconds"]
    assert inc.n_txn == TXNS and inc.n_ana == QUERIES


@pytest.mark.parametrize("be", PORT_BACKENDS)
def test_duplicate_row_ship_batch_matches_reference(workload, ref_workload, be):
    """Two writes to one cell in one ship batch, then a delete of the row:
    the GPU-safe scatter (last write per row only) must leave the same
    column as the reference's ordered scatter."""
    table, _, _ = workload
    n = 9
    stream = schema.UpdateStream(
        thread_id=np.asarray([0, 1, 2, 3, 0, 1, 2, 3, 0], np.int32),
        commit_id=np.arange(n, dtype=np.int64),
        op=np.asarray([1, 1, 1, 0, 1, 3, 1, 1, 3], np.int8),
        row=np.asarray([7, 7, 9, 1, 9, 7, 11, 11, 12], np.int64),
        col=np.asarray([2, 2, 2, 0, 2, 2, 1, 1, 3], np.int32),
        value=np.asarray([100, 200, 300, 0, 400, 0, 500, 600, 0], np.int32))
    rstream = ref_schema.UpdateStream(stream.thread_id, stream.commit_id,
                                      stream.op, stream.row, stream.col,
                                      stream.value)
    qs = [engine.Query(0, 2, 0, 1 << 24, 2, 2), engine.Query(1, 1, 0, 700, 2),
          engine.Query(2, 3, 0, 1 << 24, 1, None)]
    rqs = [ref_engine.Query(q.query_id, q.filter_col, q.lo, q.hi, q.agg_col,
                            q.join_col) for q in qs]
    sess = HTAPSession(SystemSpec.polynesia(backend=be), table, device="cpu")
    ref = RefSession(ref_resolve_spec("Polynesia", backend="pallas",
                                      n_shards=1, placement="stacked",
                                      timing="phase", delta_store=False),
                     ref_workload[0])
    sess.execute(stream), ref.execute(rstream)
    assert sess.query_batch(qs) == [int(a) for a in ref.query_batch(rqs)]
    for c, rcol in ref.replica.columns.items():
        codes, dictionary, valid, version = column_to_numpy(
            sess.replica.columns[c])
        np.testing.assert_array_equal(codes, np.asarray(rcol.codes))
        np.testing.assert_array_equal(dictionary, np.asarray(rcol.dictionary))
        np.testing.assert_array_equal(valid, np.asarray(rcol.valid))
        assert version == rcol.version
    col2 = sess.replica.columns[2]
    assert int(col2.dictionary[col2.codes[7]]) == 200 and not col2.valid[7]
    assert int(col2.dictionary[col2.codes[9]]) == 400 and col2.valid[9]
    assert not sess.replica.columns[3].valid[12]
    got, want = sess.finish(), ref.finish()
    assert (got.txn_seconds, got.ana_seconds, got.energy_joules) == (
        want.txn_seconds, want.ana_seconds, want.energy_joules)


def test_session_lifecycle_errors(workload):
    table, stream, queries = workload
    sess = HTAPSession(SystemSpec.polynesia(backend="torch"), table,
                       device="cpu")
    assert sess.query_batch([]) == []
    sess.execute(slice_stream(stream, 0, 10))
    sess.flush_updates()
    assert sess.store.pending_updates == 0
    assert isinstance(sess.query(queries[0]), int)
    sess.finish()
    for call in (lambda: sess.execute(stream), lambda: sess.query(queries[0]),
                 sess.advance_round, sess.flush_updates, sess.finish):
        with pytest.raises(SessionClosedError):
            call()
    aborted = HTAPSession(SystemSpec.ideal_txn(backend="torch"), table,
                          device="cpu")
    aborted.abort(), aborted.abort()
    with pytest.raises(SessionClosedError):
        aborted.finish()
    with pytest.raises(ValueError, match="only accepts queries"):
        HTAPSession(SystemSpec.ana_only(backend="torch"), table,
                    device="cpu").execute(stream)
    with pytest.raises(ValueError, match="only accepts transactions"):
        HTAPSession(SystemSpec.ideal_txn(backend="torch"), table,
                    device="cpu").query(queries[0])
    with pytest.raises(ValueError, match="multiple-instance"):
        HTAPSession(SystemSpec.ideal_txn(backend="torch"), table,
                    device="cpu").flush_updates()


def test_make_entries_records_match_reference_layout():
    from repro.core.nsm import UPDATE_DTYPE as REF_DTYPE
    from repro_torch.core.nsm import UPDATE_DTYPE
    assert UPDATE_DTYPE == REF_DTYPE
    e = make_entries(np.arange(3), np.ones(3), np.arange(3), np.arange(3),
                     np.zeros(3))
    assert e.dtype == REF_DTYPE and len(e) == 3
