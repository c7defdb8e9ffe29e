"""The port's workload chunking and arrival processes (`core/workload.py`)
and mixed-traffic serving (`htap.run_mixed_traffic`) against the JAX
package's, on the same seeded inputs.

Mirrors tests/test_workload.py: the splitters, then the seeded
multi-client schedule (equal times, clients, positions and queries for a
seed), its batches by position, and the served runs - answers, modeled
seconds, energy, freshness and latency equal to the reference's for every
preset under both timings and with async propagation, on one island,
``hopper@4`` and the delta store. Each arrival batch's answers must also
equal a numpy evaluation over the row store at its position. Integers and
the hardware model's floats: tolerance 0.
"""

import numpy as np
import pytest
import torch

from repro.core import engine as ref_engine
from repro.core import htap as ref_htap
from repro.core import schema as ref_schema
from repro.core import workload as ref_workload
from repro_torch.core import engine, htap, schema, workload
from repro_torch.core.nsm import RowStore
from repro_torch.core.session import HTAPSession, SystemSpec

torch.set_num_threads(1)

ROWS, COLS, TXNS = 4000, 4, 8000                    # tests/conftest.py sizes


def _stream(n, n_threads=4, seed=0, mod=schema):
    rng = np.random.default_rng(seed)
    sch = mod.make_schema("t", 3, 32)
    return mod.gen_update_stream(rng, sch, 100, n, n_threads=n_threads)


def _same_stream(a, b):
    for f in ("thread_id", "commit_id", "op", "row", "col", "value"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


# ---------------------------------------------------------------------------
# split_stream / split_queries / slice_stream
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,rounds", [(101, 7), (3, 8), (0, 4), (17, 1)])
def test_split_stream_matches_reference(n, rounds):
    stream = _stream(n)
    chunks = workload.split_stream(stream, rounds)
    ref = ref_workload.split_stream(_stream(n, mod=ref_schema), rounds)
    assert len(chunks) == len(ref) == rounds
    for c, r in zip(chunks, ref):
        _same_stream(c, r)
    cat = np.concatenate([c.commit_id for c in chunks])
    assert np.array_equal(cat, stream.commit_id)
    sizes = [len(c) for c in chunks]
    assert max(sizes) - min(sizes) <= 1


@pytest.mark.parametrize("bad", [0, -1])
def test_split_validates_n_rounds(bad):
    with pytest.raises(ValueError, match="n_rounds"):
        workload.split_stream(_stream(4), bad)
    with pytest.raises(ValueError, match="n_rounds"):
        workload.split_queries([], bad)


def test_split_queries_and_slices_match_reference():
    queries = engine.gen_queries(np.random.default_rng(0), 5, 3)
    for k in (1, 3, 9):
        assert workload.split_queries(queries, k) == \
            ref_workload.split_queries(queries, k)
    assert len(workload.split_queries([], 4)) == 4
    stream = _stream(20)
    _same_stream(workload.slice_stream(stream, 5, 12),
                 ref_workload.slice_stream(_stream(20, mod=ref_schema), 5, 12))


# ---------------------------------------------------------------------------
# mixed-traffic arrival process
# ---------------------------------------------------------------------------

def _clients(n_clients=3, n_queries=16):
    return [engine.gen_queries(np.random.default_rng(100 + c), n_queries, 3)
            for c in range(n_clients)]


def _fields(arrivals):
    return [(a.time, a.client, a.position, a.query) for a in arrivals]


@pytest.mark.parametrize("seed,n_txn,rate,qrates", [
    (42, 10_000, 1e6, [500.0, 900.0, 1300.0]),
    (1, 50_000, 1e6, [3200.0, 200.0, 800.0]),
    (3, 5_000, 1e6, [2e3, 2e3, 2e3]),
    (7, 400_000, 100_000.0, [3.0, 3.0, 3.0]),
])
def test_schedule_equals_the_references(seed, n_txn, rate, qrates):
    clients = _clients()
    got = workload.mixed_traffic_schedule(np.random.default_rng(seed),
                                          clients, n_txn, rate, qrates)
    want = ref_workload.mixed_traffic_schedule(np.random.default_rng(seed),
                                               clients, n_txn, rate, qrates)
    assert _fields(got) == _fields(want)
    times = [a.time for a in got]
    assert times == sorted(times)
    horizon = n_txn / rate
    for a in got:
        assert 0.0 < a.time <= horizon and 0 <= a.position <= n_txn
    batches = workload.arrival_batches(got)
    ref_batches = ref_workload.arrival_batches(want)
    assert [(p, _fields(b)) for p, b in batches] == \
        [(p, _fields(b)) for p, b in ref_batches]
    positions = [p for p, _ in batches]
    assert positions == sorted(set(positions))
    assert sum(len(b) for _, b in batches) == len(got)


def test_mixed_traffic_load_scales_with_rate():
    clients = _clients(n_clients=1, n_queries=256)
    served = [len(workload.mixed_traffic_schedule(
        np.random.default_rng(1), clients, n_txn=50_000, txn_rate=1e6,
        query_rates=[rate])) for rate in (200.0, 800.0, 3200.0)]
    assert served[0] < served[1] < served[2]


def test_mixed_traffic_validation():
    clients = _clients(2)
    rng = np.random.default_rng(0)
    with pytest.raises(ValueError, match="clients"):
        workload.mixed_traffic_schedule(rng, clients, 100, 1e6, [1.0])
    with pytest.raises(ValueError, match="txn_rate"):
        workload.mixed_traffic_schedule(rng, clients, 100, 0.0, [1.0, 1.0])
    with pytest.raises(ValueError, match="rate"):
        workload.mixed_traffic_schedule(rng, clients, 100, 1e6, [1.0, -2.0])


# ---------------------------------------------------------------------------
# run_mixed_traffic against the reference's
# ---------------------------------------------------------------------------

def _served_workload(mod, eng):
    rng = np.random.default_rng(0)
    sch = mod.make_schema("t", COLS, 32)
    table = mod.gen_table(rng, sch, ROWS)
    stream = mod.gen_update_stream(rng, sch, ROWS, TXNS, write_ratio=0.5)
    clients = [eng.gen_queries(np.random.default_rng(100 + c), 8, COLS)
               for c in range(3)]
    arrivals = ref_workload.mixed_traffic_schedule(
        np.random.default_rng(42), clients, n_txn=TXNS, txn_rate=1e6,
        query_rates=[800.0, 1200.0, 1600.0])
    return table, stream, arrivals


@pytest.fixture(scope="module")
def served():
    return _served_workload(schema, engine)


def _meta(res) -> dict:
    return dict(name=res.name, results=[int(a) for a in res.results],
                n_txn=res.n_txn, n_ana=res.n_ana,
                txn_seconds=res.txn_seconds, ana_seconds=res.ana_seconds,
                energy_joules=res.energy_joules,
                freshness_seconds=res.freshness_seconds,
                stats={k: v for k, v in res.stats.items()
                       if k not in ("traces", "kernel_launches")})


def _host_answers(served):
    """Each arrival's answer from a numpy evaluation over a row store
    advanced to its position (the end-of-batch visibility point)."""
    table, stream, arrivals = served
    store = RowStore(table)
    cursor, out = 0, []
    for pos, batch in workload.arrival_batches(arrivals):
        store.execute(workload.slice_stream(stream, cursor, pos))
        cursor = pos
        out.extend(_nsm(store.data, a.query) for a in batch)
    return out


def _nsm(data, q):
    fvals = data[:, q.filter_col]
    mask = (fvals >= q.lo) & (fvals <= q.hi)
    res = int(data[mask, q.agg_col].astype(np.int64).sum())
    if q.join_col is not None:
        jv = data[:, q.join_col]
        uv, counts = np.unique(jv, return_counts=True)
        res += int(counts[np.searchsorted(uv, jv[mask])].astype(
            np.int64).sum())
    return res


@pytest.mark.parametrize("timing,asy", [("phase", False),
                                        ("timeline", False),
                                        ("timeline", True)],
                         ids=["phase", "timeline", "async"])
@pytest.mark.parametrize("name,backend,delta", [
    ("Polynesia", "hopper", False), ("Polynesia", "hopper@4", False),
    ("Polynesia", "hopper@4", True), ("MI+SW", "torch", False),
    ("PIM-Only", "hopper", True), ("SI-SS", "hopper", False),
    ("SI-MVCC", "hopper", False)])
def test_run_mixed_traffic_matches_reference(served, name, backend, delta,
                                             timing, asy):
    table, stream, arrivals = served
    spec = htap.resolve_spec(name, backend=backend, timing=timing,
                             async_propagation=asy,
                             delta_store=delta if "SI" not in name else None)
    got = htap.run_mixed_traffic(spec, table, stream, arrivals, device="cpu")
    n = int(backend.partition("@")[2] or 1)
    rtable, rstream, rarrivals = _served_workload(ref_schema, ref_engine)
    ref_spec = ref_htap.resolve_spec(
        name, backend="pallas", n_shards=n, placement="stacked",
        timing=timing, async_propagation=asy,
        delta_store=delta if "SI" not in name else None)
    want = ref_htap.run_mixed_traffic(ref_spec, rtable, rstream, rarrivals)
    assert _meta(got) == _meta(want)
    assert got.n_ana == len(arrivals) and got.n_txn == TXNS
    if name != "SI-MVCC":
        # the MI family and SI-SS answer at the batch's position
        assert got.results == _host_answers(served)
    if timing == "timeline" and "SI" not in name:
        assert got.freshness_seconds["n_batches"] > 0
        assert got.stats["latency"]["n_queries"] == len(arrivals)


def test_run_mixed_traffic_on_the_mesh_answers_as_one_island(served):
    table, stream, arrivals = served
    one = htap.run_mixed_traffic(
        SystemSpec.polynesia(backend="hopper", timing="timeline"),
        table, stream, arrivals, device="cpu")
    mesh = htap.run_mixed_traffic(
        SystemSpec.polynesia(backend="hopper@4/mesh", timing="timeline",
                             async_propagation=True, delta_store=True),
        table, stream, arrivals, devices=["cpu"] * 4)
    assert mesh.results == one.results == _host_answers(served)
    assert mesh.stats["placement"] == "mesh"


def test_run_mixed_traffic_drives_the_session_batch_by_batch(served):
    """run_mixed_traffic is HTAPSession driven round by round: the same
    batches by hand give the same answers and modeled numbers."""
    table, stream, arrivals = served
    spec = SystemSpec.polynesia(backend="hopper", timing="timeline",
                                async_propagation=True)
    session = HTAPSession(spec, table, device="cpu")
    cursor = 0
    batches = workload.arrival_batches(arrivals)
    for i, (pos, batch) in enumerate(batches):
        if i:
            session.advance_round()
        session.execute(workload.slice_stream(stream, cursor, pos))
        cursor = pos
        session.query_batch([a.query for a in batch])
    session.advance_round()
    session.execute(workload.slice_stream(stream, cursor, len(stream)))
    by_hand = session.finish()
    got = htap.run_mixed_traffic(spec, table, stream, arrivals, device="cpu")
    assert _meta(got) == _meta(by_hand)
    assert session.round == len(batches)


def test_run_mixed_traffic_rejects_positions_past_the_stream(served):
    table, stream, _ = served
    clients = [engine.gen_queries(np.random.default_rng(5), 8, COLS)]
    far = workload.mixed_traffic_schedule(np.random.default_rng(0), clients,
                                          n_txn=10 * TXNS, txn_rate=1e6,
                                          query_rates=[100.0])
    assert far and far[-1].position > len(stream)
    with pytest.raises(ValueError, match="beyond the stream"):
        htap.run_mixed_traffic(SystemSpec.polynesia(backend="torch"), table,
                               stream, far, device="cpu")
    rt, rs_, _ = _served_workload(ref_schema, ref_engine)
    with pytest.raises(ValueError, match="beyond the stream"):
        ref_htap.run_mixed_traffic(ref_htap.SystemSpec.polynesia(
            backend="numpy"), rt, rs_, far)


def test_run_mixed_traffic_with_no_arrivals_executes_the_stream(served):
    table, stream, _ = served
    got = htap.run_mixed_traffic(SystemSpec.polynesia(backend="torch",
                                                      timing="timeline"),
                                 table, stream, [], device="cpu")
    rt, rs_, _ = _served_workload(ref_schema, ref_engine)
    want = ref_htap.run_mixed_traffic(ref_htap.SystemSpec.polynesia(
        backend="numpy", n_shards=1, delta_store=False, timing="timeline"),
        rt, rs_, [])
    assert _meta(got) == _meta(want)
    assert got.results == [] and got.n_txn == TXNS
