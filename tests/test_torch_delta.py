"""The delta-store update plane of the port against the JAX package's.

Mirrors tests/test_delta_store.py. Switching Phase 2 of update propagation
from the eager column rebuild to sorted per-column overlays, folded into
every query group as an exact correction and compacted every
``delta_capacity`` appended entries, must not change a single answer. Here
every MI preset x {torch, hopper} x islands {1, 2, 4} x capacities
{1, 64, default} runs on the port and must equal the reference's delta run
in answers, stats, modeled seconds and energy, final replica columns and
live overlays - and the reference's eager answers. Then the compaction
boundary, the fold of `compaction_entries`, the insert path (compact, then
apply eagerly), the golden answers, the spec guards, the entry-point calls
per query group, the engine's correction algebra and a hypothesis property.
Integers and the hardware model's floats: tolerance 0.
"""

import json
import pathlib

import numpy as np
import pytest
import torch

from repro.core import application as ref_application
from repro.core import backend as ref_backend_mod
from repro.core import dsm as ref_dsm
from repro.core import engine as ref_engine
from repro.core import htap as ref_htap
from repro.core import schema as ref_schema
from repro.core.session import HTAPSession as RefSession
from repro.core.session import resolve_spec as ref_resolve_spec
from repro_torch.core import engine, htap, schema
from repro_torch.core.application import (DELTA_ENTRY_BYTES, apply_updates,
                                          apply_updates_delta,
                                          compaction_entries, delta_eligible)
from repro_torch.core.backend import counting_kernel_calls, get_backend
from repro_torch.core.dsm import (ColumnDelta, column_from_numpy,
                                  column_to_numpy, decode_column, empty_delta)
from repro_torch.core.hwmodel import CostLog
from repro_torch.core.nsm import UPDATE_DTYPE
from repro_torch.core.session import (DELTA_CAPACITY_DEFAULT, HTAPSession,
                                      SystemSpec)
from repro_torch.core.workload import split_queries, split_stream

torch.set_num_threads(1)
T = torch.from_numpy

ROWS, COLS, TXNS, QUERIES = 4000, 4, 8000, 12      # tests/conftest.py sizes
N_ROUNDS = 4
MI = ["Polynesia", "MI+SW", "MI+SW+HB", "PIM-Only"]
INNERS = ("torch", "hopper")
CAPS = [1, 64, None]
HOPPER = get_backend("hopper", device="cpu")
GOLDEN = json.loads((pathlib.Path(__file__).parent /
                     "golden_answers.json").read_text())["results"]


def _workload(mod, eng, seed=0, delete_frac=0.05, rows=ROWS, txns=TXNS,
              queries=QUERIES, write_ratio=0.5):
    """The conftest workload, with a fraction of the writes turned into
    deletes so the overlay carries invalid rows and delete-only values."""
    rng = np.random.default_rng(seed)
    sch = mod.make_schema("t", COLS, 32)
    table = mod.gen_table(rng, sch, rows)
    stream = mod.gen_update_stream(rng, sch, rows, txns,
                                   write_ratio=write_ratio)
    qs = eng.gen_queries(rng, queries, COLS)
    if delete_frac:
        dels = (stream.op == 1) & (rng.random(len(stream)) < delete_frac)
        stream.op[dels] = 3
    return table, stream, qs


@pytest.fixture(scope="module")
def workload():
    return _workload(schema, engine)


def _run_keeping_session(htap_mod, *args, **kwargs):
    """`htap_mod.run(*args, **kwargs)` -> (RunResult, finished session)."""
    made = []

    class Kept(htap_mod.HTAPSession):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(htap_mod, "HTAPSession", Kept)
        result = htap_mod.run(*args, **kwargs)
    [session] = made
    return result, session


def _columns(session) -> dict:
    out = {}
    for c, col in session.replica.columns.items():
        if isinstance(col.codes, torch.Tensor):
            out[c] = column_to_numpy(col)
        else:
            out[c] = (np.asarray(col.codes), np.asarray(col.dictionary),
                      np.asarray(col.valid), col.version)
    return out


def _overlays(session) -> dict:
    return {c: (d.rows, d.values, d.valid, d.cids, d.n_base, d.n_entries)
            for c, d in session._deltas.items()}


def _same(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    for c, fields in want.items():
        for g, w in zip(got[c], fields):
            if isinstance(w, np.ndarray):
                assert g.dtype == w.dtype
                np.testing.assert_array_equal(g, w)
            else:
                assert g == w


@pytest.fixture(scope="module")
def ref_runs():
    """The reference's delta runs (RunResult, final columns, overlays) per
    (preset, islands, capacity), and its eager runs per preset."""
    table, stream, queries = _workload(ref_schema, ref_engine)
    cache = {}

    def get(name, n, cap, delta=True):
        key = (name, n, cap, delta)
        if key not in cache:
            result, session = _run_keeping_session(
                ref_htap, name, table, stream, queries, n_rounds=N_ROUNDS,
                backend="pallas", n_shards=n, placement="stacked",
                timing="phase", delta_store=delta, delta_capacity=cap)
            cache[key] = (result, _columns(session), _overlays(session))
        return cache[key]
    return get


def _stats(stats: dict) -> dict:
    return {k: v for k, v in stats.items()
            if k not in ("kernel_launches", "traces")}


# ---------------------------------------------------------------------------
# every MI preset x backend x island count x capacity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cap", CAPS, ids=["cap1", "cap64", "default"])
@pytest.mark.parametrize("inner", INNERS)
@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("name", MI)
def test_delta_plane_matches_reference(workload, ref_runs, name, n, inner,
                                       cap):
    table, stream, queries = workload
    got, session = _run_keeping_session(
        htap, name, table, stream, queries, n_rounds=N_ROUNDS,
        backend=inner, n_shards=n, device="cpu", delta_store=True,
        delta_capacity=cap)
    ref, ref_cols, ref_overlays = ref_runs(name, n, cap)
    eager, _, _ = ref_runs(name, 1, None, delta=False)
    assert got.results == [int(a) for a in ref.results]
    assert got.results == [int(a) for a in eager.results]
    assert _stats(got.stats) == _stats(ref.stats)
    assert got.stats["delta_appends"] > 0
    assert (got.txn_seconds, got.ana_seconds, got.energy_joules) == (
        ref.txn_seconds, ref.ana_seconds, ref.energy_joules)
    _same(_columns(session), ref_cols)
    _same(_overlays(session), ref_overlays)
    assert session.delta_capacity == (DELTA_CAPACITY_DEFAULT if cap is None
                                      else cap)


@pytest.mark.parametrize("spec", ["hopper", "hopper@4", "torch@2"])
def test_delta_plane_reproduces_the_golden_answers(spec):
    table, stream, queries = _workload(schema, engine, delete_frac=0.0)
    for name in ("Polynesia", "PIM-Only"):
        res = htap.run(name, table, stream, queries, backend=spec,
                       device="cpu", delta_store=True)
        assert res.results == GOLDEN[name], name
        assert res.stats["delta_appends"] > 0


@pytest.mark.parametrize("spec", ["hopper", "hopper@4"])
def test_folded_overlay_equals_the_eager_columns(workload, spec):
    """The delta session's base columns with the live overlay folded in
    decode to the eager session's columns - every row's value and
    validity (dictionaries may differ: compaction drops overwritten
    values)."""
    table, stream, queries = workload
    _, eager = _run_keeping_session(htap, "Polynesia", table, stream,
                                    queries, n_rounds=N_ROUNDS, backend=spec,
                                    device="cpu")
    res, delta = _run_keeping_session(htap, "Polynesia", table, stream,
                                      queries, n_rounds=N_ROUNDS,
                                      backend=spec, device="cpu",
                                      delta_store=True, delta_capacity=700)
    assert res.stats["compactions"] > 0 and res.stats["delta_live_entries"]
    for c, col in delta.replica.columns.items():
        vals, valid = decode_column(col).clone(), col.valid.clone()
        d = delta._deltas.get(c)
        if d is not None and d.n_overlay:
            rows = T(d.rows)
            vals[rows] = T(d.values)
            valid[rows] = T(d.valid)
        want = eager.replica.columns[c]
        assert torch.equal(vals, decode_column(want))
        assert torch.equal(valid, want.valid)


# ---------------------------------------------------------------------------
# compaction boundary and cadence
# ---------------------------------------------------------------------------

def _drive(table, stream, queries, **spec_kw):
    session = HTAPSession(SystemSpec.polynesia(**spec_kw), table,
                          device="cpu")
    for r, (chunk, qs) in enumerate(zip(split_stream(stream, N_ROUNDS),
                                        split_queries(queries, N_ROUNDS))):
        if r:
            session.advance_round()
        session.execute(chunk)
        session.query_batch(qs)
    return session, session.finish()


@pytest.mark.parametrize("backend", INNERS)
def test_compaction_capacity_boundary(workload, backend):
    """Compaction fires at exactly ``n_entries >= delta_capacity``: with
    the busiest column's raw entry count E as the capacity it folds that
    column, with E + 1 it never compacts; E is the reference's."""
    table, stream, queries = workload
    sess, res = _drive(table, stream, queries, backend=backend,
                       delta_store=True, delta_capacity=1 << 30)
    assert res.stats["compactions"] == 0
    raw = {c: d.n_entries for c, d in sess._deltas.items() if d.n_overlay}
    busiest, e = max(raw.items(), key=lambda kv: kv[1])
    assert e > 1

    rtable, rstream, rqueries = _workload(ref_schema, ref_engine)
    ref = RefSession(ref_resolve_spec("Polynesia", backend="numpy",
                                      n_shards=1, timing="phase",
                                      delta_store=True,
                                      delta_capacity=1 << 30), rtable)
    for r, (chunk, qs) in enumerate(zip(split_stream(rstream, N_ROUNDS),
                                        split_queries(rqueries, N_ROUNDS))):
        if r:
            ref.advance_round()
        ref.execute(chunk)
        ref.query_batch(qs)
    assert {c: d.n_entries for c, d in ref._deltas.items()
            if d.n_overlay} == raw

    at, res_at = _drive(table, stream, queries, backend=backend,
                        delta_store=True, delta_capacity=e)
    assert res_at.stats["compactions"] >= 1
    assert at._deltas[busiest].n_overlay == 0
    over, res_over = _drive(table, stream, queries, backend=backend,
                            delta_store=True, delta_capacity=e + 1)
    assert res_over.stats["compactions"] == 0
    assert over._deltas[busiest].n_entries == e
    assert res_at.results == res_over.results == res.results


@pytest.mark.parametrize("backend", ["torch", "hopper@2"])
def test_compact_every_append_drains_overlay(workload, backend):
    table, stream, queries = workload
    eager = htap.run("Polynesia", table, stream, queries, n_rounds=N_ROUNDS,
                     backend=backend, device="cpu")
    sess, res = _drive(table, stream, queries, backend=backend,
                       delta_store=True, delta_capacity=1)
    assert res.results == eager.results
    assert res.stats["compactions"] >= res.stats["delta_appends"] > 0
    assert res.stats["delta_live_entries"] == 0


# ---------------------------------------------------------------------------
# unit level: the overlay append, eligibility and the compaction fold
# ---------------------------------------------------------------------------

def _batch(rng, n_rows, m, cid0, domain=50, del_frac=0.2):
    entries = np.zeros(m, dtype=UPDATE_DTYPE)
    entries["row"] = rng.integers(0, n_rows, size=m)
    entries["value"] = rng.integers(-domain, domain, size=m)
    entries["commit_id"] = cid0 + np.arange(m)
    entries["op"] = np.where(rng.random(m) < del_frac, 3, 1)
    entries["col"] = 0
    return entries


def _decoded(col):
    return np.asarray(col.dictionary)[np.asarray(col.codes)]


@pytest.mark.parametrize("backend", ["torch", "hopper", "hopper@3"])
def test_overlay_appends_match_the_reference(rng, backend):
    """A run of batches over few rows - ties within and across batches,
    written-then-deleted and delete-only rows - builds the reference's
    overlay field for field, and prices the same cost events."""
    base = ref_dsm.encode_column(rng.integers(-50, 50, 60).astype(np.int32))
    col = column_from_numpy(np.asarray(base.codes),
                            np.asarray(base.dictionary),
                            np.asarray(base.valid), device="cpu")
    be = get_backend(backend, device="cpu")
    delta, rdelta = empty_delta(col), ref_dsm.empty_delta(base)
    for i in range(8):
        batch = _batch(rng, 60, int(rng.integers(1, 40)), 1000 * i)
        for on_pim in (True, False):
            cost, rcost = CostLog(), ref_application.CostLog()
            got = apply_updates_delta(col, delta, batch, cost, on_pim=on_pim,
                                      backend=be)
            want = ref_application.apply_updates_delta(
                base, rdelta, batch, rcost, on_pim=on_pim, backend="pallas")
            for f in ("rows", "values", "valid", "cids"):
                g, w = getattr(got, f), getattr(want, f)
                assert g.dtype == w.dtype
                np.testing.assert_array_equal(g, w)
            assert (got.n_base, got.n_entries) == (want.n_base,
                                                   want.n_entries)
            assert [e.__dict__ for e in cost.events] == \
                [e.__dict__ for e in rcost.events]
        delta, rdelta = got, want
    assert delta.n_overlay and not delta.valid.all()


def test_overlay_keeps_the_last_write_of_a_row_across_batches():
    col = column_from_numpy(np.zeros(5, np.int32), np.asarray([7], np.int32),
                            np.ones(5, bool), device="cpu")
    d = empty_delta(col)
    for cid, (row, val, op) in enumerate([(2, 10, 1), (2, 11, 1), (3, 0, 3),
                                          (2, 12, 1), (4, 13, 1), (4, 0, 3)]):
        e = np.zeros(1, dtype=UPDATE_DTYPE)
        e["row"], e["value"], e["op"], e["commit_id"] = row, val, op, cid
        d = apply_updates_delta(col, d, e, backend=HOPPER)
    assert d.rows.tolist() == [2, 3, 4]
    assert d.values.tolist() == [12, 7, 13]   # row 3 keeps its base value
    assert d.valid.tolist() == [True, False, False]
    assert d.cids.tolist() == [3, 2, 5] and d.n_entries == 6
    assert apply_updates_delta(col, d, np.zeros(0, UPDATE_DTYPE)) is d


def test_compaction_entries_fold_is_bit_exact():
    """Appending a batch to the overlay and folding it back through the
    standard apply lands on the eager column (decoded values and
    validity); the synthesized batch is the reference's."""
    rng = np.random.default_rng(7)
    for _ in range(5):
        vals = rng.integers(0, 50, size=200).astype(np.int32)
        rbase = ref_dsm.encode_column(vals)
        base = column_from_numpy(np.asarray(rbase.codes),
                                 np.asarray(rbase.dictionary),
                                 np.asarray(rbase.valid), device="cpu")
        entries = _batch(rng, 200, int(rng.integers(5, 60)), 0, domain=50,
                         del_frac=0.15)
        entries["value"] = np.abs(entries["value"])
        assert delta_eligible(entries, base.n_rows)
        eager = apply_updates(base, entries, backend=HOPPER)
        delta = apply_updates_delta(base, empty_delta(base), entries,
                                    backend=HOPPER)
        comp = compaction_entries(delta, 3)
        want = ref_application.compaction_entries(
            ref_application.apply_updates_delta(
                rbase, ref_dsm.empty_delta(rbase), entries), 3)
        assert comp.dtype == want.dtype
        np.testing.assert_array_equal(comp, want)
        folded = apply_updates(base, comp, backend=HOPPER)
        assert torch.equal(folded.valid, eager.valid)
        assert torch.equal(decode_column(folded), decode_column(eager))


def test_delta_eligibility_rejects_inserts_and_rows_past_the_base():
    entries = np.zeros(3, dtype=UPDATE_DTYPE)
    entries["op"] = 1
    assert delta_eligible(entries, 10)
    assert delta_eligible(entries[:0], 0)
    entries["op"][1] = 2
    assert not delta_eligible(entries, 10)
    assert delta_eligible(entries, 10) == \
        ref_application.delta_eligible(entries, 10)
    entries["op"][1] = 1
    entries["row"][2] = 10
    assert not delta_eligible(entries, 10)
    col = column_from_numpy(np.zeros(10, np.int32), np.zeros(1, np.int32),
                            np.ones(10, bool), device="cpu")
    with pytest.raises(ValueError, match="compact"):
        apply_updates_delta(col, empty_delta(col), entries, backend=HOPPER)
    assert DELTA_ENTRY_BYTES == ref_application.DELTA_ENTRY_BYTES


@pytest.mark.parametrize("backend", ["hopper", "torch@2"])
def test_inserts_compact_then_apply_eagerly(workload, backend):
    """A batch with inserts changes the column's length, which the overlay
    does not model: the session folds the live overlay first (a compact
    node), then applies the batch eagerly - as the reference does. The
    row store never makes inserts, so the batch (rows appended to every
    column, and writes) goes to each column's Phase 2 directly, on both
    sessions."""
    table, stream, queries = workload
    chunks = split_stream(stream, 2)
    sess = HTAPSession(SystemSpec.polynesia(backend=backend, delta_store=True),
                       table, device="cpu")
    ref = RefSession(ref_resolve_spec("Polynesia", backend="pallas",
                                      n_shards=sess.islands,
                                      placement="stacked", timing="phase",
                                      delta_store=True), table)
    rchunk = ref_schema.UpdateStream(*(getattr(chunks[0], f) for f in (
        "thread_id", "commit_id", "op", "row", "col", "value")))
    rqueries = [ref_engine.Query(q.query_id, q.filter_col, q.lo, q.hi,
                                 q.agg_col, q.join_col) for q in queries]
    sess.execute(chunks[0]), ref.execute(rchunk)
    assert sess.query_batch(queries) == \
        [int(a) for a in ref.query_batch(rqueries)]
    live = [c for c, d in sess._deltas.items() if d.n_overlay]
    assert live
    m = 40
    compactions = sess.compactions
    for col_id in range(COLS):
        entries = np.zeros(m, dtype=UPDATE_DTYPE)
        entries["commit_id"] = TXNS + np.arange(m)
        entries["op"] = np.where(np.arange(m) % 4 == 0, 2, 1)
        entries["row"] = np.where(entries["op"] == 2,
                                  ROWS + np.arange(m) // 4, np.arange(m) * 7)
        entries["value"] = np.arange(m) * 1000 + 3 + col_id
        entries["col"] = col_id
        sess._apply_column_delta(col_id, entries, "late:ship", sess.cost)
        ref._apply_column_delta(col_id, entries, "late:ship", ref.cost)
        assert sess._deltas[col_id].n_overlay == 0
        assert sess.replica.columns[col_id].n_rows == ROWS + m // 4
    assert sess.compactions == compactions + len(live) == ref.compactions
    _same(_columns(sess), _columns(ref))
    _same(_overlays(sess), _overlays(ref))
    assert sess.query_batch(queries) == \
        [int(a) for a in ref.query_batch(rqueries)]
    got, want = sess.finish(), ref.finish()
    assert _stats(got.stats) == _stats(want.stats)
    assert (got.txn_seconds, got.ana_seconds, got.energy_joules) == (
        want.txn_seconds, want.ana_seconds, want.energy_joules)


# ---------------------------------------------------------------------------
# spec guards and defaults
# ---------------------------------------------------------------------------

def test_delta_store_guards_match_the_reference():
    for factory, ref_factory in (
            (SystemSpec.ideal_txn, ref_htap.SystemSpec.ideal_txn),
            (SystemSpec.ana_only, ref_htap.SystemSpec.ana_only)):
        for f in (factory, ref_factory):
            with pytest.raises(ValueError, match="multiple-instance"):
                f(delta_store=True)
        assert factory(delta_store=False).delta_store is False
    for cap in (0, -3):
        for f in (SystemSpec.polynesia, ref_htap.SystemSpec.polynesia):
            with pytest.raises(ValueError, match="positive"):
                f(delta_capacity=cap)
    spec = SystemSpec.polynesia(delta_store=True, delta_capacity=64)
    assert (spec.delta_store, spec.delta_capacity) == (True, 64)
    assert DELTA_CAPACITY_DEFAULT == 4096


def test_delta_store_none_means_off_whatever_the_environment(workload,
                                                             monkeypatch):
    """No REPRO_DELTA / REPRO_DELTA_CAPACITY in the port: a run's plane is
    in its arguments."""
    table, stream, queries = workload
    monkeypatch.setenv("REPRO_DELTA", "1")
    monkeypatch.setenv("REPRO_DELTA_CAPACITY", "1")
    off = htap.run("Polynesia", table, stream, queries, n_rounds=N_ROUNDS,
                   backend="torch", device="cpu")
    assert "delta_appends" not in off.stats
    on = htap.run("Polynesia", table, stream, queries, n_rounds=N_ROUNDS,
                  backend="torch", device="cpu", delta_store=True)
    assert on.stats["compactions"] == 0 and on.results == off.results
    # the overrides reach the spec through htap.run
    spec = htap.resolve_spec("Polynesia", delta_store=True, delta_capacity=9)
    assert (spec.delta_store, spec.delta_capacity) == (True, 9)


# ---------------------------------------------------------------------------
# entry-point calls per query group, and the engine's algebra
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 4])
def test_entry_point_calls_equal_the_references(workload, n):
    """Per delta query group the port calls the reference's kernel entry
    points, as often - but for the port's folds, which give equal answers
    with fewer launches: K12 (flat or sharded) and K14 on one island, K12
    sharded on islands, where a join group is ONE call of the sharded join
    group (the reference: the sharded join scan and one or two values
    deltas, K13); and a one-column dictionary stage is one call of the
    fused apply (the reference: the sort unit and the merge unit)."""
    table, stream, queries = workload
    with counting_kernel_calls() as counts:
        htap.run("Polynesia", table, stream, queries, n_rounds=N_ROUNDS,
                 backend="hopper", n_shards=n, device="cpu",
                 delta_store=True, delta_capacity=700)
    rtable, rstream, rqueries = _workload(ref_schema, ref_engine)
    with ref_backend_mod.counting_kernel_calls() as rcounts:
        ref_htap.run("Polynesia", rtable, rstream, rqueries,
                     n_rounds=N_ROUNDS, backend="pallas", n_shards=n,
                     placement="stacked", timing="phase", delta_store=True,
                     delta_capacity=700)
    want = dict(rcounts)
    one_column = want.pop("sort_1024", 0) + want.pop("sort_rows", 0)
    assert one_column > 0
    want["apply_pipeline_batch"] = (want.get("apply_pipeline_batch", 0)
                                    + one_column)
    want["merge_sorted_runs"] -= one_column
    group = "scan_filter_agg_group" + ("_sharded" if n > 1 else "")
    assert counts.get(group, 0) > 0
    if n == 1:
        assert counts.get("scan_filter_agg_join_group", 0) > 0
    else:
        folded = counts.get("scan_filter_agg_join_group_sharded", 0)
        assert folded > 0
        assert folded <= want.pop("scan_values_delta") <= 2 * folded
        want["scan_filter_agg_join_sharded"] -= folded
        want["scan_filter_agg_join_group_sharded"] = folded
    assert dict(counts) == {k: v for k, v in want.items() if v}
    assert counts.get("scan_values_delta", 0) == 0


def _overlay_pair(rng, base_vals, m, del_frac=0.2, domain=300):
    """(port column, port overlay, reference column, reference overlay)."""
    rbase = ref_dsm.encode_column(base_vals)
    base = column_from_numpy(np.asarray(rbase.codes),
                             np.asarray(rbase.dictionary),
                             np.asarray(rbase.valid), device="cpu")
    delta, rdelta = empty_delta(base), ref_dsm.empty_delta(rbase)
    if m:
        batch = _batch(rng, len(base_vals), m, 0, domain=domain,
                       del_frac=del_frac)
        delta = apply_updates_delta(base, delta, batch, backend=HOPPER)
        rdelta = ref_application.apply_updates_delta(rbase, rdelta, batch)
    return base, delta, rbase, rdelta


def _np(x):
    return None if x is None else (x.numpy() if isinstance(x, torch.Tensor)
                                   else np.asarray(x))


@pytest.mark.parametrize("mf,ma,mj", [(30, 0, 0), (0, 25, 0), (0, 0, 40),
                                      (20, 30, 40), (0, 0, 0)])
def test_correction_stacks_equal_the_references(rng, mf, ma, mj):
    n = 400
    cols = [_overlay_pair(rng, rng.integers(-300, 300, n).astype(np.int32),
                          m) for m in (mf, ma, mj)]
    (bf, df, rbf, rdf), (ba, da, rba, rda), (bj, dj, rbj, rdj) = cols
    live = [d if d.n_overlay else None for d in (df, da, dj)]
    rlive = [d if d.n_overlay else None for d in (rdf, rda, rdj)]
    got, nr = engine._corr_stack(bf, ba, live[0], live[1])
    want, rnr = ref_engine._corr_stack(rbf, rba, rlive[0], rlive[1])
    assert nr == rnr
    if want is None:
        assert got is None
    else:
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    rc, c_eff = engine._join_eff_histogram(bj, live[2])
    rrc, rc_eff = ref_engine._join_eff_histogram(rbj, rlive[2])
    np.testing.assert_array_equal(rc.numpy(), rrc)
    probe = np.concatenate([np.asarray(rbj.dictionary),
                            rng.integers(-400, 400, 50)]).astype(np.int32)
    np.testing.assert_array_equal(c_eff(T(probe)).numpy(), rc_eff(probe))
    got_j, nr_j = engine._join_corr_stack(bf, bj, live[0], live[2], c_eff)
    want_j, rnr_j = ref_engine._join_corr_stack(rbf, rbj, rlive[0], rlive[2],
                                                rc_eff)
    assert nr_j == rnr_j
    np.testing.assert_array_equal(_np(got_j), want_j)


def test_delta_reads_need_the_base_columns(rng):
    base, delta, _, _ = _overlay_pair(rng, np.arange(50, dtype=np.int32), 9)
    q = [engine.Query(0, 0, 0, 100, 0)]
    with pytest.raises(ValueError, match="base_cols"):
        engine.run_query_group_dsm({0: base}, q, backend=HOPPER,
                                   deltas={0: delta})
    # an empty overlay is no correction and needs none
    assert engine.run_query_group_dsm(
        {0: base}, q, backend=get_backend("torch", device="cpu"),
        deltas={0: empty_delta(base)}) == \
        engine.run_query_group_dsm({0: base}, q,
                                   backend=get_backend("torch", device="cpu"))


def test_overlay_device_copy_is_made_once(rng):
    _, delta, _, _ = _overlay_pair(rng, np.arange(80, dtype=np.int32), 30)
    rows, vals, valid = delta.on("cpu")
    assert (rows.dtype, vals.dtype, valid.dtype) == (torch.int64, torch.int32,
                                                     torch.bool)
    assert delta.on(torch.device("cpu"))[0] is rows
    np.testing.assert_array_equal(rows.numpy(), delta.rows)
    assert isinstance(delta, ColumnDelta) and delta.n_overlay == len(rows)


# ---------------------------------------------------------------------------
# property: random workloads and cadences
# ---------------------------------------------------------------------------

def test_property_delta_matches_eager_random_workloads():
    """Hypothesis sweep: random write and delete ratios, commit rates and
    compaction cadences (down to 1 = compact on every append). The port's
    delta run on the kernel backend equals its eager run and the
    reference's delta run."""
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings, strategies as st

    @settings(max_examples=8, deadline=None)
    @given(seed=st.integers(0, 2**16), write_pct=st.integers(10, 90),
           del_pct=st.integers(0, 30), n_txn=st.integers(200, 1500),
           capacity=st.sampled_from([1, 7, 64, 4096]),
           spec=st.sampled_from(["hopper", "hopper@3", "torch"]))
    def prop(seed, write_pct, del_pct, n_txn, capacity, spec):
        kw = dict(seed=seed, delete_frac=del_pct / 100, rows=500, txns=n_txn,
                  queries=5, write_ratio=write_pct / 100)
        table, stream, queries = _workload(schema, engine, **kw)
        rtable, rstream, rqueries = _workload(ref_schema, ref_engine, **kw)
        eager = htap.run("Polynesia", table, stream, queries, n_rounds=3,
                         backend=spec, device="cpu")
        delta = htap.run("Polynesia", table, stream, queries, n_rounds=3,
                         backend=spec, device="cpu", delta_store=True,
                         delta_capacity=capacity)
        ref = ref_htap.run("Polynesia", rtable, rstream, rqueries,
                           n_rounds=3, backend="numpy",
                           n_shards=get_backend(spec, device="cpu").n_shards,
                           placement="stacked", timing="phase",
                           delta_store=True, delta_capacity=capacity)
        assert delta.results == eager.results == [int(a) for a in
                                                  ref.results]
        assert _stats(delta.stats) == _stats(ref.stats)

    prop()
