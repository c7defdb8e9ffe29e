"""Stacked analytical islands (`hopper@N`, `torch@N`) against the JAX
package's `pallas@N`, on the same numpy inputs.

Mirrors tests/test_sharded_backend.py and tests/test_sharded_view.py: the
row partition and its round trip, the stacked ShardedView and its
staleness, exact cross-shard reduction, the sharded operators on both port
inners, the apply and Phase-2 swap of islands that share one column (equal
to the reference's per-island apply, shard for shard), the "shard at pin,
once per round" snapshot plane with its cached join build side, and every
preset at N in {1, 2, 4} end to end (answers, final replica columns, stats,
modeled seconds and energy). Integers and the hardware model's floats:
tolerance 0.
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
from repro_torch.core import backend as backend_mod
from repro_torch.core import engine, htap, schema
from repro_torch.core.application import apply_updates
from repro_torch.core.backend import (BackendSpec, ShardedBackend,
                                      counting_kernel_calls, get_backend,
                                      parse_backend_spec, reduce_partials)
from repro_torch.core.consistency import ConsistencyManager
from repro_torch.core.dsm import (DSMReplica, EncodedColumn, ShardedView,
                                  StaleShardedViewError, column_from_numpy,
                                  column_to_numpy, concat_columns,
                                  decode_column, make_sharded_view,
                                  shard_bounds, shard_column,
                                  stack_shard_columns)
from repro_torch.core.nsm import make_entries
from repro_torch.core.session import HTAPSession, SystemSpec

torch.set_num_threads(1)
T = torch.from_numpy

ROWS, COLS, TXNS, QUERIES = 4000, 4, 8000, 12      # tests/conftest.py sizes
PRESETS = ["Polynesia", "MI+SW", "MI+SW+HB", "PIM-Only", "Ana-Only",
           "Ideal-Txn"]
INNERS = ("torch", "hopper")
GOLDEN = json.loads((pathlib.Path(__file__).parent /
                     "golden_answers.json").read_text())["results"]


def _pair(rng, n, domain=500, invalid_frac=0.15):
    """One random column in both packages: (reference, port)."""
    rcol = ref_dsm.encode_column(rng.integers(0, domain, n).astype(np.int32))
    if invalid_frac and n:
        rcol = ref_dsm.EncodedColumn(
            codes=rcol.codes, dictionary=rcol.dictionary,
            valid=rng.random(n) >= invalid_frac, version=rcol.version)
    return rcol, column_from_numpy(np.asarray(rcol.codes),
                                   np.asarray(rcol.dictionary),
                                   np.asarray(rcol.valid), rcol.version,
                                   device="cpu")


def _same_column(pcol, rcol):
    codes, dictionary, valid, version = column_to_numpy(pcol)
    np.testing.assert_array_equal(codes, np.asarray(rcol.codes))
    np.testing.assert_array_equal(dictionary, np.asarray(rcol.dictionary))
    np.testing.assert_array_equal(valid, np.asarray(rcol.valid))
    assert version == rcol.version


def _sharded(inner, k):
    return get_backend(inner, device="cpu", n_shards=k)


def _ref(k):
    return ref_backend_mod.get_backend("pallas", n_shards=k,
                                       placement="stacked")


# ---------------------------------------------------------------------------
# the row partition and the stacked view
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,k", [(0, 1), (1, 1), (7, 3), (100, 7), (5, 8),
                                 (4096, 4)])
def test_shard_bounds_partition(n, k):
    b = shard_bounds(n, k)
    assert b == ref_dsm.shard_bounds(n, k)
    assert b[0] == 0 and b[-1] == n and len(b) == k + 1
    assert len({hi - lo for lo, hi in zip(b, b[1:])}) <= 2
    with pytest.raises(ValueError):
        shard_bounds(n, 0)


@pytest.mark.parametrize("n,k", [(1000, 1), (1000, 3), (5, 8), (0, 2)])
def test_shard_concat_roundtrip(rng, n, k):
    rcol, col = _pair(rng, n)
    shards = shard_column(col, k)
    assert len(shards) == k
    for s, r in zip(shards, ref_dsm.shard_column(rcol, k)):
        assert s.dictionary is col.dictionary and s.version == col.version
        _same_column(s, r)
    back = concat_columns(shards)
    _same_column(back, rcol)
    if n:
        assert torch.equal(decode_column(back), decode_column(col))


def test_concat_rejects_mixed_rounds(rng):
    (_, a), (_, b) = _pair(rng, 50, domain=40), _pair(rng, 50, domain=60)
    with pytest.raises(ValueError, match="dictionary mismatch"):
        concat_columns([a, b])
    stale = EncodedColumn(codes=a.codes, dictionary=a.dictionary,
                          valid=a.valid, version=a.version + 1)
    with pytest.raises(ValueError, match="version mismatch"):
        concat_columns([a, stale])
    with pytest.raises(ValueError, match="version mismatch"):
        stack_shard_columns([a, stale])
    with pytest.raises(ValueError):
        concat_columns([])


@pytest.mark.parametrize("n,k", [(1000, 1), (1000, 3), (1000, 4), (100, 7),
                                 (5, 8), (0, 2)])
def test_sharded_view_mirrors_shard_column_and_the_reference(rng, n, k):
    rcol, col = _pair(rng, n)
    view = make_sharded_view(col, k)
    rview = ref_dsm.make_sharded_view(rcol, k)
    np.testing.assert_array_equal(view.codes.numpy(), rview.codes)
    np.testing.assert_array_equal(view.valid.numpy(), rview.valid)
    assert view.codes.dtype == torch.int32 and view.valid.dtype == torch.bool
    assert (view.bounds, view.sizes, view.width, view.n_rows) == \
        (rview.bounds, rview.sizes, rview.width, rview.n_rows)
    assert (view.encoded_bytes, view.bit_width, view.dict_size) == \
        (col.encoded_bytes, col.bit_width, col.dict_size)
    for s, ref in enumerate(shard_column(col, k)):
        got = view.shard(s)
        assert torch.equal(got.codes, ref.codes)
        assert torch.equal(got.valid, ref.valid)
        assert not view.valid[s, view.sizes[s]:].any()    # padding invalid
    _same_column(view.to_column(), rcol)
    np.testing.assert_array_equal(view.dict_counts().numpy(),
                                  rview.dict_counts())
    assert view.dict_counts().dtype == torch.int64
    # adopting per-island shards builds the same view
    adopted = stack_shard_columns(shard_column(col, k))
    assert torch.equal(adopted.codes, view.codes)
    assert torch.equal(adopted.valid, view.valid)


def test_backend_consumes_views_and_rejects_stale(rng):
    be = _sharded("torch", 4)
    base = get_backend("torch", device="cpu")
    (_, fcol), (_, acol) = _pair(rng, 777), _pair(rng, 777, domain=120)
    fv, av = be.shard_view(fcol), be.shard_view(acol)
    assert be.filter_agg(fv, av, 10, 400) == \
        base.filter_agg(fcol, acol, 10, 400)
    assert torch.equal(be.filter_mask(fv, 10, 400),
                       base.filter_mask(fcol, 10, 400))
    s, c, m = be.filter_agg_mask(fv, av, 10, 400)
    s0, c0, m0 = base.filter_agg_mask(fcol, acol, 10, 400)
    assert (s, c) == (s0, c0) and torch.equal(m, m0)
    assert be.hash_join_count(av, av, left_mask=m) == \
        base.hash_join_count(acol, acol, left_mask=m0)
    fv.invalidate("test says so")
    assert fv.stale
    with pytest.raises(StaleShardedViewError, match="test says so"):
        be.filter_agg(fv, av, 10, 400)
    with pytest.raises(StaleShardedViewError):
        fv.shard(0)
    with pytest.raises(StaleShardedViewError):
        fv.dict_counts()
    with pytest.raises(ValueError, match="islands"):
        _sharded("torch", 2).filter_agg(av, av, 10, 400)


# ---------------------------------------------------------------------------
# exact cross-shard reduction and the sharded operators
# ---------------------------------------------------------------------------

def test_reduce_partials_exact_beyond_float():
    big = (1 << 53) + 1
    for fn in (reduce_partials, ref_backend_mod.reduce_partials):
        assert fn("sum", [big, 1, big]) == 2 * big + 1
        assert fn("count", [0, 7]) == 7
        assert fn("sum", [None, 5, None]) == 5
        assert fn("min", [None, 9, 3]) == 3
        assert fn("max", [None, 9, 3]) == 9
        assert fn("min", [None, None]) is None
        with pytest.raises(ValueError, match="unknown aggregate"):
            fn("avg", [1])


@pytest.mark.parametrize("inner", INNERS)
@pytest.mark.parametrize("k", [2, 3, 8])
def test_sharded_operators_match_the_reference(rng, inner, k):
    be, ref = _sharded(inner, k), _ref(k)
    rf, pf = _pair(rng, 2000, domain=1 << 16)
    ra, pa = _pair(rng, 2000, domain=300)
    rj, pj = _pair(rng, 2000, domain=97)
    d = np.asarray(rf.dictionary)
    bounds = [(int(d[len(d) // 4]), int(d[3 * len(d) // 4])), (0, 1 << 24),
              (5, 4)]
    for lo, hi in bounds:
        assert be.filter_agg(pf, pa, lo, hi) == ref.filter_agg(rf, ra, lo, hi)
        np.testing.assert_array_equal(be.filter_mask(pf, lo, hi).numpy(),
                                      ref.filter_mask(rf, lo, hi))
        s, c, m = be.filter_agg_mask(pf, pa, lo, hi)
        rs, rc, rm = ref.filter_agg_mask(rf, ra, lo, hi)
        assert (s, c) == (rs, rc)
        np.testing.assert_array_equal(m.numpy(), rm)
    assert be.filter_agg_batch(pf, pa, bounds) == \
        ref.filter_agg_batch(rf, ra, bounds)
    assert be.filter_agg_join_batch(pf, pa, pj, bounds) == \
        ref.filter_agg_join_batch(rf, ra, rj, bounds)
    mask = rng.random(2000) < 0.4
    assert be.hash_join_count(pj, pj, left_mask=T(mask)) == \
        ref.hash_join_count(rj, rj, left_mask=mask)
    assert be.hash_join_count(pj, pa) == ref.hash_join_count(rj, ra)
    # the per-island partials themselves, one launch for all islands
    fv, av, jv = be.shard_view(pf), be.shard_view(pa), be.shard_view(pj)
    rfv, rav, rjv = (ref.shard_view(c) for c in (rf, ra, rj))
    code_bounds = [be.code_range(fv, lo, hi) for lo, hi in bounds]
    assert be.inner.scan_view(fv, av, code_bounds) == \
        ref.inner.scan_view(rfv, rav, code_bounds)
    assert be.inner.scan_view_join(fv, av, jv, code_bounds) == \
        ref.inner.scan_view_join(rfv, rav, rjv, code_bounds)


@pytest.mark.parametrize("inner", INNERS)
def test_more_shards_than_rows(rng, inner):
    base = get_backend(inner, device="cpu")
    be = _sharded(inner, 16)
    (_, f), (_, a) = _pair(rng, 5, invalid_frac=0.0), \
        _pair(rng, 5, invalid_frac=0.0)
    assert be.filter_agg(f, a, 0, 1 << 24) == base.filter_agg(f, a, 0, 1 << 24)
    assert be.filter_agg_join_batch(f, a, a, [(0, 1 << 24)]) == \
        base.filter_agg_join_batch(f, a, a, [(0, 1 << 24)])


def test_scan_group_is_one_call_whatever_the_island_count(small_workload):
    """A fused scan group is ONE kernel entry call however many islands
    share it (the leading-shard-axis launch), not one per shard."""
    table, _, _ = small_workload
    queries = engine.gen_queries(np.random.default_rng(5), 8, 4,
                                 join_fraction=0.0, same_column=True)
    jqueries = engine.gen_queries(np.random.default_rng(6), 8, 4,
                                  join_fraction=1.0, same_column=True)
    jqueries = [q for q in jqueries if q.join_col == jqueries[0].join_col]
    replica = DSMReplica.from_table(table, device="cpu")
    expected = [engine.run_query_dsm(replica.columns, q, backend=get_backend(
        "torch", device="cpu")) for q in queries + jqueries]
    for n in (1, 2, 4, 8):
        be = _sharded("hopper", n)
        view = replica.columns
        if n > 1:
            view = {c: be.shard_view(col)
                    for c, col in replica.columns.items()}
        with counting_kernel_calls() as counts:
            got = (engine.run_query_group_dsm(view, queries, backend=be)
                   + engine.run_query_group_dsm(view, jqueries, backend=be))
        assert got == expected
        assert sum(counts.get(k, 0) for k in (
            "scan_filter_agg", "scan_filter_agg_batch",
            "scan_filter_agg_sharded")) == 1, (n, counts)
        assert sum(counts.get(k, 0) for k in (
            "scan_filter_agg_join", "scan_filter_agg_join_sharded")) == 1


# ---------------------------------------------------------------------------
# apply and swap on islands that share one column
# ---------------------------------------------------------------------------

def _mixed_updates(rng, n, m, domain=500):
    ops = rng.choice([1, 2, 3], size=m, p=[0.6, 0.2, 0.2]).astype(np.int8)
    rows = rng.integers(0, n, m).astype(np.int64)
    rows[ops == 2] = n + rng.integers(0, 40, int((ops == 2).sum()))
    return make_entries(np.arange(m, dtype=np.int64), ops,
                        rng.integers(0, domain, m).astype(np.int32), rows,
                        np.zeros(m, dtype=np.int32))


@pytest.mark.parametrize("inner,k", [("torch", 4), ("torch", 7),
                                     ("hopper", 3), ("hopper", 4)])
def test_sharded_apply_matches_the_reference(rng, inner, k):
    rcol = ref_dsm.encode_column(rng.integers(0, 500, 300).astype(np.int32))
    col = column_from_numpy(np.asarray(rcol.codes),
                            np.asarray(rcol.dictionary),
                            np.asarray(rcol.valid), 0, device="cpu")
    ups = _mixed_updates(rng, 300, 96)
    got = apply_updates(col, ups, backend=_sharded(inner, k))
    _same_column(got, ref_application.apply_updates(rcol, ups,
                                                    backend=_ref(k)))
    _same_column(got, ref_application.apply_updates(rcol, ups,
                                                    backend="numpy"))
    # the reference applies per island; its shards are the islands' rows
    # of the one applied column, shard for shard
    rshards = ref_application.apply_updates_shards(rcol, ups,
                                                   backend=_ref(k))
    assert len(rshards) == k
    for s, r in zip(shard_column(got, k), rshards):
        _same_column(s, r)
    _same_column(concat_columns(shard_column(got, k)),
                 ref_dsm.concat_columns(rshards))


def test_shard_emptied_by_deletes_still_exact(rng):
    n, k = 400, 4
    rcol, col = _pair(rng, n, domain=99, invalid_frac=0.0)
    b = shard_bounds(n, k)
    doomed = np.arange(b[1], b[2], dtype=np.int64)
    ups = make_entries(np.arange(len(doomed), dtype=np.int64),
                       np.full(len(doomed), 3, np.int8),
                       np.zeros(len(doomed), np.int32), doomed,
                       np.zeros(len(doomed), np.int32))
    for inner in INNERS:
        got = apply_updates(col, ups, backend=_sharded(inner, k))
        _same_column(got, ref_application.apply_updates(rcol, ups,
                                                        backend="numpy"))
        assert _sharded(inner, k).filter_agg(got, got, 0, 1 << 24) == \
            get_backend(inner, device="cpu").filter_agg(got, got, 0, 1 << 24)


def test_per_shard_swap_all_or_none(rng):
    """One swap installs the new round for every island at once: a view
    pinned before it sees none of the batch on any island, a view pinned
    after it sees all of it on every island."""
    table = rng.integers(0, 50, size=(900, 2)).astype(np.int32)
    rep = DSMReplica.from_table(table, device="cpu")
    be = _sharded("hopper", 3)
    cons = ConsistencyManager(rep, backend=be)
    old = rep.columns[0]
    rows = np.array([5, 305, 899], np.int64)     # one row on each island
    ups = make_entries(np.arange(3, dtype=np.int64), np.ones(3, np.int8),
                       np.full(3, 77777, np.int32), rows,
                       np.zeros(3, np.int32))
    h_old = cons.begin_query([0])
    before = cons.read_scan(h_old, 0)
    cons.chains[0].dirty = False
    cons.on_update(0, apply_updates(old, ups, backend=be))
    assert cons.chains[0].dirty and rep.columns[0] is not old
    h_new = cons.begin_query([0])
    after = cons.read_scan(h_new, 0)
    for s, row in enumerate(rows):
        local = int(row) - after.bounds[s]
        assert int(after.dictionary[after.codes[s, local]]) == 77777
        assert int(before.dictionary[before.codes[s, local]]) == \
            int(table[row, 0])
    assert be.filter_agg(after, after, 77777, 77777) == (3 * 77777, 3)
    assert be.filter_agg(before, before, 77777, 77777) == (0, 0)
    cons.end_query(h_old)
    cons.end_query(h_new)


# ---------------------------------------------------------------------------
# the snapshot plane: shard at pin, once per round; invalidate at swap
# ---------------------------------------------------------------------------

def _mods(rng, n_rows, m, cid0):
    return make_entries(np.arange(cid0, cid0 + m, dtype=np.int64),
                        np.ones(m, np.int8),
                        rng.integers(0, 500, m).astype(np.int32),
                        rng.integers(0, n_rows, m).astype(np.int64),
                        np.zeros(m, np.int32))


def _replica(rng, n=600, cols=2):
    return DSMReplica.from_table(
        rng.integers(0, 200, size=(n, cols)).astype(np.int32), device="cpu")


def test_read_scan_shards_once_per_round(rng):
    rep = _replica(rng)
    be = _sharded("hopper", 3)
    cons = ConsistencyManager(rep, backend=be)
    h1 = cons.begin_query([0, 1])
    v1 = cons.read_scan(h1, 0)
    assert isinstance(v1, ShardedView) and v1.n_shards == 3
    assert v1.snapshot_id >= 0
    h2 = cons.begin_query([0])
    assert cons.read_scan(h2, 0) is v1
    assert (cons.views_built, cons.views_shared, cons.views_resident) == \
        (1, 1, 0)
    ref = get_backend("torch", device="cpu")
    assert be.filter_agg(v1, cons.read_scan(h1, 1), 0, 500) == \
        ref.filter_agg(cons.read(h1, 0), cons.read(h1, 1), 0, 500)
    cons.end_query(h1)
    cons.end_query(h2)
    one = ConsistencyManager(_replica(rng), backend=get_backend(
        "hopper", device="cpu"))
    h = one.begin_query([0])
    assert one.read_scan(h, 0) is one.read(h, 0) and one.views_built == 0


def test_swap_invalidates_unpinned_view_and_pinned_survives(rng):
    rep = _replica(rng)
    be = _sharded("torch", 2)
    ref = get_backend("torch", device="cpu")
    cons = ConsistencyManager(rep, backend=be)
    h = cons.begin_query([0])
    view = cons.read_scan(h, 0)
    frozen = ref.filter_agg(cons.read(h, 0), cons.read(h, 0), 0, 500)
    cons.on_update(0, apply_updates(rep.columns[0], _mods(rng, 600, 25, 0),
                                    backend=be))
    assert not view.stale                      # pinned: snapshot isolation
    assert be.filter_agg(view, view, 0, 500) == frozen
    cons.end_query(h)
    cons.on_update(0, apply_updates(rep.columns[0], _mods(rng, 600, 5, 100),
                                    backend=be))
    assert view.stale
    with pytest.raises(StaleShardedViewError, match="swapped out"):
        be.filter_agg_batch(view, view, [(0, 500)])
    h2 = cons.begin_query([0])
    v2 = cons.read_scan(h2, 0)
    assert v2 is not view and not v2.stale
    assert be.filter_agg(v2, v2, 0, 500) == \
        ref.filter_agg(cons.read(h2, 0), cons.read(h2, 0), 0, 500)
    cons.end_query(h2)


def test_join_build_side_cached_on_view(rng):
    rep = _replica(rng)
    be = _sharded("hopper", 3)
    ref = get_backend("torch", device="cpu")
    cons = ConsistencyManager(rep, backend=be)
    h = cons.begin_query([0, 1])
    view = cons.read_scan(h, 0)
    assert view._dict_counts is None
    expect = be.hash_join_count(view, view)
    assert expect == ref.hash_join_count(cons.read(h, 0), cons.read(h, 0))
    build = view._dict_counts
    assert build is not None
    mask = torch.zeros(view.n_rows, dtype=torch.bool)
    mask[::2] = True
    assert be.hash_join_count(view, view, left_mask=mask) == \
        ref.hash_join_count(cons.read(h, 0), cons.read(h, 0), left_mask=mask)
    assert be.filter_agg_join_batch(view, view, view, [(0, 100)]) == \
        ref.filter_agg_join_batch(cons.read(h, 0), cons.read(h, 0),
                                  cons.read(h, 0), [(0, 100)])
    assert view.dict_counts() is build
    np.testing.assert_array_equal(
        build.numpy(), np.bincount(cons.read(h, 0).codes.numpy(),
                                   minlength=view.dict_size))
    cons.end_query(h)
    cons.on_update(0, apply_updates(rep.columns[0], _mods(rng, 600, 10, 0),
                                    backend=be))
    with pytest.raises(StaleShardedViewError):
        view.dict_counts()


def test_gc_invalidates_the_views_of_dropped_versions(rng):
    rep = _replica(rng)
    be = _sharded("torch", 2)
    cons = ConsistencyManager(rep, backend=be)
    h = cons.begin_query([0])
    old_view = cons.read_scan(h, 0)
    cons.on_update(0, apply_updates(rep.columns[0], _mods(rng, 600, 4, 0),
                                    backend=be))
    h2 = cons.begin_query([0])               # a new snapshot: the new head
    cons.read_scan(h2, 0)
    cons.end_query(h)                        # the old version is collected
    assert old_view.stale and "garbage-collected" in old_view.stale_reason
    cons.end_query(h2)


# ---------------------------------------------------------------------------
# every preset at N in {1, 2, 4}, end to end
# ---------------------------------------------------------------------------

def _workload(mod, eng):
    rng = np.random.default_rng(0)
    sch = mod.make_schema("t", COLS, 32)
    table = mod.gen_table(rng, sch, ROWS)
    stream = mod.gen_update_stream(rng, sch, ROWS, TXNS, write_ratio=0.5)
    return table, stream, eng.gen_queries(rng, QUERIES, COLS)


@pytest.fixture(scope="module")
def workload():
    return _workload(schema, engine)


def _run_keeping_session(htap_mod, *args, **kwargs):
    """`htap_mod.run(*args, **kwargs)`, returning the RunResult and the
    finished session (its final replica columns are read afterwards)."""
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


def _final_columns(session) -> dict:
    """{col_id: (codes, dictionary, valid, version)} as numpy, or {} for a
    system without an analytical replica (Ideal-Txn)."""
    replica = getattr(session, "replica", None)
    if replica is None:
        return {}
    out = {}
    for c, col in replica.columns.items():
        if isinstance(col.codes, torch.Tensor):
            out[c] = column_to_numpy(col)
        else:
            out[c] = (np.asarray(col.codes), np.asarray(col.dictionary),
                      np.asarray(col.valid), col.version)
    return out


def _same_final_columns(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    for c, (codes, dictionary, valid, version) in want.items():
        g = got[c]
        np.testing.assert_array_equal(g[0], codes)
        np.testing.assert_array_equal(g[1], dictionary)
        np.testing.assert_array_equal(g[2], valid)
        assert g[3] == version


@pytest.fixture(scope="module")
def ref_runs():
    """(RunResult, final replica columns) of the reference's pallas@N."""
    table, stream, queries = _workload(ref_schema, ref_engine)
    cache = {}

    def get(name, n, n_rounds=4):
        if (name, n, n_rounds) not in cache:
            result, session = _run_keeping_session(
                ref_htap, name, table, stream, queries, n_rounds=n_rounds,
                backend="pallas", n_shards=n, placement="stacked",
                timing="phase",
                delta_store=False if name in ref_htap.PRESETS else None)
            cache[name, n, n_rounds] = (result, _final_columns(session))
        return cache[name, n, n_rounds]
    return get


@pytest.mark.parametrize("inner", INNERS)
@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("name", PRESETS)
def test_presets_match_reference_islands(workload, ref_runs, name, n, inner):
    table, stream, queries = workload
    got, session = _run_keeping_session(htap, name, table, stream, queries,
                                        n_rounds=4, backend=inner,
                                        n_shards=n, device="cpu")
    ref, ref_cols = ref_runs(name, n)
    assert got.results == [int(a) for a in ref.results]
    _same_final_columns(_final_columns(session), ref_cols)
    assert (name == "Ideal-Txn") == (not ref_cols)
    assert (got.name, got.n_txn, got.n_ana) == (ref.name, ref.n_txn, ref.n_ana)
    assert got.txn_seconds == ref.txn_seconds
    assert got.ana_seconds == ref.ana_seconds
    assert got.energy_joules == ref.energy_joules
    # every stat the reference reports, except its jit-trace ledger
    assert {k: v for k, v in got.stats.items() if k != "kernel_launches"} \
        == {k: v for k, v in ref.stats.items() if k != "traces"}
    if name in ("Polynesia", "MI+SW") and n > 1:
        assert got.stats["sharded_views"] > 0 and got.stats["islands"] == n


@pytest.mark.parametrize("spec", ["hopper@2", "torch@4"])
def test_islands_reproduce_the_golden_answers(workload, spec):
    table, stream, queries = workload
    for name in ("Polynesia", "PIM-Only", "Ana-Only"):
        res = htap.run(name, table, stream, queries, backend=spec,
                       device="cpu")
        assert res.results == GOLDEN[name], name


@pytest.mark.parametrize("inner", INNERS)
def test_uneven_islands_equal_one_island(workload, inner):
    """Three islands over 4,000 rows leave a padded slot in two of them;
    answers and final columns equal the one-island session's, and every
    pinned column was sharded into a padded stacked view."""
    table, stream, queries = workload
    one, one_session = _run_keeping_session(
        htap, "Polynesia", table, stream, queries, n_rounds=4,
        backend=inner, device="cpu")
    three, session = _run_keeping_session(
        htap, "Polynesia", table, stream, queries, n_rounds=4,
        backend=f"{inner}@3", device="cpu")
    assert three.results == one.results
    _same_final_columns(_final_columns(session), _final_columns(one_session))
    assert three.stats["sharded_views"] > 0
    view = make_sharded_view(session.replica.columns[0], 3)
    assert view.width * 3 > view.n_rows == ROWS


def test_island_sessions_keep_the_one_island_launch_count(workload):
    """End to end, hopper@4 calls no more kernel entries than hopper@1, and
    its scans are one call per query group, as on one island."""
    table, stream, queries = workload
    calls = {}
    for n in (1, 4):
        with counting_kernel_calls() as counts:
            htap.run("Polynesia", table, stream, queries, n_rounds=4,
                     backend="hopper", n_shards=n, device="cpu")
        calls[n] = dict(counts)
    scans = [sum(calls[n].get(k, 0) for k in (
        "scan_filter_agg", "scan_filter_agg_batch", "scan_filter_agg_sharded",
        "scan_filter_agg_join", "scan_filter_agg_join_sharded"))
        for n in (1, 4)]
    assert scans[0] == scans[1] > 0
    assert calls[4].get("scan_filter_agg_sharded", 0) > 0
    assert calls[4].get("scan_filter_agg_join_sharded", 0) > 0
    assert sum(calls[4].values()) <= sum(calls[1].values())


def test_ana_only_islands_shard_the_replica_once_and_probe(workload):
    table, _, queries = workload
    session = HTAPSession(SystemSpec.ana_only(backend="hopper@4"), table,
                          device="cpu")
    assert session.hw.n_ana_islands == 4 and session.islands == 4
    assert all(isinstance(v, ShardedView) for v in session._view.values())
    with counting_kernel_calls() as counts:
        session.query_batch(queries)
    assert counts.get("probe", 0) == sum(q.join_col is not None
                                         for q in queries)


# ---------------------------------------------------------------------------
# spec plumbing and what is left for later items
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", ["hopper", "torch@4", "hopper@4/stacked",
                                  "hopper/stacked", "@4", "", "hopper@",
                                  "hopper@4.0", "hopper@one", "hopper@0",
                                  "torch@-2", "hopper@4/ring", "hopper@4/"])
def test_spec_parsing_and_its_errors_match_the_reference(spec):
    try:
        want = ref_backend_mod.parse_backend_spec(spec)
    except (KeyError, ValueError) as err:
        with pytest.raises(type(err)):
            parse_backend_spec(spec)
    else:
        got = parse_backend_spec(spec)
        assert (got.name, got.n_shards, got.placement) == \
            (want.name, want.n_shards, want.placement)
        assert str(got) == str(want) == spec
        assert parse_backend_spec(got) is got


def test_get_backend_islands_and_conflicts():
    be = get_backend("hopper@4", device="cpu")
    assert isinstance(be, ShardedBackend)
    assert be.n_shards == 4 and be.name == "hopper@4"
    assert be.inner is get_backend("hopper", device="cpu")
    assert be.device == torch.device("cpu")
    assert get_backend("hopper", device="cpu", n_shards=4) is be  # one cache
    assert get_backend("hopper", device="cpu", n_shards=1) is \
        get_backend("hopper", device="cpu")
    assert get_backend(be) is be and get_backend(be, n_shards=4) is be
    with pytest.raises(ValueError, match="was requested"):
        get_backend(be, n_shards=2)
    with pytest.raises(ValueError, match="was requested"):
        get_backend(get_backend("torch", device="cpu"), n_shards=3)
    with pytest.raises(ValueError, match="contradicts"):
        get_backend("hopper@4", device="cpu", n_shards=2)
    with pytest.raises(ValueError, match="nest"):
        ShardedBackend(be, 2)
    with pytest.raises(ValueError):
        ShardedBackend("torch", 0, device="cpu")
    with pytest.raises(KeyError, match="unknown backend"):
        get_backend("cuda@4", device="cpu")
    with pytest.raises(ValueError, match="n_shards"):
        get_backend("torch", device="cpu", n_shards=0)
    assert BackendSpec("hopper", 4) == parse_backend_spec("hopper@4")
    with pytest.raises(ValueError):
        BackendSpec("hopper", 0)


def test_absent_island_count_means_one_island(monkeypatch):
    """No process-wide default and no environment variable: without a
    count in the spec or the argument a backend is one island."""
    monkeypatch.setenv("REPRO_SHARDS", "4")
    for name in ("torch", "hopper"):
        be = get_backend(name, device="cpu")
        assert not isinstance(be, ShardedBackend) and be.n_shards == 1
        assert get_backend(name, device="cpu", n_shards=None) is be
    assert SystemSpec.polynesia(backend="torch").n_shards is None
    assert not hasattr(backend_mod, "set_default_n_shards")


def test_island_delta_operators_name_their_roadmap_item(rng):
    """The islands' delta operators (ROADMAP item 9, once stubs) now
    answer, equal to the reference's pallas@2: the values scan and the
    values delta on the inner backend, the delta group in one sharded
    launch."""
    be, ref = _sharded("hopper", 2), _ref(2)
    rcol, col = _pair(rng, 10)
    assert be.filter_agg_delta_batch(col, col, [(0, 500)], None) == \
        be.filter_agg_batch(col, col, [(0, 500)]) == \
        ref.filter_agg_delta_batch(rcol, rcol, [(0, 500)], None)
    stack = np.stack([rng.integers(0, 500, 7), rng.integers(-9, 9, 7),
                      rng.integers(0, 2, 7), rng.integers(0, 500, 7),
                      rng.integers(-9, 9, 7), rng.integers(0, 2, 7)]
                     ).astype(np.int32)
    bounds = [(0, 1), (0, 500), (300, 100)]
    assert be.filter_agg_delta_batch(col, col, bounds, T(stack)) == \
        ref.filter_agg_delta_batch(rcol, rcol, bounds, stack)
    assert be.filter_agg_values_batch(T(stack[0]), T(stack[1]),
                                      T(stack[2]), bounds) == \
        ref.filter_agg_values_batch(stack[0], stack[1], stack[2], bounds)
    assert be.filter_agg_values_delta(T(stack), bounds) == \
        ref.filter_agg_values_delta(stack, bounds)
    assert be.filter_agg_values_delta(None, []) == []
    assert set(backend_mod.KERNEL_ENTRY_POINTS) >= {
        "scan_filter_agg_sharded", "scan_filter_agg_join_sharded", "probe",
        "probe_sharded", "build_table", "scan_values_agg",
        "scan_values_delta", "scan_filter_agg_group",
        "scan_filter_agg_group_sharded", "scan_filter_agg_join_group"}
