"""The port's hash lookup unit (bucket table + probe, flat and sharded) vs
the JAX package's, on the same numpy inputs.

Integers throughout: tolerance 0. The reference runs as its own tests run
it on the CPU: the jitted lowering by default, Pallas interpret mode for the
small kernel-semantics cases.
"""

import numpy as np
import pytest
import torch

from repro.kernels import common as ref_common
from repro.kernels.hash_probe import (EMPTY_KEY as REF_EMPTY,
                                      build_table as ref_build_table,
                                      probe as ref_probe,
                                      probe_sharded as ref_probe_sharded)
from repro_torch.core.backend import get_backend
from repro_torch.kernels.hash_probe import (EMPTY, build_table, probe,
                                            probe_ref, probe_sharded)

torch.set_num_threads(1)
T = torch.from_numpy
I32_MIN, I32_MAX = np.iinfo(np.int32).min, np.iinfo(np.int32).max


@pytest.fixture
def interpret_mode():
    yield ref_common.set_interpret_override
    ref_common.set_interpret_override(None)


def _keys(rng, n, lo=0, hi=1 << 20):
    return rng.choice(np.arange(lo, hi, dtype=np.int64), size=n,
                      replace=False).astype(np.int32)


def _queries(rng, keys, n_queries, lo=0, hi=1 << 20):
    half = keys[: len(keys) // 2]
    rest = rng.integers(lo, hi, size=n_queries - len(half)).astype(np.int32)
    return np.concatenate([half, rest])


@pytest.mark.parametrize("n_keys", [0, 1, 10, 500, 2000, 5000])
@pytest.mark.parametrize("sign", ["positive", "negative"])
def test_build_table_arrays_equal_the_reference(rng, n_keys, sign):
    keys = (_keys(rng, n_keys) if sign == "positive"
            else _keys(rng, n_keys, -(1 << 20), 1 << 20))
    vals = rng.integers(-1000, 1000, size=n_keys).astype(np.int32)
    got, want = build_table(keys, vals), ref_build_table(keys, vals)
    np.testing.assert_array_equal(got.keys, want.keys)
    np.testing.assert_array_equal(got.values, want.values)
    assert got.keys.dtype == got.values.dtype == np.int32
    assert got.n_buckets == want.n_buckets and got.keys.shape[1] % 4 == 0
    assert EMPTY == int(REF_EMPTY)


# the reference's sweep (tests/test_kernels.py) plus negative keys
@pytest.mark.parametrize("n_keys,n_queries", [(10, 64), (500, 1000),
                                              (2000, 4096), (7, 5)])
@pytest.mark.parametrize("sign", ["positive", "negative"])
def test_probe_matches_reference(rng, n_keys, n_queries, sign):
    lo = 0 if sign == "positive" else -(1 << 20)
    keys = _keys(rng, n_keys, lo)
    vals = rng.integers(0, 1000, size=n_keys).astype(np.int32)
    qs = _queries(rng, keys, n_queries, lo)
    table = build_table(keys, vals)
    got = probe(table, T(qs), default=-7)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(ref_probe(ref_build_table(keys, vals), qs,
                                          default=-7)))
    kv = dict(zip(keys.tolist(), vals.tolist()))
    np.testing.assert_array_equal(
        got.numpy(), [kv.get(int(q), -7) for q in qs])


@pytest.mark.parametrize("case", ["empty_query", "int32_extremes",
                                  "no_queries"])
def test_probe_edge_queries(rng, case):
    keys = np.concatenate([_keys(rng, 40, -5000, 5000),
                           [I32_MAX, I32_MIN + 1]]).astype(np.int32)
    vals = rng.integers(1, 1000, size=len(keys)).astype(np.int32)
    if case == "empty_query":
        # a query equal to EMPTY hits the free slots (value 0)
        qs = np.asarray([EMPTY, keys[0], EMPTY, 12345], dtype=np.int32)
    elif case == "int32_extremes":
        qs = np.asarray([I32_MAX, I32_MIN + 1, I32_MIN + 2, -1, 0],
                        dtype=np.int32)
    else:
        qs = np.empty(0, dtype=np.int32)
    got = probe(build_table(keys, vals), T(qs), default=-1)
    want = np.asarray(ref_probe(ref_build_table(keys, vals), qs, default=-1))
    np.testing.assert_array_equal(got.numpy(), want)
    if case == "empty_query":
        assert got[0] == 0 and got[2] == 0


@pytest.mark.parametrize("n_keys,n_queries", [(10, 64), (300, 513)])
def test_probe_vs_pallas_interpret(rng, interpret_mode, n_keys, n_queries):
    """The kernel-semantics oracle: the reference's Pallas kernel itself."""
    keys = _keys(rng, n_keys, -(1 << 16), 1 << 16)
    vals = rng.integers(0, 1000, size=n_keys).astype(np.int32)
    qs = _queries(rng, keys, n_queries, -(1 << 16), 1 << 16)
    qs[-1] = EMPTY
    interpret_mode("1")
    want = np.asarray(ref_probe(ref_build_table(keys, vals), qs, default=-3))
    want_sh = ref_probe_sharded(ref_build_table(keys, vals),
                                [qs[:7], qs, qs[:0]], default=-3)
    interpret_mode(None)
    table = build_table(keys, vals)
    np.testing.assert_array_equal(probe(table, T(qs), default=-3).numpy(),
                                  want)
    for g, w in zip(probe_sharded(table, [T(qs[:7]), T(qs), T(qs[:0])],
                                  default=-3), want_sh):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("lens", [(0, 3, 700, 64), (5,), (0, 0), (1, 1, 1, 1),
                                  (1024, 1025)])
def test_probe_sharded_matches_reference_and_per_island_probe(rng, lens):
    keys = _keys(rng, 300, -(1 << 20))
    vals = rng.integers(0, 1000, size=300).astype(np.int32)
    batches = [rng.choice(np.concatenate([keys, rng.integers(
        -(1 << 20), 1 << 20, m).astype(np.int32)]), size=m).astype(np.int32)
        if m else np.empty(0, np.int32) for m in lens]
    table = build_table(keys, vals)
    got = probe_sharded(table, [T(b) for b in batches], default=-7)
    want = ref_probe_sharded(ref_build_table(keys, vals), batches, default=-7)
    assert len(got) == len(batches)
    for b, g, w in zip(batches, got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(
            g.numpy(), probe(table, T(b), default=-7).numpy())


def test_probe_ref_takes_stacked_queries(rng):
    keys = _keys(rng, 64)
    table = build_table(keys, np.arange(64, dtype=np.int32))
    kt, vt = table.on("cpu")
    assert table.on("cpu")[0] is kt            # copied once per device
    qs = T(np.stack([keys[:16], keys[16:32][::-1].copy()]))
    got = probe_ref(kt, vt, qs)
    assert got.shape == (2, 16)
    np.testing.assert_array_equal(got[0].numpy(), np.arange(16))
    np.testing.assert_array_equal(got[1].numpy(), np.arange(31, 15, -1))


def test_hash_unit_operators_fall_back_like_the_reference(rng):
    """The backend's hash-unit users: lone-join matching and the encoder
    take the table unless a dictionary holds EMPTY (the free-slot key) or
    a side is empty - the reference's fallbacks - with equal answers."""
    from repro.core.backend import get_backend as ref_get_backend
    ref = ref_get_backend("pallas", n_shards=1, placement="stacked")
    be = get_backend("hopper", device="cpu")
    for d in (np.sort(_keys(rng, 50, -500, 500)),
              np.concatenate([[EMPTY], np.sort(_keys(rng, 9))]),
              np.empty(0, np.int32)):
        d = d.astype(np.int32)
        lc = rng.integers(0, 9, size=len(d)).astype(np.int64)
        rc = rng.integers(0, 9, size=len(d)).astype(np.int64)
        got = be._join_match(T(d), T(d[::2].copy()), T(lc), T(rc[::2].copy()))
        assert got == ref._join_match(d, d[::2], lc, rc[::2])
        if len(d):
            enc = be.make_encoder(T(d))
            assert hasattr(enc, "_table") == (EMPTY not in d)
            vals = d[rng.integers(0, len(d), 30)]
            np.testing.assert_array_equal(enc(vals).numpy(),
                                          ref.make_encoder(d)(vals))
            got_sh = be.encode_values_shards(enc, [vals[:3], vals, vals[:0]])
            for g, w in zip(got_sh, ref.encode_values_shards(
                    ref.make_encoder(d), [vals[:3], vals, vals[:0]])):
                np.testing.assert_array_equal(g.numpy(), w)


def _join_column(rng, n, k, extra=()):
    """One column in both packages (reference, port); `extra` values are
    written into its first rows, so they join its dictionary."""
    from repro.core import dsm as ref_dsm
    from repro_torch.core.dsm import column_from_numpy
    vals = rng.integers(-k, k, size=n).astype(np.int32)
    vals[:len(extra)] = extra
    rcol = ref_dsm.encode_column(vals)
    valid = rng.random(n) >= 0.1
    rcol = ref_dsm.EncodedColumn(codes=rcol.codes, dictionary=rcol.dictionary,
                                 valid=valid, version=rcol.version)
    pcol = column_from_numpy(np.asarray(rcol.codes),
                             np.asarray(rcol.dictionary), valid,
                             rcol.version, device="cpu")
    return rcol, pcol


@pytest.fixture
def tables(monkeypatch):
    """The dictionaries the lone joins built a bucket table over."""
    from repro_torch.core import dsm
    built = []
    real = dsm.build_table

    def counting(keys, values, *a, **kw):
        built.append(np.array(keys))
        return real(keys, values, *a, **kw)

    monkeypatch.setattr(dsm, "build_table", counting)
    return built


def _ref_backend():
    from repro.core.backend import get_backend as ref_get_backend
    return ref_get_backend("pallas", n_shards=1, placement="stacked")


@pytest.mark.parametrize("spec", ["hopper", "hopper@4"])
def test_lone_joins_build_one_table_per_dictionary(rng, tables, spec):
    """Repeated lone joins probe the table cached with the right column's
    dictionary: two dictionaries, two tables, whatever the number of
    queries; a column carrying the same dictionary (a snapshot, a sharded
    view) reuses it; the answers equal the reference's exactly."""
    be, ref = get_backend(spec, device="cpu"), _ref_backend()
    (ra, pa), (rb, pb) = _join_column(rng, 3000, 400), \
        _join_column(rng, 2000, 700)
    for _ in range(3):
        mask = rng.random(3000) < 0.5
        for (rl, pl), (rr, pr) in (((ra, pa), (ra, pa)),
                                   ((ra, pa), (rb, pb)),
                                   ((rb, pb), (ra, pa))):
            lm = mask[:len(rl.codes)]
            assert be.hash_join_count(pl, pr, left_mask=T(lm)) == \
                ref.hash_join_count(rl, rr, left_mask=lm)
    snap = be.snapshot_column(pa) if spec == "hopper" else be.shard_view(pa)
    assert be.hash_join_count(snap, snap) == ref.hash_join_count(ra, ra)
    assert [len(d) for d in tables] == [len(np.asarray(ra.dictionary)),
                                        len(np.asarray(rb.dictionary))]


def test_a_new_dictionary_gets_its_own_table(rng, tables):
    """A column with another dictionary (same length, other values) never
    probes a table cached for the first: the cache lives with the
    dictionary."""
    be, ref = get_backend("hopper", device="cpu"), _ref_backend()
    ra, pa = _join_column(rng, 1000, 300)
    rb, pb = _join_column(np.random.default_rng(99), 1000, 300)
    assert be.hash_join_count(pa, pa) == ref.hash_join_count(ra, ra)
    assert be.hash_join_count(pb, pb) == ref.hash_join_count(rb, rb)
    assert be.hash_join_count(pa, pb) == ref.hash_join_count(ra, rb)
    assert len(tables) == 2
    np.testing.assert_array_equal(tables[1], np.asarray(rb.dictionary))
    assert pa.probe_table() is not pb.probe_table()


def test_a_dictionary_holding_empty_keeps_the_binary_search(rng, tables,
                                                             monkeypatch):
    """EMPTY_KEY (the free-slot key) in the right dictionary: no table, no
    probe, the binary search - decided once for the dictionary. In the left
    dictionary only: the table, with EMPTY_KEY matching nothing."""
    from repro_torch.core import backend as backend_mod
    probes = []
    real = backend_mod.probe
    monkeypatch.setattr(backend_mod, "probe",
                        lambda *a, **kw: probes.append(1) or real(*a, **kw))
    be, ref = get_backend("hopper", device="cpu"), _ref_backend()
    re_, pe = _join_column(rng, 800, 50, extra=(EMPTY, EMPTY, 7))
    rp, pp = _join_column(rng, 800, 50, extra=(7,))
    for _ in range(2):
        assert be.hash_join_count(pp, pe) == ref.hash_join_count(rp, re_)
    assert probes == [] and tables == []
    assert pe.probe_table() is None and tables == []
    assert be.hash_join_count(pe, pp) == ref.hash_join_count(re_, rp)
    assert len(probes) == 1 and len(tables) == 1


@pytest.mark.parametrize("spec", ["hopper", "hopper@4"])
def test_ana_only_builds_a_table_per_joined_dictionary(spec):
    """`Ana-Only` answers each lone query over the initial table: its joins
    build at most one table per distinct join column, not one a query, and
    answer as the reference."""
    from repro.core import engine as ref_engine, htap as ref_htap
    from repro.core import schema as ref_schema
    from repro_torch.core import engine, htap, schema
    from repro_torch.kernels.hash_probe import tables_built

    def workload(sch_mod, eng_mod):
        rng = np.random.default_rng(5)
        sch = sch_mod.make_schema("t", 4, 32)
        table = sch_mod.gen_table(rng, sch, 3000)
        return table, eng_mod.gen_queries(rng, 24, 4, join_fraction=0.75)

    table, queries = workload(schema, engine)
    before = tables_built()
    got = htap.run("Ana-Only", table, queries=queries, backend=spec,
                   device="cpu").results
    joined = {q.join_col for q in queries if q.join_col is not None}
    assert 0 < tables_built() - before <= len(joined) < \
        sum(q.join_col is not None for q in queries)
    ref_table, ref_queries = workload(ref_schema, ref_engine)
    want = ref_htap.run("Ana-Only", ref_table, queries=ref_queries,
                        backend="pallas").results
    assert got == [int(a) for a in want]
