"""The port's operator surface: `HopperBackend` (on CPU tensors, i.e.
through the kernels' plain versions) == `TorchBackend` == the JAX package's
`PallasBackend`, operator by operator, on the same numpy inputs.

Integers throughout: tolerance 0.
"""

import numpy as np
import pytest
import torch

from repro.core import application as ref_application
from repro.core import backend as ref_backend_mod
from repro.core import dsm as ref_dsm
from repro.core import engine as ref_engine
from repro.core.consistency import ConsistencyManager as RefConsistency
from repro.core.shipping import ship_updates as ref_ship_updates
from repro_torch.core import backend as backend_mod
from repro_torch.core import engine
from repro_torch.core.application import (_last_write_per_row, apply_updates,
                                          apply_updates_naive,
                                          precompute_apply_stages)
from repro_torch.core.backend import (KERNEL_ENTRY_POINTS, counting_kernel_calls,
                                      get_backend)
from repro_torch.core.consistency import ConsistencyManager
from repro_torch.core.dsm import (DSMReplica, column_from_numpy,
                                  column_to_numpy, decode_column,
                                  encode_column, replica_from_numpy,
                                  value_range_to_code_range)
from repro_torch.core.nsm import make_entries
from repro_torch.core.shipping import merge_logs, ship_updates

torch.set_num_threads(1)

PORT_BACKENDS = ("torch", "hopper")


def port(name):
    return get_backend(name, device="cpu")


REF = ref_backend_mod.get_backend("pallas", n_shards=1, placement="stacked")


def _values(rng, n, k):
    pool = rng.choice(np.arange(0, 1 << 24, dtype=np.int32), size=k,
                      replace=False)
    return pool[rng.integers(0, k, size=n)]


def _columns(rng, n, k, invalid_frac=0.1):
    """The same column in both packages: (reference column, port column)."""
    rcol = ref_dsm.encode_column(_values(rng, n, k))
    if invalid_frac:
        valid = rng.random(n) >= invalid_frac
        rcol = ref_dsm.EncodedColumn(codes=rcol.codes,
                                     dictionary=rcol.dictionary, valid=valid,
                                     version=rcol.version)
    pcol = column_from_numpy(np.asarray(rcol.codes),
                             np.asarray(rcol.dictionary),
                             np.asarray(rcol.valid), rcol.version,
                             device="cpu")
    return rcol, pcol


def assert_same_column(pcol, rcol, msg=""):
    codes, dictionary, valid, version = column_to_numpy(pcol)
    np.testing.assert_array_equal(codes, np.asarray(rcol.codes), msg)
    np.testing.assert_array_equal(dictionary, np.asarray(rcol.dictionary), msg)
    np.testing.assert_array_equal(valid, np.asarray(rcol.valid), msg)
    assert version == rcol.version, msg
    assert codes.dtype == np.int32 and valid.dtype == bool


def _logs(rng, ids, n_cols=4, n_threads=4):
    logs = []
    for t in range(n_threads):
        mine = np.sort(ids[t::n_threads])
        logs.append(make_entries(
            mine, np.ones(len(mine), np.int8),
            rng.integers(0, 1000, len(mine)).astype(np.int32),
            rng.integers(0, 50, len(mine)).astype(np.int64),
            rng.integers(0, n_cols, len(mine)).astype(np.int32)))
    return logs


# ---------------------------------------------------------------------------
# state carried across + data model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,k", [(1, 1), (100, 7), (5000, 997)])
def test_encode_column_matches_reference(rng, n, k):
    values = _values(rng, n, k)
    rcol = ref_dsm.encode_column(values)
    pcol = encode_column(values, device="cpu")
    assert_same_column(pcol, rcol)
    np.testing.assert_array_equal(decode_column(pcol).numpy(), values)
    assert (pcol.n_rows, pcol.dict_size, pcol.bit_width, pcol.encoded_bytes,
            pcol.raw_bytes) == (rcol.n_rows, rcol.dict_size, rcol.bit_width,
                                rcol.encoded_bytes, rcol.raw_bytes)
    for lo, hi in [(0, 1 << 24), (int(values[0]), int(values[0])), (5, 4)]:
        assert (value_range_to_code_range(pcol, lo, hi)
                == ref_dsm.value_range_to_code_range(rcol, lo, hi))


def test_replica_carried_across_from_reference_state(rng):
    table = np.stack([_values(rng, 300, 9) for _ in range(3)], axis=1)
    rrep = ref_dsm.DSMReplica.from_table(table)
    state = {c: (np.asarray(col.codes), np.asarray(col.dictionary),
                 np.asarray(col.valid), col.version)
             for c, col in rrep.columns.items()}
    prep = replica_from_numpy(state, device="cpu")
    for c in rrep.columns:
        assert_same_column(prep.columns[c], rrep.columns[c])
    np.testing.assert_array_equal(prep.to_table(), table)
    built = DSMReplica.from_table(table, device="cpu")
    for c in rrep.columns:
        assert_same_column(built.columns[c], rrep.columns[c])
    assert (prep.n_rows, prep.n_cols, prep.encoded_bytes) == (
        rrep.n_rows, rrep.n_cols, rrep.encoded_bytes)


# ---------------------------------------------------------------------------
# analytical operators
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("be", PORT_BACKENDS)
@pytest.mark.parametrize("n,k", [(4096, 31), (5000, 997)])
def test_filter_agg_operators_match(rng, be, n, k):
    be = port(be)
    rf, pf = _columns(rng, n, k)
    ra, pa = _columns(rng, n, min(k, 257))
    d = np.asarray(rf.dictionary)
    bounds = [(int(d[k // 4]), int(d[3 * k // 4])), (0, 1 << 24), (5, 4)]
    for lo, hi in bounds:
        assert be.code_range(pf, lo, hi) == REF.code_range(rf, lo, hi)
        assert be.filter_agg(pf, pa, lo, hi) == REF.filter_agg(rf, ra, lo, hi)
        np.testing.assert_array_equal(be.filter_mask(pf, lo, hi).numpy(),
                                      REF.filter_mask(rf, lo, hi))
        s, c, mask = be.filter_agg_mask(pf, pa, lo, hi)
        rs, rc, rmask = REF.filter_agg_mask(rf, ra, lo, hi)
        assert (s, c) == (rs, rc)
        np.testing.assert_array_equal(mask.numpy(), rmask)
    assert be.filter_agg_batch(pf, pa, bounds) == \
        REF.filter_agg_batch(rf, ra, bounds)
    assert be.filter_agg_batch(pf, pa, bounds[:1]) == \
        REF.filter_agg_batch(rf, ra, bounds[:1])


@pytest.mark.parametrize("be", PORT_BACKENDS)
def test_join_operators_match(rng, be):
    be = port(be)
    rl, pl = _columns(rng, 3000, 101)
    rr, pr = _columns(rng, 2000, 211)
    ra, pa = _columns(rng, 3000, 40)
    mask = rng.random(3000) < 0.4
    tmask = torch.from_numpy(mask)
    assert be.hash_join_count(pl, pr) == REF.hash_join_count(rl, rr)
    assert be.hash_join_count(pl, pr, left_mask=tmask) == \
        REF.hash_join_count(rl, rr, left_mask=mask)
    assert be.hash_join_count(pl, pl, left_mask=tmask) == \
        REF.hash_join_count(rl, rl, left_mask=mask)
    d = np.asarray(rl.dictionary)
    bounds = [(int(d[10]), int(d[70])), (0, 1 << 24), (9, 3)]
    want = REF.filter_agg_join_batch(rl, ra, rl, bounds)
    assert be.filter_agg_join_batch(pl, pa, pl, bounds) == want
    # the fused join equals the per-query reference path of the base class
    assert want == backend_mod.ExecutionBackend.filter_agg_join_batch(
        be, pl, pa, pl, bounds)
    rcount = np.bincount(np.asarray(rl.codes)[np.asarray(rl.valid)],
                         minlength=rl.dict_size) + 1
    assert be.filter_agg_join_batch(pl, pa, pl, bounds,
                                    rcount=torch.from_numpy(rcount)) == \
        REF.filter_agg_join_batch(rl, ra, rl, bounds, rcount=rcount)


@pytest.mark.parametrize("be", PORT_BACKENDS)
@pytest.mark.parametrize("join_fraction", [0.0, 0.5, 1.0])
def test_query_groups_match_reference_engine(rng, be, join_fraction):
    table = np.stack([_values(rng, 2000, 32) for _ in range(4)], axis=1)
    rview = ref_dsm.DSMReplica.from_table(table).columns
    pview = DSMReplica.from_table(table, device="cpu").columns
    rqs = ref_engine.gen_queries(np.random.default_rng(3), 10, 4,
                                 join_fraction=join_fraction)
    pqs = engine.gen_queries(np.random.default_rng(3), 10, 4,
                             join_fraction=join_fraction)
    assert [(q.query_id, q.filter_col, q.lo, q.hi, q.agg_col, q.join_col)
            for q in pqs] == [(q.query_id, q.filter_col, q.lo, q.hi,
                               q.agg_col, q.join_col) for q in rqs]
    assert [[q.query_id for q in g] for g in engine.group_queries(pqs)] == \
        [[q.query_id for q in g] for g in ref_engine.group_queries(rqs)]
    for pg, rg in zip(engine.group_queries(pqs), ref_engine.group_queries(rqs)):
        got = engine.run_query_group_dsm(pview, pg, backend=port(be))
        assert got == ref_engine.run_query_group_dsm(rview, rg, backend="pallas")
        assert got == [engine.run_query_dsm(pview, q, backend=port(be))
                       for q in pg]
    assert engine.run_query_group_dsm(pview, [], backend=port(be)) == []


# ---------------------------------------------------------------------------
# update propagation operators
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("be", PORT_BACKENDS)
@pytest.mark.parametrize("ids", ["small", "beyond_int32", "one_thread",
                                 "empty"])
def test_merge_update_logs_matches(rng, be, ids):
    be = port(be)
    if ids == "small":
        cid = rng.permutation(np.arange(700, dtype=np.int64))
    elif ids == "beyond_int32":
        base = np.int64(2) ** 31
        cid = base + rng.choice(np.int64(10) ** 9, 600, replace=False)
        cid[:60] -= base
        rng.shuffle(cid)
    elif ids == "one_thread":
        cid = np.arange(50, dtype=np.int64)
    else:
        cid = np.empty(0, dtype=np.int64)
    logs = _logs(rng, cid, n_threads=1 if ids == "one_thread" else 4)
    got = be.merge_update_logs(logs)
    np.testing.assert_array_equal(got, REF.merge_update_logs(logs))
    np.testing.assert_array_equal(got, merge_logs(logs))
    np.testing.assert_array_equal(got["commit_id"], np.sort(cid))


@pytest.mark.parametrize("be", PORT_BACKENDS)
def test_ship_updates_equivalent_buffers(rng, be):
    logs = _logs(rng, rng.permutation(np.arange(600, dtype=np.int64)),
                 n_cols=6)
    got = ship_updates([l.copy() for l in logs], 6, backend=port(be))
    want = ref_ship_updates([l.copy() for l in logs], 6, backend="pallas")
    assert set(got) == set(want)
    for c in got:
        np.testing.assert_array_equal(got[c], want[c])


@pytest.mark.parametrize("be", PORT_BACKENDS)
@pytest.mark.parametrize("n_vals", [1, 700, 1024, 1500])
def test_sort_merge_encode_operators_match(rng, be, n_vals):
    be = port(be)
    vals = rng.integers(0, 1 << 20, size=n_vals).astype(np.int32)
    np.testing.assert_array_equal(be.sort_unique(vals).numpy(),
                                  REF.sort_unique(vals))
    old_d = np.unique(rng.integers(0, 1 << 20, size=300).astype(np.int32))
    upd_d = np.unique(rng.integers(0, 1 << 20, size=90).astype(np.int32))
    merged = be.merge_dictionaries(torch.from_numpy(old_d),
                                   torch.from_numpy(upd_d))
    want = REF.merge_dictionaries(old_d, upd_d)
    np.testing.assert_array_equal(merged.numpy(), want)
    assert merged.dtype == torch.int32
    sample = want[rng.integers(0, len(want), size=256)]
    np.testing.assert_array_equal(be.make_encoder(merged)(sample).numpy(),
                                  REF.make_encoder(want)(sample))
    np.testing.assert_array_equal(be.staged_encoder(merged)(sample).numpy(),
                                  REF.staged_encoder(want)(sample))
    for empty_side in ((old_d[:0], upd_d), (old_d, upd_d[:0])):
        np.testing.assert_array_equal(
            be.merge_dictionaries(*map(torch.from_numpy, empty_side)).numpy(),
            REF.merge_dictionaries(*empty_side))


@pytest.mark.parametrize("be", PORT_BACKENDS)
def test_batched_sort_and_merge_match(rng, be):
    be = port(be)
    sets = [rng.integers(0, 1 << 20, size=s).astype(np.int32)
            for s in (5, 300, 0, 1024)]
    sets.append(np.asarray([1 << 40, 3, 3], dtype=np.int64))   # beyond int32
    for got, want in zip(be.sort_unique_batch(sets),
                         REF.sort_unique_batch(sets)):
        np.testing.assert_array_equal(got.numpy(), want)
    pairs = [(np.unique(rng.integers(0, 1000, size=a)).astype(np.int32),
              np.unique(rng.integers(0, 1000, size=b)).astype(np.int32))
             for a, b in ((50, 20), (1, 1), (400, 3))]
    pairs.append((pairs[0][0], pairs[0][1][:0]))               # empty side
    got = be.merge_dictionaries_batch(
        [(torch.from_numpy(o), torch.from_numpy(u)) for o, u in pairs])
    for g, w in zip(got, REF.merge_dictionaries_batch(pairs)):
        np.testing.assert_array_equal(g.numpy(), w)


def _stage_columns(rng):
    per_column = []
    for _ in range(6):
        o = np.unique(rng.integers(0, 1 << 20,
                                   rng.integers(1, 800))).astype(np.int64)
        wv = rng.integers(0, 1 << 20, rng.integers(1, 260)).astype(np.int64)
        per_column.append((o, wv))
    # fallback rows: empty sides, a value beyond int32, and real values
    # equal to the int32.max pad sentinel on either side
    per_column.append((np.unique(rng.integers(0, 100, 20)).astype(np.int64),
                       np.empty(0, np.int64)))
    per_column.append((np.empty(0, np.int64),
                       rng.integers(0, 100, 13).astype(np.int64)))
    per_column.append((np.asarray([3, 9], np.int64),
                       np.asarray([1 << 40, 5], np.int64)))
    imax = np.iinfo(np.int32).max
    per_column.append((np.asarray([3, 9, imax], np.int64),
                       np.asarray([7, 5], np.int64)))
    per_column.append((np.asarray([3, 9], np.int64),
                       np.asarray([imax, 5, imax], np.int64)))
    return per_column


@pytest.mark.parametrize("be", PORT_BACKENDS)
@pytest.mark.parametrize("subset", ["all", "one_fusable", "only_fallbacks"])
def test_apply_stages_batch_matches_reference(rng, be, subset):
    """The fused ship-batch pipeline must reproduce the reference
    stage-for-stage, including the rows it routes to the fallback and the
    fewer-than-two-fusable-columns batch."""
    be = port(be)
    per_column = _stage_columns(rng)
    if subset == "one_fusable":
        per_column = per_column[5:]
    elif subset == "only_fallbacks":
        per_column = per_column[6:]
    got = be.apply_stages_batch(
        [(torch.from_numpy(o), wv) for o, wv in per_column])
    ref = REF.apply_stages_batch(per_column)
    assert len(got) == len(ref)
    for i, ((u_f, d_f, enc_f, m_f), (u_r, d_r, enc_r, m_r)) in enumerate(
            zip(got, ref)):
        np.testing.assert_array_equal(u_f.numpy(), u_r, f"col {i} update")
        np.testing.assert_array_equal(d_f.numpy(), d_r, f"col {i} merged")
        np.testing.assert_array_equal(m_f.numpy(), m_r, f"col {i} remap")
        probe_vals = per_column[i][1][:5]
        np.testing.assert_array_equal(enc_f(probe_vals).numpy(),
                                      enc_r(probe_vals), f"col {i} encode")


@pytest.mark.parametrize("be", PORT_BACKENDS)
@pytest.mark.parametrize("dtype", [np.int64, np.int32])
def test_update_dictionary_keeps_the_values_dtype(rng, be, dtype):
    """The update dictionary keeps the write values' dtype and the merged
    dictionary the old one's, on the fused path (>= 2 fusable columns) as
    on the fallbacks, as the reference's do."""
    per_column = [(o.astype(dtype), wv.astype(dtype))
                  for o, wv in _stage_columns(rng)[:6]]
    got = port(be).apply_stages_batch(
        [(torch.from_numpy(o), wv) for o, wv in per_column])
    for (u_f, d_f, _, _), (u_r, d_r, _, _) in zip(
            got, REF.apply_stages_batch(per_column)):
        assert u_f.numpy().dtype == u_r.dtype == dtype
        assert d_f.numpy().dtype == d_r.dtype == dtype


def test_hopper_backend_fuses_and_falls_back_like_the_reference(rng):
    """Which kernel entry each batch reaches (on any device): two fusable
    columns ride one fused call; one fusable column takes the sort unit and
    the dictionary merge on their own."""
    be = port("hopper")
    cols = [(torch.from_numpy(o), wv) for o, wv in _stage_columns(rng)]
    with counting_kernel_calls() as counts:
        be.apply_stages_batch(cols[:2])
    assert counts == {"apply_pipeline_batch": 1}
    with counting_kernel_calls() as counts:
        be.apply_stages_batch(cols[:1])
    assert counts == {"sort_1024": 1, "merge_sorted_runs": 1}
    with counting_kernel_calls() as counts:
        port("torch").apply_stages_batch(cols)
    assert counts == {}
    assert set(KERNEL_ENTRY_POINTS) >= {"apply_pipeline_batch", "sort_rows",
                                        "snapshot_copy", "scan_filter_agg_join"}
    for name in KERNEL_ENTRY_POINTS:
        assert callable(getattr(backend_mod, name))


# ---------------------------------------------------------------------------
# update application
# ---------------------------------------------------------------------------

def _entries(rng, m, n_rows, ops=(1,), col=0, cid0=0, row_hi=None):
    op = rng.choice(np.asarray(ops, np.int8), size=m)
    row = rng.integers(0, n_rows, m).astype(np.int64)
    if row_hi:      # inserts (op 2) append rows past the current end
        row = np.where(op == 2, rng.integers(n_rows, row_hi, m), row)
    return make_entries(np.arange(cid0, cid0 + m, dtype=np.int64), op,
                        rng.integers(0, 500, m).astype(np.int32), row,
                        np.full(m, col, dtype=np.int32))


@pytest.mark.parametrize("be", PORT_BACKENDS)
@pytest.mark.parametrize("ops,row_hi", [((1,), None), ((1, 3), None),
                                        ((1, 2, 3), 340), ((3,), None)],
                         ids=["modify", "modify_delete", "with_inserts",
                              "delete_only"])
def test_apply_updates_matches_reference(rng, be, ops, row_hi):
    base = rng.integers(0, 500, size=300).astype(np.int32)
    rcol = ref_dsm.encode_column(base)
    pcol = encode_column(base, device="cpu")
    ups = _entries(rng, 64, 300, ops=ops, row_hi=row_hi)
    got = apply_updates(pcol, ups, backend=port(be))
    assert_same_column(got, ref_application.apply_updates(
        rcol, ups, backend="pallas"))
    assert_same_column(apply_updates_naive(pcol, ups),
                       ref_application.apply_updates_naive(rcol, ups))
    # Phase 2 contract: the old column is untouched
    assert_same_column(pcol, rcol)


@pytest.mark.parametrize("be", PORT_BACKENDS)
def test_duplicate_row_writes_then_delete_in_one_batch(be):
    """Two writes to one cell in one batch (the later one wins), then a
    delete of that row - and a write after a delete, which stays deleted
    (writes land first, then deletes)."""
    base = np.asarray([10, 20, 30, 40, 50, 60], dtype=np.int32)
    rcol, pcol = ref_dsm.encode_column(base), encode_column(base, device="cpu")
    ups = make_entries(
        np.arange(7, dtype=np.int64),
        np.asarray([1, 1, 1, 3, 1, 3, 1], np.int8),
        np.asarray([111, 222, 333, 0, 444, 0, 555], np.int32),
        np.asarray([2, 2, 4, 2, 5, 1, 1], np.int64),
        np.zeros(7, np.int32))
    got = apply_updates(pcol, ups, backend=port(be))
    want = ref_application.apply_updates(rcol, ups, backend="pallas")
    assert_same_column(got, want)
    vals = decode_column(got).numpy()
    assert vals[2] == 222 and not got.valid[2]       # last write, then delete
    assert vals[1] == 555 and not got.valid[1]       # delete outlives a write
    assert_same_column(apply_updates_naive(pcol, ups),
                       ref_application.apply_updates_naive(rcol, ups))


@pytest.mark.parametrize("rows", [[], [5], [5, 5, 5], [1, 2, 1, 3, 2],
                                  [9, 8, 7]])
def test_last_write_per_row_keeps_the_winner_of_an_ordered_scatter(rows):
    rows = np.asarray(rows, dtype=np.int64)
    keep = _last_write_per_row(rows)
    target = np.full(10, -1)
    target[rows] = np.arange(len(rows))      # numpy: in order, last wins
    got = np.full(10, -1)
    got[rows[keep]] = keep
    np.testing.assert_array_equal(got, target)
    assert len(set(rows[keep].tolist())) == len(keep)


@pytest.mark.parametrize("be", PORT_BACKENDS)
def test_precomputed_stages_equal_per_column_stages(rng, be):
    table = np.stack([_values(rng, 400, 16) for _ in range(3)], axis=1)
    rrep = ref_dsm.DSMReplica.from_table(table)
    prep = DSMReplica.from_table(table, device="cpu")
    buffers = {c: _entries(rng, 40 + c, 400, ops=(1, 3), col=c)
               for c in (0, 2)}
    staged = precompute_apply_stages(prep.columns, buffers, backend=port(be))
    rstaged = ref_application.precompute_apply_stages(rrep.columns, buffers,
                                                      backend="pallas")
    assert set(staged) == set(rstaged) == {0, 2}
    for c in buffers:
        got = apply_updates(prep.columns[c], buffers[c], backend=port(be),
                            staged=staged[c])
        assert_same_column(got, ref_application.apply_updates(
            rrep.columns[c], buffers[c], backend="pallas", staged=rstaged[c]))
        assert_same_column(got, ref_application.apply_updates(
            rrep.columns[c], buffers[c], backend="numpy"))


# ---------------------------------------------------------------------------
# consistency
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("be", PORT_BACKENDS)
def test_snapshot_column_operator(rng, be):
    be = port(be)
    rcol, pcol = _columns(rng, 20_000, 63, invalid_frac=0.0)
    snap = be.snapshot_column(pcol)
    assert_same_column(snap, REF.snapshot_column(rcol))
    # carrying clean chunks from a previous snapshot must still equal src
    again = be.snapshot_column(pcol, prev=snap)
    assert_same_column(again, rcol)
    # a changed chunk, same dictionary: only that chunk is dirty
    codes = pcol.codes.clone()
    codes[9000] = (codes[9000] + 1) % 63
    moved = type(pcol)(codes=codes, dictionary=pcol.dictionary,
                       valid=pcol.valid, version=1)
    snap2 = be.snapshot_column(moved, prev=snap)
    assert torch.equal(snap2.codes, codes) and snap2.version == 1
    if be.name == "hopper":
        assert snap.codes.data_ptr() != pcol.codes.data_ptr()   # a copy
        assert snap.valid.data_ptr() == pcol.valid.data_ptr()   # aliased


@pytest.mark.parametrize("be", PORT_BACKENDS)
def test_consistency_manager_matches_reference(rng, be):
    table = rng.integers(0, 50, size=(9000, 3)).astype(np.int32)
    rrep = ref_dsm.DSMReplica.from_table(table)
    prep = DSMReplica.from_table(table, device="cpu")
    rcons = RefConsistency(rrep, backend="pallas")
    pcons = ConsistencyManager(prep, backend=port(be))
    rh, ph = rcons.begin_query([0, 1]), pcons.begin_query([0, 1])
    before = decode_column(pcons.read(ph, 0)).numpy().copy()
    ups = make_entries(np.array([0], np.int64), np.array([1], np.int8),
                       np.array([999_999], np.int32), np.array([5], np.int64),
                       np.array([0], np.int32))
    rcons.on_update(0, ref_application.apply_updates(rrep.columns[0], ups,
                                                     backend="pallas"))
    pcons.on_update(0, apply_updates(prep.columns[0], ups, backend=port(be)))
    # pinned snapshot is frozen; a fresh query sees the update
    np.testing.assert_array_equal(decode_column(pcons.read(ph, 0)).numpy(),
                                  before)
    assert_same_column(pcons.read(ph, 0), rcons.read(rh, 0))
    rh2, ph2 = rcons.begin_query([0]), pcons.begin_query([0])
    assert pcons.chain_lengths() == rcons.chain_lengths()
    rcons.end_query(rh), pcons.end_query(ph)
    assert int(decode_column(pcons.read(ph2, 0))[5]) == 999_999
    assert_same_column(pcons.read_scan(ph2, 0), rcons.read(rh2, 0))
    rcons.end_query(rh2), pcons.end_query(ph2)
    handles, view = pcons.pin_scan_group([[0, 2], [0, 2]])
    rhandles, rview = rcons.pin_scan_group([[0, 2], [0, 2]])
    for c in (0, 2):
        assert_same_column(view[c], rview[c])
    for h, r in zip(handles, rhandles):
        pcons.end_query(h), rcons.end_query(r)
    assert pcons.chain_lengths() == rcons.chain_lengths()
    assert (pcons.snapshots_created, pcons.snapshots_shared) == (
        rcons.snapshots_created, rcons.snapshots_shared)
