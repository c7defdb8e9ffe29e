"""The mesh scans (K15), the per-island apply and the all-or-none Phase-2
swap of the port, against the JAX package on the same numpy inputs.

The reference's mesh scan needs one device per island, so at one island it
runs in process (``scan_filter_agg_mesh`` over a 1-device mesh), and at
N in {2, 3, 4} the port's cross-island totals are held against the
reference's stacked scan of the same shards reduced with its
`reduce_partials` - the totals its psum'd mesh scan returns. Islands are
CPU tensors (``devices=["cpu"] * N``), so the wrappers run their plain
versions; a rehearsal with the wrappers' GPU branch patched onto the CPU
shows the launch accounting (one launch per island, under the flat scan's
names). Integers: tolerance 0.
"""

import numpy as np
import pytest
import torch

from repro.core import application as ref_application
from repro.core import backend as ref_backend_mod
from repro.core import dsm as ref_dsm
from repro.distributed import island_mesh as ref_island_mesh
from repro.kernels.dict_ops import scan_filter_agg_mesh as ref_scan_mesh
from repro.kernels.dict_ops import \
    scan_filter_agg_sharded as ref_scan_sharded
from repro.kernels.hash_probe import scan_filter_agg_join_mesh as ref_join_mesh
from repro.kernels.hash_probe import \
    scan_filter_agg_join_sharded as ref_join_sharded
from repro_torch.core import engine, htap, schema
from repro_torch.core.application import (apply_updates, apply_updates_shards,
                                          route_updates)
from repro_torch.core.backend import get_backend
from repro_torch.core.consistency import ConsistencyManager
from repro_torch.core.dsm import (DSMReplica, EncodedColumn, MeshView,
                                  column_from_numpy, column_to_numpy,
                                  concat_columns, decode_column, shard_bounds,
                                  shard_column)
from repro_torch.core.nsm import make_entries
from repro_torch.kernels import common
from repro_torch.kernels.dict_ops import ops as dict_ops
from repro_torch.kernels.dict_ops import (scan_exact_mesh, scan_exact_mesh_ref,
                                          scan_exact_ref, scan_filter_agg_mesh,
                                          scan_filter_agg_mesh_ref)
from repro_torch.kernels.hash_probe import (scan_filter_agg_join_mesh,
                                            scan_filter_agg_join_mesh_ref)

torch.set_num_threads(1)
T = torch.from_numpy


def _columns(rng, n, k, kj, dmin=-(10**6), dmax=10**6):
    fcodes = rng.integers(0, k, size=n).astype(np.int32)
    acodes = rng.integers(0, k, size=n).astype(np.int32)
    jcodes = rng.integers(0, kj, size=n).astype(np.int32)
    fvalid = rng.random(n) < 0.9
    jvalid = rng.random(n) < 0.85
    d = np.sort(rng.choice(np.arange(dmin, dmax, dtype=np.int64), size=k,
                           replace=False)).astype(np.int32)
    rcount = np.bincount(jcodes[jvalid], minlength=kj).astype(np.int32)
    return fcodes, acodes, jcodes, fvalid, jvalid, d, rcount


def _islands(cols, sizes):
    """Split flat numpy columns into per-island CPU tensors of `sizes`."""
    cuts = np.cumsum([0, *sizes])
    return [[T(c[lo:hi].copy()) for lo, hi in zip(cuts, cuts[1:])]
            for c in cols]


def _stack(cols, sizes):
    """The same rows as the reference's stacked (S, width) shards."""
    width = max(sizes, default=0)
    cuts = np.cumsum([0, *sizes])
    out = []
    for c in cols:
        st = np.zeros((len(sizes), width), dtype=c.dtype)
        for s, (lo, hi) in enumerate(zip(cuts, cuts[1:])):
            st[s, :hi - lo] = c[lo:hi]
        out.append(st)
    return out


def _reduced(per_shard, lanes):
    return [tuple(ref_backend_mod.reduce_partials(
        "sum", [p[q][lane] for p in per_shard]) for lane in range(lanes))
        for q in range(len(per_shard[0]))]


# islands: equal, uneven, an empty island, more islands than rows, one row
MESH_SWEEP = [(250, 250), (334, 333, 333), (0, 40, 41), (1, 1, 0, 0),
              (1,), (5000, 4999, 5000, 4999), (0, 0)]
# Q: one, three, a register tile's worth plus one, non-pow2 throughout
BOUNDS = {1: lambda k: [(0, k)],
          3: lambda k: [(k // 4, 3 * k // 4), (0, k), (3, 3)],
          33: lambda k: [(i % k, i % k + 1 + i % 7) for i in range(33)]}


@pytest.mark.parametrize("sizes", MESH_SWEEP)
@pytest.mark.parametrize("nq", sorted(BOUNDS))
def test_mesh_scan_matches_the_reference_totals(rng, sizes, nq):
    k = 37
    f, a, j, fv, jv, d, rc = _columns(rng, sum(sizes), k, k + 5)
    bounds = BOUNDS[nq](k)
    n = len(sizes)
    fi, ai, ji, fvi, jvi = _islands((f, a, j, fv, jv), sizes)
    dicts, rcs = [T(d)] * n, [T(rc)] * n
    got = scan_filter_agg_mesh(fi, ai, fvi, dicts, bounds)
    got_j = scan_filter_agg_join_mesh(fi, ai, ji, fvi, jvi, dicts, rcs,
                                      bounds)
    assert got == scan_filter_agg_mesh_ref(fi, ai, fvi, dicts, bounds)
    assert got_j == scan_filter_agg_join_mesh_ref(fi, ai, ji, fvi, jvi,
                                                  dicts, rcs, bounds)
    sf, sa, sj, sfv, sjv = _stack((f, a, j, fv, jv), sizes)
    if n == 1:
        mesh = ref_island_mesh(1)
        assert got == ref_scan_mesh(sf, sa, sfv, d, bounds, mesh)
        assert got_j == ref_join_mesh(sf, sa, sj, sfv, sjv, d, rc, bounds,
                                      mesh)
    else:
        assert got == _reduced(ref_scan_sharded(sf, sa, sfv, d, bounds), 2)
        assert got_j == _reduced(ref_join_sharded(sf, sa, sj, sfv, sjv, d,
                                                  rc, bounds), 3)
    # the totals are the flat scan of the whole column
    flat = scan_exact_ref(T(f), T(a), T(fv), T(d), bounds, T(j), T(jv),
                          T(rc)).tolist()
    assert got_j == list(zip(*flat))
    assert all(type(x) is int for t in got_j for x in t)


@pytest.mark.parametrize("case", ["int32_extremes", "all_negative",
                                  "sum_beyond_int32", "nothing_valid"])
def test_mesh_scan_value_extremes(rng, case):
    sizes, k = (3000, 3001, 2999), 16
    f, a, j, fv, jv, d, rc = _columns(rng, sum(sizes), k, k)
    if case == "int32_extremes":
        d = np.sort(np.concatenate([[-2**31, 2**31 - 1],
                                    d[:k - 2]])).astype(np.int32)
    elif case == "all_negative":
        d = np.sort(-np.abs(d.astype(np.int64)) - 1).astype(np.int32)
    elif case == "sum_beyond_int32":
        d = np.sort(rng.integers(2**30, 2**31 - 1, size=k)).astype(np.int32)
    else:
        fv = np.zeros(sum(sizes), dtype=bool)
    bounds = [(0, k), (3, 11)]
    fi, ai, ji, fvi, jvi = _islands((f, a, j, fv, jv), sizes)
    got = scan_filter_agg_join_mesh(fi, ai, ji, fvi, jvi, [T(d)] * 3,
                                    [T(rc)] * 3, bounds)
    sf, sa, sj, sfv, sjv = _stack((f, a, j, fv, jv), sizes)
    assert got == _reduced(ref_join_sharded(sf, sa, sj, sfv, sjv, d, rc,
                                            bounds), 3)
    if case == "sum_beyond_int32":
        assert got[0][0] > 2**40


def test_mesh_scan_layout_and_argument_checks(rng):
    f, a, j, fv, jv, d, rc = _columns(rng, 200, 9, 9)
    fi, ai, ji, fvi, jvi = _islands((f, a, j, fv, jv), (120, 80))
    out = scan_exact_mesh(fi, ai, fvi, [T(d)] * 2, [(0, 9), (2, 5)], ji, jvi,
                          [T(rc)] * 2)
    assert out.dtype == torch.int64 and out.shape == (3, 2)
    assert torch.equal(out, scan_exact_ref(T(f), T(a), T(fv), T(d),
                                           [(0, 9), (2, 5)], T(j), T(jv),
                                           T(rc)))
    assert scan_exact_mesh(fi, ai, fvi, [T(d)] * 2, []).shape == (2, 0)
    assert scan_filter_agg_mesh(fi, ai, fvi, [T(d)] * 2, []) == []
    assert torch.equal(scan_exact_mesh_ref(fi, ai, fvi, [T(d)] * 2, [(0, 9)]),
                       scan_exact_mesh(fi, ai, fvi, [T(d)] * 2, [(0, 9)]))
    with pytest.raises(ValueError, match="one tensor per island"):
        scan_exact_mesh(fi, ai, fvi[:1], [T(d)] * 2, [(0, 9)])


# ---------------------------------------------------------------------------
# the wrappers' GPU branch, rehearsed on the CPU: one launch per island
# ---------------------------------------------------------------------------

def _fake_launch(fcodes, acodes, fvalid_u8, adict, bounds_dev, out,
                 jcodes=None, jvalid_u8=None, rcount=None, corr_a=None,
                 corr_j=None, vbounds_dev=None):
    """Stands in for the CUDA launch: adds the plain version's partials
    into `out` (the kernel adds into a zeroed `out` the same way)."""
    assert corr_a is None and corr_j is None and fcodes is not None
    out += scan_exact_ref(fcodes, acodes, fvalid_u8, adict,
                          bounds_dev.tolist(), jcodes, jvalid_u8, rcount)


@pytest.fixture
def gpu_branch(monkeypatch):
    """The scan wrappers' GPU branch (checks, per-device bounds, zeroed
    partials, the reduction, the launch counters) on CPU tensors."""
    monkeypatch.setattr(dict_ops, "on_gpu", lambda *t: True)
    monkeypatch.setattr(dict_ops, "launch_scan_exact", _fake_launch)
    common.reset_kernel_launch_counts()
    yield
    common.reset_kernel_launch_counts()


def test_mesh_wrapper_counts_one_launch_per_nonempty_island(rng, gpu_branch):
    f, a, j, fv, jv, d, rc = _columns(rng, 81, 9, 11)
    sizes = (40, 0, 41)
    fi, ai, ji, fvi, jvi = _islands((f, a, j, fv, jv), sizes)
    bounds = [(0, 9), (1, 4), (8, 9)]
    got = scan_filter_agg_join_mesh(fi, ai, ji, fvi, jvi, [T(d)] * 3,
                                    [T(rc)] * 3, bounds)
    assert got == scan_filter_agg_join_mesh_ref(fi, ai, ji, fvi, jvi,
                                                [T(d)] * 3, [T(rc)] * 3,
                                                bounds)
    assert scan_filter_agg_mesh(fi, ai, fvi, [T(d)] * 3, bounds) == \
        scan_filter_agg_mesh_ref(fi, ai, fvi, [T(d)] * 3, bounds)
    # the empty island launches nothing; the others count under the flat
    # scan's names with their own shapes, and nothing counts as sharded
    assert common.kernel_launch_counts() == {"scan_exact_join": 2,
                                             "scan_exact": 2}
    assert common.kernel_launch_shapes() == {
        "scan_exact_join": {(40, 9, 11, 3): 1, (41, 9, 11, 3): 1},
        "scan_exact": {(40, 9, 3): 1, (41, 9, 3): 1}}


def test_mesh_session_launches_n_times_the_one_island_scans(gpu_branch):
    """End to end on the rehearsed GPU branch: hopper@4/mesh launches the
    flat scan exactly four times as often as one island does, and the
    stacked scans never."""
    rng = np.random.default_rng(3)
    sch = schema.make_schema("t", 3, 32)
    table = schema.gen_table(rng, sch, 800)
    stream = schema.gen_update_stream(rng, sch, 800, 1600, write_ratio=0.5)
    queries = engine.gen_queries(rng, 8, 3)
    counts = {}
    for spec, devices in (("hopper", None), ("hopper@4/mesh", ["cpu"] * 4)):
        before = common.kernel_launch_counts()
        res = htap.run("Polynesia", table, stream, queries, n_rounds=2,
                       backend=spec, device="cpu" if devices is None
                       else None, devices=devices)
        counts[spec] = {k: v - before.get(k, 0) for k, v in
                        common.kernel_launch_counts().items()}
        assert res.stats["kernel_launches"] == {
            k: v for k, v in counts[spec].items() if v}
    one, mesh = counts["hopper"], counts["hopper@4/mesh"]
    for name in ("scan_exact", "scan_exact_join"):
        assert one.get(name, 0) > 0
        assert mesh.get(name, 0) == 4 * one[name]
    assert not any("sharded" in k for k in mesh)


# ---------------------------------------------------------------------------
# per-island apply: routing, stage 3 per island, all-or-none swap
# ---------------------------------------------------------------------------

def _mixed_updates(rng, n, m, domain=500):
    ops = rng.choice([1, 2, 3], size=m, p=[0.6, 0.2, 0.2]).astype(np.int8)
    rows = rng.integers(0, n, m).astype(np.int64)
    rows[ops == 2] = n + rng.integers(0, 40, int((ops == 2).sum()))
    return make_entries(np.arange(m, dtype=np.int64), ops,
                        rng.integers(0, domain, m).astype(np.int32), rows,
                        np.zeros(m, dtype=np.int32))


def _same_column(pcol, rcol):
    codes, dictionary, valid, version = column_to_numpy(pcol)
    np.testing.assert_array_equal(codes, np.asarray(rcol.codes))
    np.testing.assert_array_equal(dictionary, np.asarray(rcol.dictionary))
    np.testing.assert_array_equal(valid, np.asarray(rcol.valid))
    assert version == rcol.version


def _mesh(k):
    return get_backend(f"hopper@{k}/mesh", devices=["cpu"] * k)


@pytest.mark.parametrize("bounds", [[0, 5, 5, 10], [0, 3, 7, 9, 12],
                                    [0, 0, 0], [0, 100]])
def test_route_updates_matches_the_reference(rng, bounds):
    ups = make_entries(np.arange(9, dtype=np.int64), np.ones(9, np.int8),
                       np.zeros(9, np.int32),
                       np.array([0, 4, 5, 9, 12, 99, 3, 150, 7], np.int64),
                       np.zeros(9, np.int32))
    np.testing.assert_array_equal(route_updates(ups, bounds),
                                  ref_application.route_updates(ups, bounds))


@pytest.mark.parametrize("k", [1, 2, 3, 4, 7])
def test_apply_updates_shards_match_the_reference(rng, k):
    rcol = ref_dsm.encode_column(rng.integers(0, 500, 300).astype(np.int32))
    col = column_from_numpy(np.asarray(rcol.codes),
                            np.asarray(rcol.dictionary),
                            np.asarray(rcol.valid), 0, device="cpu")
    ups = _mixed_updates(rng, 300, 96)
    shards = apply_updates_shards(col, ups, backend=_mesh(k))
    rshards = ref_application.apply_updates_shards(
        rcol, ups, backend=ref_backend_mod.ShardedBackend("pallas", k))
    assert len(shards) == len(rshards) == k
    for got, want in zip(shards, rshards):
        _same_column(got, want)
        assert got.dictionary is shards[0].dictionary   # one replicated dict
    # their concatenation is the one-column apply's result, and the
    # reference's unsharded result
    whole = concat_columns(shards)
    _same_column(whole, ref_application.apply_updates(rcol, ups,
                                                      backend="numpy"))
    assert torch.equal(whole.codes, apply_updates(col, ups, backend=get_backend(
        "hopper", device="cpu")).codes)
    # the old column is never written in place
    np.testing.assert_array_equal(col.codes.numpy(), np.asarray(rcol.codes))


def test_apply_updates_shards_needs_the_mesh(rng):
    col = column_from_numpy(np.arange(10) % 4, np.arange(4),
                            np.ones(10, bool), 0, device="cpu")
    ups = _mixed_updates(rng, 10, 5)
    for spec in ("hopper", "hopper@3"):
        with pytest.raises(ValueError, match="apply_updates_shards"):
            apply_updates_shards(col, ups, backend=get_backend(
                spec, device="cpu"))


def test_shard_emptied_by_deletes_still_exact(rng):
    n, k = 400, 4
    rcol = ref_dsm.encode_column(rng.integers(0, 99, n).astype(np.int32))
    col = column_from_numpy(np.asarray(rcol.codes),
                            np.asarray(rcol.dictionary),
                            np.asarray(rcol.valid), 0, device="cpu")
    b = shard_bounds(n, k)
    doomed = np.arange(b[1], b[2], dtype=np.int64)
    ups = make_entries(np.arange(len(doomed), dtype=np.int64),
                       np.full(len(doomed), 3, np.int8),
                       np.zeros(len(doomed), np.int32), doomed,
                       np.zeros(len(doomed), np.int32))
    be = _mesh(k)
    shards = apply_updates_shards(col, ups, backend=be)
    assert not shards[1].valid.any()
    view = be.place_shards(shards)
    whole = ref_application.apply_updates(rcol, ups, backend="numpy")
    assert be.filter_agg(view, view, 0, 1 << 24) == \
        ref_backend_mod.get_backend("numpy").filter_agg(whole, whole, 0,
                                                        1 << 24)


def test_per_island_swap_all_or_none(rng):
    """A partial or mixed-round shard set raises and leaves the replica
    and the pending residency untouched; a complete set swaps in the
    concatenation and installs the shards as the next pinned read's view,
    adopted without re-sharding."""
    table = rng.integers(0, 50, size=(900, 2)).astype(np.int32)
    rep = DSMReplica.from_table(table, device="cpu")
    be = _mesh(3)
    cons = ConsistencyManager(rep, backend=be)
    old = rep.columns[0]
    rows = np.array([5, 305, 899], np.int64)     # one row on each island
    ups = make_entries(np.arange(3, dtype=np.int64), np.ones(3, np.int8),
                       np.full(3, 77777, np.int32), rows,
                       np.zeros(3, np.int32))
    h_old = cons.begin_query([0])
    before = cons.read_scan(h_old, 0)
    assert isinstance(before, MeshView) and cons.views_built == 1
    shards = apply_updates_shards(old, ups, backend=be)
    with pytest.raises(ValueError, match="partial shard set"):
        cons.on_update_shards(0, shards[:2])
    assert rep.columns[0] is old and not cons._resident
    with pytest.raises(ValueError, match="mismatch"):
        cons.on_update_shards(0, shards[:2] + [shard_column(old, 3)[2]])
    assert rep.columns[0] is old and not cons._resident
    uneven = [EncodedColumn(codes=s.codes[:-1], dictionary=s.dictionary,
                            valid=s.valid[:-1], version=s.version)
              if i == 2 else s for i, s in enumerate(shards)]
    with pytest.raises(ValueError, match="shard_bounds"):
        cons.on_update_shards(0, uneven)
    assert rep.columns[0] is old and not cons._resident
    cons.chains[0].dirty = False
    cons.on_update_shards(0, shards)
    assert cons.chains[0].dirty and rep.columns[0] is not old
    assert int(decode_column(rep.columns[0])[5]) == 77777
    h_new = cons.begin_query([0])
    after = cons.read_scan(h_new, 0)
    assert (cons.views_built, cons.views_resident) == (1, 1)
    assert all(c is s.codes for c, s in zip(after.codes, shards))
    assert after.snapshot_id >= 0 and not before.stale
    assert be.filter_agg(after, after, 77777, 77777) == (3 * 77777, 3)
    assert be.filter_agg(before, before, 77777, 77777) == (0, 0)
    cons.end_query(h_old)
    cons.end_query(h_new)
    # a one-island swap's pending view is superseded by a plain swap
    cons.on_update_shards(0, apply_updates_shards(rep.columns[0], ups,
                                                  backend=be))
    assert 0 in cons._resident
    cons.on_update(0, rep.columns[0])
    assert 0 not in cons._resident
