"""The port's folds against the JAX package's compositions, on the same
numpy inputs: where the reference composes a scan and a launch of the
correction lane of its own (the values delta), the port's correction rides
the scan's launch, and where the reference sorts and merges a one-column
dictionary stage apart, the port's stage is one fused apply.

* the stacked delta join group (`scan_filter_agg_join_group_sharded`):
  the reference's sharded join scan, reduced, plus two values deltas;
* the mesh delta groups (`scan_filter_agg_group_mesh`,
  `scan_filter_agg_join_group_mesh`): the reference's mesh scans plus the
  values delta (at N > 1 its mesh totals are held through its stacked
  scan reduced, as ``tests/test_torch_kernels_mesh.py`` does);
* the wrappers' GPU branch rehearsed on the CPU (``on_gpu`` and the bare
  launches patched to add the plain versions' results): a ``hopper@4``
  delta join group is one launch and no values delta; a mesh delta group
  one island launch a device with the correction on the first launch on
  island 0's device only; a one-column dictionary stage is one fused
  apply, its entries equal to the reference's, the fallback columns too.

Integers: tolerance 0.
"""

import numpy as np
import pytest
import torch

from repro.core import backend as ref_backend_mod
from repro.core import dsm as ref_dsm
from repro.distributed import island_mesh as ref_island_mesh
from repro.kernels.dict_ops import scan_filter_agg_mesh as ref_scan_mesh
from repro.kernels.dict_ops import \
    scan_filter_agg_sharded as ref_scan_sharded
from repro.kernels.dict_ops import scan_values_agg as ref_values
from repro.kernels.dict_ops import scan_values_delta as ref_values_delta
from repro.kernels.hash_probe import scan_filter_agg_join_mesh as ref_join_mesh
from repro.kernels.hash_probe import \
    scan_filter_agg_join_sharded as ref_join_sharded
from repro_torch.core import engine, htap, schema
from repro_torch.core.backend import get_backend
from repro_torch.core.dsm import column_from_numpy
from repro_torch.kernels import common
from repro_torch.kernels.bitonic_sort import ops as bitonic_ops
from repro_torch.kernels.bitonic_sort import apply_pipeline_batch_ref
from repro_torch.kernels.dict_ops import ops as dict_ops
from repro_torch.kernels.dict_ops import (MAX_CORR_Q, scan_exact_group_ref,
                                          scan_exact_mesh,
                                          scan_exact_mesh_ref,
                                          scan_exact_ref,
                                          scan_filter_agg_group_mesh,
                                          scan_filter_agg_group_mesh_ref,
                                          scan_values_exact_ref)
from repro_torch.kernels.hash_probe import (
    scan_filter_agg_join_group_mesh, scan_filter_agg_join_group_mesh_ref,
    scan_filter_agg_join_group_sharded,
    scan_filter_agg_join_group_sharded_ref)

torch.set_num_threads(1)
T = torch.from_numpy
I32_MIN, I32_MAX = -2**31, 2**31 - 1

# islands: one, three uneven, four with an empty one
SIZES = [(1000,), (334, 333, 333), (250, 251, 0, 249)]
# (aggregate stack rows, join-weight stack rows, aggregate stack holds
# only the effective triple)
STACKS = [(0, 0, False), (1, 1, False), (4031, 4031, False), (3, 3, True)]
NQS = [1, 3, 9]


def _columns(rng, n, k, kj):
    fcodes = rng.integers(0, k, size=n).astype(np.int32)
    acodes = rng.integers(0, k, size=n).astype(np.int32)
    jcodes = rng.integers(0, kj, size=n).astype(np.int32)
    fvalid = rng.random(n) < 0.9
    jvalid = rng.random(n) < 0.85
    d = np.sort(rng.choice(np.arange(-10**6, 10**6, dtype=np.int64), size=k,
                           replace=False)).astype(np.int32)
    d[0], d[-1] = I32_MIN + 1, I32_MAX - 1
    rcount = np.bincount(jcodes[jvalid], minlength=kj).astype(np.int32)
    return fcodes, acodes, jcodes, fvalid, jvalid, d, rcount


def _stack(rng, nr, rows=6, weights=False):
    """A (rows, nr) int32 correction stack: values over the whole int32
    range (and its ends), 0/1 validity lanes; join weights are row counts."""
    vals = rng.integers(-1000, 1000, size=(4, nr)).astype(np.int64)
    vals[:, ::3] = rng.integers(I32_MIN, I32_MAX, size=vals[:, ::3].shape,
                                endpoint=True)
    if nr:
        vals[:, 0] = [I32_MIN, I32_MAX, I32_MAX, I32_MIN]
    if weights:
        vals[1], vals[3] = np.abs(vals[1]) % 5000, np.abs(vals[3]) % 5000
    valid = (rng.random((2, nr)) < 0.8).astype(np.int64)
    st = np.stack([vals[0], vals[1], valid[0], vals[2], vals[3], valid[1]])
    return st[:rows].astype(np.int32)


def _vbounds(rng, nq):
    fixed = [(I32_MIN, I32_MAX), (5, -5), (0, I32_MAX), (I32_MIN, I32_MIN),
             (-1000, 1000)]
    out = fixed[:nq]
    while len(out) < nq:
        lo = int(rng.integers(-1200, 1200))
        out.append((lo, lo + int(rng.integers(-5, 900))))
    return out


def _code_bounds(rng, k, nq):
    out = [(int(lo), int(lo) + int(rng.integers(0, k)))
           for lo in rng.integers(0, k, size=nq)]
    out[0] = (0, k)
    return out


def _laid(cols, sizes):
    """The same rows as stacked (S, width) shards (padded slots: 0)."""
    width = max(sizes)
    cuts = np.cumsum([0, *sizes])
    out = []
    for c in cols:
        st = np.zeros((len(sizes), width), dtype=c.dtype)
        for s, (lo, hi) in enumerate(zip(cuts, cuts[1:])):
            st[s, :hi - lo] = c[lo:hi]
        out.append(st)
    return out


def _islands(cols, sizes):
    cuts = np.cumsum([0, *sizes])
    return [[T(c[lo:hi].copy()) for lo, hi in zip(cuts, cuts[1:])]
            for c in cols]


def _ref_delta(stack, vb):
    """The reference's values delta of one stack (a 3-row stack: its
    raw-value scan), as [(d_sum, d_count)]."""
    if stack is None or stack.shape[1] == 0:
        return [(0, 0)] * len(vb)
    if stack.shape[0] == 3:
        return ref_values(stack[0], stack[1], stack[2], vb)
    return ref_values_delta(stack, vb)


def _reduced(per_shard, lanes):
    return [tuple(ref_backend_mod.reduce_partials(
        "sum", [p[q][lane] for p in per_shard]) for lane in range(lanes))
        for q in range(len(per_shard[0]))]


def _fold(base, da, dj=None):
    """The reference's composition: base answers plus the aggregate stack's
    deltas and the join-weight stack's sum delta."""
    out = []
    for q, b in enumerate(base):
        row = [int(b[0]) + int(da[q][0]), int(b[1]) + int(da[q][1])]
        if dj is not None:
            row.append(int(b[2]) + int(dj[q][0]))
        out.append(tuple(row))
    return out


def _inputs(rng, sizes, stacks, nq, k=61, kj=37):
    nr_a, nr_j, triple = stacks
    cols = _columns(rng, sum(sizes), k, kj)
    ca = _stack(rng, nr_a, 3 if triple else 6)
    cj = _stack(rng, nr_j, weights=True)
    return cols, ca, cj, _code_bounds(rng, k, nq), _vbounds(rng, nq)


# ---------------------------------------------------------------------------
# the plain versions against the reference's compositions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nq", NQS)
@pytest.mark.parametrize("stacks", STACKS)
@pytest.mark.parametrize("sizes", SIZES)
def test_sharded_join_group_equals_the_reference_composition(rng, sizes,
                                                             stacks, nq):
    (f, a, j, fv, jv, d, rc), ca, cj, cb, vb = _inputs(rng, sizes, stacks,
                                                        nq)
    fs, as_, js, fvs, jvs = _laid((f, a, j, fv, jv), sizes)
    want = _fold(_reduced(ref_join_sharded(fs, as_, js, fvs, jvs, d, rc, cb),
                          3), _ref_delta(ca, vb), _ref_delta(cj, vb))
    args = (T(fs), T(as_), T(js), T(fvs), T(jvs), T(d), T(rc), cb, T(ca),
            T(cj), vb)
    assert scan_filter_agg_join_group_sharded(*args) == want
    assert scan_filter_agg_join_group_sharded_ref(*args) == want
    assert all(type(x) is int for t in want for x in t)


@pytest.mark.parametrize("nq", NQS)
@pytest.mark.parametrize("stacks", STACKS)
@pytest.mark.parametrize("sizes", SIZES)
def test_mesh_groups_equal_the_reference_composition(rng, sizes, stacks, nq):
    (f, a, j, fv, jv, d, rc), ca, cj, cb, vb = _inputs(rng, sizes, stacks,
                                                        nq)
    n = len(sizes)
    fi, ai, ji, fvi, jvi = _islands((f, a, j, fv, jv), sizes)
    dicts, rcs = [T(d)] * n, [T(rc)] * n
    sf, sa, sj, sfv, sjv = _laid((f, a, j, fv, jv), sizes)
    if n == 1:
        mesh = ref_island_mesh(1)
        base = ref_scan_mesh(sf, sa, sfv, d, cb, mesh)
        jbase = ref_join_mesh(sf, sa, sj, sfv, sjv, d, rc, cb, mesh)
    else:
        base = _reduced(ref_scan_sharded(sf, sa, sfv, d, cb), 2)
        jbase = _reduced(ref_join_sharded(sf, sa, sj, sfv, sjv, d, rc, cb), 3)
    want = _fold(base, _ref_delta(ca, vb))
    want_j = _fold(jbase, _ref_delta(ca, vb), _ref_delta(cj, vb))
    args = (fi, ai, fvi, dicts, cb, T(ca), vb)
    assert scan_filter_agg_group_mesh(*args) == want
    assert scan_filter_agg_group_mesh_ref(*args) == want
    jargs = (fi, ai, ji, fvi, jvi, dicts, rcs, cb, T(ca), T(cj), vb)
    assert scan_filter_agg_join_group_mesh(*jargs) == want_j
    assert scan_filter_agg_join_group_mesh_ref(*jargs) == want_j


def test_group_wrappers_take_no_predicates_and_absent_stacks(rng):
    (f, a, j, fv, jv, d, rc), _, cj, cb, vb = _inputs(rng, (40, 41),
                                                       STACKS[1], 3)
    fi, ai, ji, fvi, jvi = _islands((f, a, j, fv, jv), (40, 41))
    fs, as_, js, fvs, jvs = _laid((f, a, j, fv, jv), (40, 41))
    assert scan_filter_agg_group_mesh(fi, ai, fvi, [T(d)] * 2, [], None,
                                      []) == []
    assert scan_filter_agg_join_group_sharded(
        T(fs), T(as_), T(js), T(fvs), T(jvs), T(d), T(rc), [], None, None,
        []) == []
    # no stacks: the plain scans' answers
    base = list(zip(*scan_exact_ref(T(f), T(a), T(fv), T(d), cb, T(j),
                                    T(jv), T(rc)).tolist()))
    assert scan_filter_agg_join_group_mesh(
        fi, ai, ji, fvi, jvi, [T(d)] * 2, [T(rc)] * 2, cb, None, None,
        vb) == base
    assert scan_filter_agg_join_group_sharded(
        T(fs), T(as_), T(js), T(fvs), T(jvs), T(d), T(rc), cb, None, None,
        vb) == base
    # only the join-weight stack
    want = _fold(base, [(0, 0)] * 3, _ref_delta(cj, vb))
    assert scan_filter_agg_join_group_mesh(
        fi, ai, ji, fvi, jvi, [T(d)] * 2, [T(rc)] * 2, cb, None, T(cj),
        vb) == want
    with pytest.raises(ValueError, match="n_shards, width"):
        scan_filter_agg_join_group_sharded(T(f), T(a), T(j), T(fv), T(jv),
                                           T(d), T(rc), cb, None, None, vb)


# ---------------------------------------------------------------------------
# the GPU branch rehearsed on the CPU
# ---------------------------------------------------------------------------

ISLAND_LAUNCHES: list = []


def _fake_launch(fcodes, acodes, fvalid_u8, adict, bounds_dev, out,
                 jcodes=None, jvalid_u8=None, rcount=None, corr_a=None,
                 corr_j=None, vbounds_dev=None):
    """Stands in for the scan's CUDA launch: adds the plain version's
    partials (with the correction lane's row where it rides) into `out`."""
    if vbounds_dev is None:
        out += scan_exact_ref(fcodes, acodes, fvalid_u8, adict,
                              bounds_dev.tolist(), jcodes, jvalid_u8, rcount)
    else:
        out += scan_exact_group_ref(fcodes, acodes, fvalid_u8, adict,
                                    bounds_dev.tolist(), corr_a,
                                    vbounds_dev.tolist(), jcodes, jvalid_u8,
                                    rcount, corr_j)


def _fake_values_launch(stack, vbounds_dev, out):
    out += scan_values_exact_ref(stack, vbounds_dev.tolist())


def _fake_island_launch(islands, bounds_dev, out, corr_a=None, corr_j=None,
                        vbounds=None):
    """Stands in for the island-table launch: records (device, islands,
    whether the correction rode it) and adds the plain partials."""
    assert len(islands) <= dict_ops.MAX_ISLANDS
    assert vbounds is None or len(vbounds) <= MAX_CORR_Q
    ISLAND_LAUNCHES.append((out.device, len(islands), vbounds is not None))
    for isl in islands:
        assert isl[0].shape[0] > 0 and isl[0].device == out.device
        out += scan_exact_ref(*isl[:4], bounds_dev.tolist(), *isl[4:])
    if vbounds is not None:
        dict_ops._corr_ref(out, corr_a, corr_j, list(vbounds))


@pytest.fixture
def gpu_branch(monkeypatch):
    """The scan wrappers' GPU branch (checks, allocation, the folds, the
    launch counters) on CPU tensors."""
    monkeypatch.setattr(dict_ops, "on_gpu", lambda *t: True)
    monkeypatch.setattr(dict_ops, "launch_scan_exact", _fake_launch)
    monkeypatch.setattr(dict_ops, "launch_scan_values", _fake_values_launch)
    monkeypatch.setattr(dict_ops, "launch_scan_exact_islands",
                        _fake_island_launch)
    common.reset_kernel_launch_counts()
    ISLAND_LAUNCHES.clear()
    yield
    common.reset_kernel_launch_counts()


def _port_col(rcol):
    return column_from_numpy(np.asarray(rcol.codes),
                             np.asarray(rcol.dictionary),
                             np.asarray(rcol.valid), 0, device="cpu")


def _delta_inputs(rng, n, nq, nr_a, nr_j):
    """Reference columns (filter, agg, join), their port copies, the value
    bounds, an effective histogram and the two stacks."""
    rcols = [ref_dsm.encode_column(rng.integers(-500, 500, n)
                                   .astype(np.int32)) for _ in range(3)]
    bounds = [(-600, 600)] + [(int(lo), int(lo) + int(w)) for lo, w in zip(
        rng.integers(-500, 400, nq - 1), rng.integers(0, 300, nq - 1))]
    kj = len(np.asarray(rcols[2].dictionary))
    rcount = rng.integers(0, 40, kj).astype(np.int64)
    ca = _stack(rng, nr_a) if nr_a is not None else None
    cj = _stack(rng, nr_j, weights=True) if nr_j is not None else None
    return rcols, [_port_col(c) for c in rcols], bounds, rcount, ca, cj


@pytest.mark.parametrize("nq", NQS)
@pytest.mark.parametrize("nr_a,nr_j", [(1, 1), (4031, 3), (None, 5),
                                       (7, None)])
def test_stacked_delta_join_group_is_one_launch(rng, gpu_branch, nq, nr_a,
                                                nr_j):
    """hopper@4: a delta join group is ONE launch of the sharded join group
    with both stacks, no values delta and no sharded join scan; its
    answers are the reference's composition (pallas@4: the sharded join
    scan plus two values deltas)."""
    rcols, cols, bounds, rcount, ca, cj = _delta_inputs(rng, 1003, nq, nr_a,
                                                        nr_j)
    be = get_backend("hopper@4", device="cpu")
    got = be.filter_agg_join_delta_batch(
        *cols, bounds, T(rcount), None if ca is None else T(ca),
        None if cj is None else T(cj))
    ref = ref_backend_mod.ShardedBackend("pallas", 4)
    assert got == ref.filter_agg_join_delta_batch(*rcols, bounds, rcount,
                                                  ca, cj)
    shapes = common.kernel_launch_shapes()
    assert common.kernel_launch_counts() == {
        "scan_exact_join_group_sharded": 1}
    [shape] = shapes["scan_exact_join_group_sharded"]
    assert shape[0] == 4 and shape[-3:] == (
        nq, 0 if ca is None else ca.shape[1], 0 if cj is None else
        cj.shape[1])


@pytest.mark.parametrize("nq", [1, 3, 9, MAX_CORR_Q + 6])
def test_mesh_delta_groups_are_one_launch_a_device(rng, gpu_branch, nq):
    """hopper@4/mesh on ["cpu"] * 4: each delta group is one island launch
    (one device), the correction riding it, recorded in its shape; a group
    past MAX_CORR_Q predicates takes one launch a slice of them. Answers
    are the reference's composition."""
    rcols, cols, bounds, rcount, ca, cj = _delta_inputs(rng, 1003, nq, 4031,
                                                        9)
    be = get_backend("hopper@4/mesh", devices=["cpu"] * 4)
    ref = ref_backend_mod.ShardedBackend("pallas", 4)
    views = [be.shard_view(c) for c in cols]
    got = be.filter_agg_delta_batch(views[0], views[1], bounds, T(ca))
    assert got == ref.filter_agg_delta_batch(rcols[0], rcols[1], bounds, ca)
    got_j = be.filter_agg_join_delta_batch(*views, bounds, T(rcount), T(ca),
                                           T(cj))
    assert got_j == ref.filter_agg_join_delta_batch(*rcols, bounds, rcount,
                                                    ca, cj)
    slices = -(-nq // MAX_CORR_Q)
    cpu = torch.device("cpu")
    assert ISLAND_LAUNCHES == [(cpu, 4, True)] * (2 * slices)
    counts = common.kernel_launch_counts()
    assert counts == {"scan_exact_mesh": slices,
                      "scan_exact_join_mesh": slices}
    for name, rows in (("scan_exact_mesh", (4031,)),
                       ("scan_exact_join_mesh", (4031, 9))):
        for shape in common.kernel_launch_shapes()[name]:
            assert shape[0] == 4 and shape[-len(rows):] == rows


def test_mesh_correction_rides_island_zero_devices_first_launch(rng,
                                                                monkeypatch):
    """Islands on three devices (stand-ins), island 0's device holding 17
    islands (two launches): the correction rides only the first launch on
    island 0's device, whatever the order of the groups."""
    launched = []

    def record(islands, bounds_dev, out, **corr):
        launched.append((out.tag, len(islands), bool(corr)))
    monkeypatch.setattr(dict_ops, "launch_scan_exact_islands", record)
    outs = {}
    for tag in ("d0", "d1", "d2"):
        outs[tag] = torch.zeros((2, 1), dtype=torch.int64)
        outs[tag].tag = tag
    groups = [("d1", [1]), ("d0", list(range(2, 18))), ("d0", [0, 18]),
              ("d2", [19])]
    corr = dict(corr_a=None, corr_j=None, vbounds=[(0, 1)])
    dict_ops.launch_scan_exact_mesh([None] * 20, groups,
                                    {t: None for t in outs}, outs, corr)
    assert launched == [("d1", 1, False), ("d0", 16, True),
                        ("d0", 2, False), ("d2", 1, False)]


def test_mesh_correction_without_island_rows_launches_the_slice(rng,
                                                                gpu_branch):
    """Every island empty: the correction still runs, a launch holding no
    island (n_islands 0 in the C entry); without stacks nothing launches."""
    e = torch.empty(0, dtype=torch.int32)
    eb = torch.empty(0, dtype=torch.bool)
    d = T(np.arange(5, dtype=np.int32))
    ca, vb = _stack(rng, 40), _vbounds(rng, 3)
    args = ([e] * 3, [e] * 3, [eb] * 3, [d] * 3, [(0, 5)] * 3)
    got = scan_exact_mesh(*args, corr_a=T(ca), vbounds=vb)
    assert torch.equal(got, scan_exact_mesh_ref(*args, corr_a=T(ca),
                                                vbounds=vb))
    assert torch.equal(got, scan_values_exact_ref(T(ca), vb))
    assert ISLAND_LAUNCHES == [(torch.device("cpu"), 0, True)]
    assert common.kernel_launch_shapes() == {
        "scan_exact_mesh": {(0, 0, 0, 3, 40): 1}}
    ISLAND_LAUNCHES.clear()
    assert not scan_exact_mesh(*args, corr_a=None, vbounds=vb).any()
    assert ISLAND_LAUNCHES == []


# -- one-column dictionary stages through the fused apply ------------------

def _fake_apply(old_rows, val_rows, svals, merged, scratch=None):
    s, m = apply_pipeline_batch_ref(old_rows, val_rows)
    svals.copy_(s)
    merged.copy_(m)


def _fake_sort(x, out, scratch=None):
    out.fill_(I32_MAX)
    out[:, :x.shape[1]] = torch.sort(x, dim=1).values


@pytest.fixture
def sort_gpu_branch(monkeypatch):
    monkeypatch.setattr(bitonic_ops, "on_gpu", lambda *t: True)
    monkeypatch.setattr(bitonic_ops, "launch_bitonic_apply", _fake_apply)
    monkeypatch.setattr(bitonic_ops, "launch_sort_rows", _fake_sort)
    common.reset_kernel_launch_counts()
    yield
    common.reset_kernel_launch_counts()


def _old_dict(rng, k, hi=1 << 20):
    return np.unique(rng.integers(0, hi, k)).astype(np.int32)


STAGE_BATCHES = {
    # one fusable column (small and beyond the 1,024-value sort unit)
    "one": lambda rng: [(_old_dict(rng, 700), rng.integers(
        0, 1 << 20, 300).astype(np.int32))],
    "one_wide": lambda rng: [(_old_dict(rng, 50), rng.integers(
        0, 1 << 20, 3000).astype(np.int32))],
    # one fusable column beside each fallback: a value at the int32.max
    # pad, no values, no old dictionary
    "with_fallbacks": lambda rng: [
        (_old_dict(rng, 400), rng.integers(0, 1 << 20, 90).astype(np.int32)),
        (_old_dict(rng, 30), np.array([5, I32_MAX, 5], np.int32)),
        (_old_dict(rng, 60), np.empty(0, np.int32)),
        (np.empty(0, np.int32), np.array([9, 3, 9], np.int32))],
}


@pytest.mark.parametrize("batch", sorted(STAGE_BATCHES))
def test_one_column_stage_is_one_fused_apply(rng, sort_gpu_branch, batch):
    """A one-fusable-column ship batch is ONE fused apply launch (the
    reference: the sort unit and the merge unit); the columns it cannot
    take keep the composition (the sort unit where a column has values).
    Every stage entry equals the reference's: update and merged
    dictionaries, the old-to-new code map and the staged encoder."""
    per_column = STAGE_BATCHES[batch](rng)
    be = get_backend("hopper", device="cpu")
    got = be.apply_stages_batch([(T(o), wv) for o, wv in per_column])
    want = ref_backend_mod.get_backend("numpy").apply_stages_batch(
        per_column)
    for (u, nd, enc, o2n), (ru, rnd, renc, ro2n), (_, wv) in zip(
            got, want, per_column):
        np.testing.assert_array_equal(u.numpy(), np.asarray(ru))
        np.testing.assert_array_equal(nd.numpy(), np.asarray(rnd))
        np.testing.assert_array_equal(o2n.numpy(), np.asarray(ro2n))
        if len(wv):
            np.testing.assert_array_equal(enc(wv).numpy(),
                                          np.asarray(renc(wv)))
    counts = common.kernel_launch_counts()
    assert counts.get("bitonic_apply", 0) == 1
    assert counts.get("bitonic_sort", 0) == (batch == "with_fallbacks")


# -- end to end on the delta plane ------------------------------------------

def test_delta_sessions_fold_every_correction(gpu_branch):
    """On the rehearsed GPU branch a delta-plane session on hopper@4 and on
    hopper@4/mesh (["cpu"] * 4) launches no values delta: every correction
    rides a scan launch - the sharded join group's, or the mesh scans'
    with their stacks' rows recorded - and the answers are the eager
    session's."""
    rng = np.random.default_rng(11)
    sch = schema.make_schema("t", 3, 32)
    table = schema.gen_table(rng, sch, 1200)
    stream = schema.gen_update_stream(rng, sch, 1200, 2400, write_ratio=0.5)
    queries = engine.gen_queries(rng, 12, 3, join_fraction=0.5)
    eager = htap.run("Polynesia", table, stream, queries, n_rounds=3,
                     backend="hopper", device="cpu")
    for spec, devices in (("hopper@4", None), ("hopper@4/mesh", ["cpu"] * 4)):
        common.reset_kernel_launch_counts()
        res = htap.run("Polynesia", table, stream, queries, n_rounds=3,
                       backend=spec, device="cpu" if devices is None
                       else None, devices=devices, delta_store=True,
                       delta_capacity=400)
        assert res.results == eager.results
        counts = common.kernel_launch_counts()
        assert "scan_values_delta" not in counts, (spec, counts)
        assert res.stats["compactions"] > 0
        if devices is None:
            assert counts.get("scan_exact_join_group_sharded", 0) > 0
            assert counts.get("scan_exact_group_sharded", 0) > 0
        else:
            shapes = common.kernel_launch_shapes()
            # a mesh launch's shape ends with its stacks' rows
            for name, stacks in (("scan_exact_mesh", 1),
                                 ("scan_exact_join_mesh", 2)):
                carried = sum(sum(sh[-stacks:]) * c
                              for sh, c in shapes[name].items())
                assert carried > 0, (name, shapes[name])
