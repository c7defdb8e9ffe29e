"""Randomized ConsistencyManager stress test (§6 invariants), the port
against the JAX package.

Ports tests/test_consistency_stress.py: a seeded random walk interleaves
begin_query / end_query / on_update / on_update_shards arbitrarily and
checks, after every step, the snapshot-chain invariants the consistency
contract rests on - a version with readers is never GC'd, the chain head
is never dropped once a snapshot exists, reader counts never go negative,
pinned reads stay frozen while updates land, and once every handle closes
each chain collapses to exactly its head. The same walk (same seed, same
draws) runs on the port's `torch`, `torch@2`, `torch@4` and the mesh
islands `hopper@2/mesh`, `hopper@4/mesh` (on CPU devices) and on the
reference's `numpy`, `numpy@2`, `numpy@4`; after every step both record
the pinned reads, chain lengths, version ids and reader counts, and the
two records must be equal. The port's stacked islands apply the column
they share (`apply_updates`; the reference applies per island on half the
updates, with the same result), its mesh islands per island
(`apply_updates_shards`) on the same draws as the reference. Integers:
tolerance 0.
"""

import itertools

import numpy as np
import pytest
import torch

from repro.core import application as ref_application
from repro.core import backend as ref_backend_mod
from repro.core import consistency as ref_consistency
from repro.core import dsm as ref_dsm
from repro.core import nsm as ref_nsm
from repro_torch.core import application, consistency, dsm, nsm
from repro_torch.core.backend import get_backend

torch.set_num_threads(1)

N_ROWS, N_COLS = 60, 3


class _Port:
    """The port's modules under the names the walk uses."""

    def __init__(self, spec):
        self.mesh = spec.endswith("/mesh")
        if self.mesh:
            n = int(spec.split("@")[1].split("/")[0])
            self.be = get_backend(spec, devices=["cpu"] * n)
        else:
            self.be = get_backend(spec, device="cpu")
        self.islands = self.be.n_shards

    def replica(self, table):
        return dsm.DSMReplica.from_table(table, device="cpu")

    def manager(self, replica):
        return consistency.ConsistencyManager(replica, on_pim=True,
                                              backend=self.be)

    def update(self, cons, col, ups, per_island: bool):
        old = cons.replica.columns[col]
        if self.mesh:
            # the mesh applies per island whatever the draw said
            cons.on_update_shards(col, application.apply_updates_shards(
                old, ups, backend=self.be))
        else:
            cons.on_update(col, application.apply_updates(old, ups,
                                                          backend=self.be))

    @staticmethod
    def decoded(col):
        return np.asarray(dsm.decode_column(col))

    make_entries = staticmethod(nsm.make_entries)


class _Ref:
    def __init__(self, spec):
        self.be = ref_backend_mod.get_backend(spec)
        self.islands = getattr(self.be, "n_shards", 1)

    def replica(self, table):
        return ref_dsm.DSMReplica.from_table(table)

    def manager(self, replica):
        return ref_consistency.ConsistencyManager(replica, on_pim=True,
                                                  backend=self.be)

    def update(self, cons, col, ups, per_island: bool):
        old = cons.replica.columns[col]
        if self.islands > 1 and per_island:
            cons.on_update_shards(col, ref_application.apply_updates_shards(
                old, ups, backend=self.be))
        else:
            cons.on_update(col, ref_application.apply_updates(
                old, ups, backend=self.be))

    @staticmethod
    def decoded(col):
        return np.asarray(ref_dsm.decode_column(col))

    make_entries = staticmethod(ref_nsm.make_entries)


def _updates(mod, rng, cons, col, commit_ids, allow_insert=True):
    m = int(rng.integers(1, 12))
    n_rows = cons.replica.columns[col].n_rows
    ops = rng.choice([1, 1, 1, 3] + ([2] if allow_insert else []), size=m)
    rows = rng.integers(0, n_rows, size=m).astype(np.int64)
    rows[ops == 2] = n_rows + np.arange(int((ops == 2).sum()))  # appends
    return mod.make_entries(
        np.array([next(commit_ids) for _ in range(m)], dtype=np.int64),
        ops.astype(np.int8),
        rng.integers(0, 1 << 20, size=m).astype(np.int32),
        rows,
        np.full(m, col, dtype=np.int32))


def _check_invariants(cons, handles):
    for c, chain in cons.chains.items():
        if chain.versions:
            assert chain.head is not None  # head never dropped
        for v in chain.versions:
            assert v.readers >= 0, f"negative readers on col {c}"
        ids = [v.version_id for v in chain.versions]
        assert ids == sorted(ids)  # chain stays version-ordered
    for h, pinned in handles.items():
        for c, (version, frozen) in pinned.items():
            assert version in cons.chains[c].versions, \
                f"pinned version GC'd (handle {h}, col {c})"
            assert version.readers >= 1


def _state(cons, handles, mod) -> tuple:
    """What the two packages must agree on after a step."""
    return (cons.chain_lengths(),
            {c: [(v.version_id, v.readers) for v in ch.versions]
             for c, ch in cons.chains.items()},
            {c: mod.decoded(col).tolist()
             for c, col in cons.replica.columns.items()},
            sorted(handles), cons.snapshots_created)


def _walk(mod, seed, n_steps) -> list:
    """The reference test's walk on `mod`; returns its record."""
    rng = np.random.default_rng(seed)
    table = rng.integers(0, 500, size=(N_ROWS, N_COLS)).astype(np.int32)
    replica = mod.replica(table)
    cons = mod.manager(replica)
    commit_ids = itertools.count()
    handles = {}  # handle -> {col: (version, frozen decoded values)}
    record = []

    for step in range(n_steps):
        op = rng.choice(["begin", "end", "update", "update"])
        if op == "begin" or (op == "end" and not handles):
            cols = sorted(rng.choice(N_COLS,
                                     size=int(rng.integers(1, N_COLS + 1)),
                                     replace=False).tolist())
            h = cons.begin_query(cols)
            handles[h] = {c: (cons._handles[h][c],
                              mod.decoded(cons.read(h, c)).copy())
                          for c in cols}
            record.append(("begin", h, {c: f.tolist()
                                        for c, (_, f) in handles[h].items()}))
        elif op == "end":
            h = int(rng.choice(sorted(handles)))
            for c, (version, frozen) in handles[h].items():
                np.testing.assert_array_equal(
                    mod.decoded(cons.read(h, c)), frozen,
                    err_msg=f"pinned read changed (handle {h}, col {c})")
            cons.end_query(h)
            del handles[h]
            record.append(("end", h))
        else:
            col = int(rng.integers(0, N_COLS))
            ups = _updates(mod, rng, cons, col, commit_ids)
            # the reference's draw for a per-island apply, taken on every
            # island count so that the walks stay in step
            per_island = bool(rng.random() < 0.5) if mod.islands > 1 \
                else False
            mod.update(cons, col, ups, per_island)
            record.append(("update", col))
        _check_invariants(cons, handles)
        record.append(_state(cons, handles, mod))

    for h in sorted(handles):
        cons.end_query(h)
    _check_invariants(cons, {})
    h = cons.begin_query(list(range(N_COLS)))
    cons.end_query(h)
    assert cons.chain_lengths() == {c: 1 for c in range(N_COLS)}
    record.append(_state(cons, {}, mod))
    return record


@pytest.mark.parametrize("spec,ref_spec", [
    ("torch", "numpy"), ("torch@2", "numpy@2"), ("torch@4", "numpy@4"),
    ("hopper@2/mesh", "numpy@2"), ("hopper@4/mesh", "numpy@4")])
@pytest.mark.parametrize("seed,n_steps", [(0, 60), (1, 120)])
def test_consistency_stress_matches_reference(spec, ref_spec, seed, n_steps):
    got = _walk(_Port(spec), seed, n_steps)
    want = _walk(_Ref(ref_spec), seed, n_steps)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"step record {i} differs"


def test_partial_shard_swap_rejected_mid_stress():
    """All-or-none Phase-2 on the mesh: a partial shard set must not
    corrupt chains, as the reference's stacked islands reject it."""
    port = _Port("hopper@2/mesh")
    rng = np.random.default_rng(7)
    table = rng.integers(0, 500, size=(N_ROWS, N_COLS)).astype(np.int32)
    replica = port.replica(table)
    cons = port.manager(replica)
    h = cons.begin_query([0])
    before = port.decoded(cons.read(h, 0)).copy()
    ups = _updates(port, rng, cons, 0, itertools.count(), allow_insert=False)
    shards = application.apply_updates_shards(replica.columns[0], ups,
                                              backend=port.be)
    with pytest.raises(ValueError, match="partial shard set"):
        cons.on_update_shards(0, shards[:1])
    np.testing.assert_array_equal(port.decoded(cons.read(h, 0)), before)
    _check_invariants(cons, {0: {0: (cons._handles[h][0], before)}})
    cons.end_query(h)
    # the reference rejects the same partial set the same way
    ref = _Ref("numpy@2")
    rr = ref.replica(table)
    rcons = ref.manager(rr)
    rshards = ref_application.apply_updates_shards(rr.columns[0], ups,
                                                   backend=ref.be)
    with pytest.raises(ValueError, match="partial shard set"):
        rcons.on_update_shards(0, rshards[:1])
