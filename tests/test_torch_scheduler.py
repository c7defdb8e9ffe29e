"""The port's task scheduler (`core/scheduler.py`, §7.2) against the JAX
package's, on the same task sets.

Mirrors tests/test_scheduler.py and tests/test_scheduler_properties.py:
fine-grained segments against the basic heuristic, stealing on skew, work
conservation and the makespan bounds (a seeded sweep, and hypothesis where
it is installed). Every `make_tasks` list and `SchedResult` must equal the
reference's field for field: the simulator is plain float arithmetic over
the same tasks, tolerance 0.
"""

import dataclasses

import numpy as np
import pytest

from repro.core import engine as ref_engine
from repro.core import placement as ref_placement
from repro.core import scheduler as ref_scheduler
from repro.core.hwmodel import HMC_PARAMS as REF_HMC
from repro_torch.core import engine
from repro_torch.core.hwmodel import HMC_PARAMS
from repro_torch.core.placement import hybrid, local, remote
from repro_torch.core.scheduler import (SEGMENT_ROWS, SchedResult, Task,
                                        make_tasks, simulate)

PLACEMENT = hybrid(16)
REF_PLACEMENT = ref_placement.hybrid(16)
N_WORKERS = PLACEMENT.n_vaults * HMC_PARAMS.pim_cores_per_vault
GROUP_PENALTY = 1.15
REMOTE_PENALTY = 2.0
POLICIES = ("static_push", "pull", "pull_steal")


def _same_as_reference(tasks, placement=PLACEMENT,
                       ref_place=REF_PLACEMENT, **kw) -> SchedResult:
    """simulate() in both packages; the port's result, checked equal."""
    got = simulate(tasks, placement, HMC_PARAMS, **kw)
    want = ref_scheduler.simulate(
        [ref_scheduler.Task(**dataclasses.asdict(t)) for t in tasks],
        ref_place, REF_HMC, **kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.utilization == want.utilization
    return got


def _skewed_queries(n_queries=8, n_rows=100_000):
    # §9.4 setup: all queries hit the same column -> one busy group
    return [(q, 0, n_rows) for q in range(n_queries)]


@pytest.mark.parametrize("fine", [True, False])
@pytest.mark.parametrize("make", ["hybrid", "local", "remote"])
def test_make_tasks_matches_reference(make, fine):
    placement = {"hybrid": hybrid, "local": local, "remote": remote}[make](16)
    ref_place = getattr(ref_placement, make)(16)
    queries = engine.gen_queries(np.random.default_rng(3), 6, 8)
    rows = engine.query_task_rows(queries, 12_345)
    assert rows == ref_engine.query_task_rows(queries, 12_345)
    got = make_tasks(rows, placement, HMC_PARAMS, 4.0, fine_grained=fine)
    want = ref_scheduler.make_tasks(rows, ref_place, REF_HMC, 4.0,
                                    fine_grained=fine)
    assert [dataclasses.asdict(t) for t in got] == \
        [dataclasses.asdict(t) for t in want]
    for policy in POLICIES:
        _same_as_reference(got, placement, ref_place, policy=policy)


def test_fine_grained_tasks_segment_count():
    tasks = make_tasks([(0, 0, 10_000)], PLACEMENT, HMC_PARAMS, 4.0)
    assert len(tasks) == (10_000 + SEGMENT_ROWS - 1) // SEGMENT_ROWS
    coarse = make_tasks([(0, 0, 10_000)], PLACEMENT, HMC_PARAMS, 4.0,
                        fine_grained=False)
    assert len(coarse) <= (PLACEMENT.vaults_per_group
                           * HMC_PARAMS.pim_cores_per_vault)


def test_stealing_beats_static_on_skew():
    tasks = make_tasks(_skewed_queries(), PLACEMENT, HMC_PARAMS, 4.0)
    t_static = _same_as_reference(tasks, policy="static_push")
    t_pull = _same_as_reference(tasks, policy="pull")
    t_steal = _same_as_reference(tasks, policy="pull_steal")
    assert t_steal.makespan < t_pull.makespan
    assert t_steal.makespan < t_static.makespan
    assert t_steal.stolen_remote > 0
    assert t_steal.utilization > t_static.utilization


def test_balanced_load_and_every_task_once():
    tasks = make_tasks([(q, c, 50_000) for q, c in enumerate(range(4))],
                       PLACEMENT, HMC_PARAMS, 4.0)
    assert _same_as_reference(tasks, policy="pull_steal").utilization > 0.5
    tasks = make_tasks(_skewed_queries(4, 20_000), PLACEMENT, HMC_PARAMS, 4.0)
    res = _same_as_reference(tasks, policy="pull_steal")
    total_work = sum(t.seconds_local for t in tasks)
    assert sum(res.busy) >= total_work
    assert res.makespan >= total_work / len(res.busy)


# ---------------------------------------------------------------------------
# properties (tests/test_scheduler_properties.py), each run held equal to
# the reference's
# ---------------------------------------------------------------------------

def _tasks(vaults, durations):
    return [Task(i, 0, int(v) // PLACEMENT.vaults_per_group, int(v), float(d))
            for i, (v, d) in enumerate(zip(vaults, durations))]


def _check_properties(tasks):
    total = sum(t.seconds_local for t in tasks)
    longest = max(t.seconds_local for t in tasks)

    pull = _same_as_reference(tasks, policy="pull")
    assert np.isclose(sum(pull.busy), total, rtol=1e-9)
    assert pull.stolen_group == pull.stolen_remote == 0
    assert pull.makespan >= longest * (1 - 1e-12)
    assert pull.makespan >= total / N_WORKERS * (1 - 1e-12)

    steal = _same_as_reference(tasks, policy="pull_steal")
    assert sum(steal.busy) >= total * (1 - 1e-9)
    assert sum(steal.busy) <= total * REMOTE_PENALTY * (1 + 1e-9)
    assert sum(steal.busy) <= (
        total + (GROUP_PENALTY - 1.0) * steal.stolen_group * longest
        + (REMOTE_PENALTY - 1.0) * steal.stolen_remote * longest) * (1 + 1e-9)
    assert steal.stolen_group + steal.stolen_remote <= len(tasks)
    assert steal.makespan >= longest * (1 - 1e-12)
    assert steal.makespan >= total / N_WORKERS * (1 - 1e-12)
    assert steal.makespan <= pull.makespan * REMOTE_PENALTY * (1 + 1e-9)

    free = _same_as_reference(tasks, policy="pull_steal",
                              group_steal_penalty=1.0,
                              remote_steal_penalty=1.0)
    assert np.isclose(sum(free.busy), total, rtol=1e-9)
    assert free.makespan <= pull.makespan * (1 + 1e-9)

    static = _same_as_reference(tasks, policy="static_push")
    assert np.isclose(sum(static.busy), total, rtol=1e-9)
    assert static.makespan >= longest * (1 - 1e-12)


@pytest.mark.parametrize("block", range(4))
def test_properties_seeded_sweep(block):
    """Deterministic sweep usable without hypothesis: 40 seeds in four
    blocks."""
    for seed in range(10 * block, 10 * block + 10):
        rng = np.random.default_rng(seed)
        n = int(rng.integers(1, 120))
        vaults = rng.integers(0, PLACEMENT.n_vaults, n)
        durations = rng.uniform(1e-7, 1e-3, n)
        _check_properties(_tasks(vaults, durations))


def test_single_task_runs_alone():
    res = _same_as_reference(_tasks([0], [1e-4]), policy="pull_steal")
    assert np.isclose(res.makespan, 1e-4)
    assert res.stolen_group == res.stolen_remote == 0
    res3 = _same_as_reference(_tasks([3], [1e-4]), policy="pull_steal")
    assert np.isclose(res3.makespan, 1e-4 * GROUP_PENALTY)
    assert res3.stolen_group == 1


def test_empty_task_set():
    for policy in POLICIES:
        res = _same_as_reference([], policy=policy)
        assert res.makespan == 0.0 and sum(res.busy) == 0.0
        assert res.utilization == 1.0


def test_property_hypothesis():
    pytest.importorskip(
        "hypothesis",
        reason="property tests need hypothesis (pip install .[test])")
    from hypothesis import given, settings, strategies as st

    @settings(max_examples=60, deadline=None)
    @given(st.lists(
        st.tuples(st.integers(0, PLACEMENT.n_vaults - 1),
                  st.floats(1e-7, 1e-2, allow_nan=False,
                            allow_infinity=False)),
        min_size=1, max_size=150))
    def prop(pairs):
        _check_properties(_tasks([v for v, _ in pairs],
                                 [d for _, d in pairs]))

    prop()


def test_property_hypothesis_skewed_single_vault():
    pytest.importorskip(
        "hypothesis",
        reason="property tests need hypothesis (pip install .[test])")
    from hypothesis import given, settings, strategies as st

    @settings(max_examples=30, deadline=None)
    @given(st.lists(st.floats(1e-6, 1e-3, allow_nan=False,
                              allow_infinity=False),
                    min_size=HMC_PARAMS.pim_cores_per_vault + 1,
                    max_size=200))
    def prop(durations):
        tasks = _tasks([0] * len(durations), durations)
        pull = _same_as_reference(tasks, policy="pull")
        steal = _same_as_reference(tasks, policy="pull_steal",
                                   group_steal_penalty=1.0,
                                   remote_steal_penalty=1.0)
        assert steal.stolen_group + steal.stolen_remote > 0
        assert steal.makespan <= pull.makespan * (1 + 1e-9)
        _check_properties(tasks)

    prop()
