"""Analytical execution engine (§7): operators, query plans, execution.

Operators: scan/filter (predicate over an encoded column - the
order-preserving dictionary turns value ranges into code ranges, no decode),
aggregate, and the self-join. Queries follow the paper's microbenchmark
(§8: select + join over random tables/columns).

Cost accounting: `on_pim=True` prices sequential scans on vault-local
bandwidth with PIM-core cycles; `on_pim=False` prices them on the CPU across
the shared channel. Functional results are identical - that's asserted in
tests.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.backend import get_backend
from repro_torch.core.dsm import EncodedColumn
from repro_torch.core.hwmodel import CostLog
from repro_torch.core.placement import Placement

PIM_CYCLES_PER_ROW = 1.25  # fused compare+accumulate, 4 cores/vault
CPU_CYCLES_PER_ROW = 1.0   # OoO + SIMD
# gem5-scale working sets are partially cache-resident on the CPU island:
# only this fraction of scan bytes reaches the off-chip channel (§8).
ANA_MISS_FRACTION = 0.3


@dataclasses.dataclass(frozen=True)
class Query:
    """SELECT agg(agg_col) FROM t WHERE lo <= filter_col <= hi [JOIN ...]."""

    query_id: int
    filter_col: int
    lo: int
    hi: int
    agg_col: int
    join_col: int | None = None   # optional self-join column (paper: select+join)

    @property
    def columns(self) -> list[int]:
        cols = [self.filter_col, self.agg_col]
        if self.join_col is not None:
            cols.append(self.join_col)
        return cols


def gen_queries(rng: np.random.Generator, n_queries: int, n_cols: int,
                value_domain: int = 1 << 24, join_fraction: float = 0.5,
                selectivity: float = 0.3, same_column: bool = False) -> list[Query]:
    """The paper's analytical microbenchmark (§8)."""
    out = []
    for q in range(n_queries):
        if same_column:               # §9.4: all queries hit the same column
            f, a = 0, 1 % n_cols
        else:
            f = int(rng.integers(0, n_cols))
            a = int(rng.integers(0, n_cols))
        lo = int(rng.integers(0, int(value_domain * (1 - selectivity))))
        hi = lo + int(value_domain * selectivity)
        j = None
        if rng.random() < join_fraction:
            j = int(rng.integers(0, n_cols))
        out.append(Query(q, f, lo, hi, a, j))
    return out


def _launch_cost(cost: CostLog, on_pim: bool, n_launches: int) -> None:
    """Per-launch setup on the fixed-function scan path (priced by
    `HardwareParams.launch_overhead_s`). Fused query groups charge ONE
    launch for the whole group. The CPU software path has no kernel
    launches to set up."""
    if on_pim and n_launches:
        cost.add(phase="ana", island="ana", resource="launch",
                 items=float(n_launches))


def _query_cost(cost: CostLog, fcol, acol, jcol, n_sel: int, on_pim: bool):
    """Per-query cost events - identical whether queries run alone or fused
    (batching amortizes kernel *launches* - priced separately by
    `_launch_cost` - not the modeled scan traffic)."""
    scanned_bytes = fcol.encoded_bytes + acol.encoded_bytes
    rows = fcol.n_rows * 2
    if jcol is not None:
        scanned_bytes += 2 * jcol.encoded_bytes
        rows += 2 * jcol.n_rows
    if on_pim:
        # fused decode->filter->aggregate (kernels/dict_ops): one
        # sequential pass over the encoded columns.
        cost.add(phase="ana", island="ana", resource="pim",
                 cycles=rows * PIM_CYCLES_PER_ROW, bytes_local=scanned_bytes)
    else:
        # CPU software decodes selected aggregate values through the
        # dictionary (small, cache-resident: costs cycles, not traffic).
        cost.add(phase="ana", island="ana", resource="cpu",
                 cycles=rows * CPU_CYCLES_PER_ROW + n_sel * 2.0,
                 bytes_offchip=scanned_bytes * ANA_MISS_FRACTION)


def run_query_dsm(
    view: dict[int, EncodedColumn],
    q: Query,
    cost: CostLog | None = None,
    placement: Placement | None = None,
    on_pim: bool = True,
    backend=None,
) -> int:
    """Execute one query against (a snapshot view of) the DSM replica."""
    be = get_backend(backend)
    fcol, acol = view[q.filter_col], view[q.agg_col]
    jcol = None
    if q.join_col is None:
        result, n_sel = be.filter_agg(fcol, acol, q.lo, q.hi)
    else:
        result, n_sel, mask = be.filter_agg_mask(fcol, acol, q.lo, q.hi)
        jcol = view[q.join_col]
        result += be.hash_join_count(jcol, jcol, left_mask=mask)
    if cost is not None:
        _query_cost(cost, fcol, acol, jcol, n_sel, on_pim)
        _launch_cost(cost, on_pim, 1)  # a lone query is its own launch
    return result


def group_queries(queries: list[Query]) -> list[list[Query]]:
    """Group queries touching the same column set for fused execution.

    Order within a group follows the input; callers keep the original
    result order by mapping answers back through the query objects.
    """
    groups: dict[tuple, list[Query]] = {}
    for q in queries:
        groups.setdefault((q.filter_col, q.agg_col, q.join_col), []).append(q)
    return list(groups.values())


def run_query_group_dsm(
    view: dict[int, EncodedColumn],
    queries: list[Query],
    cost: CostLog | None = None,
    placement: Placement | None = None,
    on_pim: bool = True,
    backend=None,
) -> list[int]:
    """Execute a same-column-set query group as one fused multi-query scan.

    The backend answers all code-range predicates in a single pass over the
    encoded columns (HopperBackend: one kernel launch for the whole group,
    one device-to-host copy of the answers), which is what lets the
    accelerator path amortize launches. Cost events stay per-query, so
    modeled throughput matches unbatched execution. The delta-merged read
    (`deltas=`) comes with the delta-store plane (ROADMAP.md queue 1).
    """
    if not queries:
        return []
    be = get_backend(backend)
    q0 = queries[0]
    fcol, acol = view[q0.filter_col], view[q0.agg_col]
    # the group key includes join_col, so a group is homogeneous: either
    # every query is join-free (one fused multi-predicate scan) or every
    # query self-joins the same column (one fused scan+join call)
    no_join = [q for q in queries if q.join_col is None]
    joins = [q for q in queries if q.join_col is not None]
    answers: dict[int, tuple] = {}
    if no_join:
        bounds = [(q.lo, q.hi) for q in no_join]
        for q, sc in zip(no_join, be.filter_agg_batch(fcol, acol, bounds)):
            answers[id(q)] = sc
    if joins:
        bounds = [(q.lo, q.hi) for q in joins]
        jcol_v = view[q0.join_col]
        for q, scj in zip(joins, be.filter_agg_join_batch(fcol, acol, jcol_v,
                                                          bounds)):
            answers[id(q)] = scj
    out = []
    for q in queries:
        jcol = None
        if q.join_col is None:
            result, n_sel = answers[id(q)]
        else:
            s, n_sel, j = answers[id(q)]
            result = s + j
            jcol = view[q.join_col]
        if cost is not None:
            _query_cost(cost, fcol, acol, jcol, n_sel, on_pim)
        out.append(result)
    if cost is not None:
        # launch amortization: one fused launch answers every join-free
        # predicate in the group and one fused scan+join launch answers
        # every join predicate
        _launch_cost(cost, on_pim,
                     (1 if no_join else 0) + (1 if joins else 0))
    return out
