"""Analytical execution engine (§7): operators, query plans, execution.

Operators: scan/filter (predicate over an encoded column - the
order-preserving dictionary turns value ranges into code ranges, no decode),
aggregate, and the self-join. Queries follow the paper's microbenchmark
(§8: select + join over random tables/columns).

The single-instance baselines answer the same queries over the row store
in host numpy (`run_query_nsm`): they have no dictionary-encoded replica
for a kernel to scan, which is the point of the baseline.

Cost accounting: `on_pim=True` prices sequential scans on vault-local
bandwidth with PIM-core cycles; `on_pim=False` prices them on the CPU across
the shared channel. Functional results are identical - that's asserted in
tests.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.backend import get_backend
from repro_torch.core.dsm import ColumnDelta, EncodedColumn
from repro_torch.core.hwmodel import CostLog
from repro_torch.core.placement import Placement
from repro_torch.core.schema import VALUE_BYTES

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
    n_shards: int | None = None,
) -> int:
    """Execute one query against (a snapshot view of) the DSM replica.

    ``view`` maps column ids to columns or, on several islands, to their
    `ShardedView`s. ``n_shards`` > 1 fans the scan out over that many
    analytical islands with exact cross-shard reduction; an instance
    `backend` must match it (get_backend raises on conflict).
    """
    be = get_backend(backend, n_shards=n_shards)
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


def _live_delta(deltas, col_id) -> ColumnDelta | None:
    """The column's overlay, or None when absent/empty (no correction)."""
    if deltas is None or col_id is None:
        return None
    d = deltas.get(col_id)
    return d if d is not None and d.n_overlay else None


def _union_rows(*ds: ColumnDelta | None) -> np.ndarray | None:
    """Sorted union of the overlays' touched rows (None when all empty);
    host numpy, like the overlays."""
    parts = [d.rows for d in ds if d is not None and d.n_overlay]
    if not parts:
        return None
    return parts[0] if len(parts) == 1 else np.unique(np.concatenate(parts))


def _row_state(col: EncodedColumn, rows: torch.Tensor):
    """Base-column (value, valid) state of the given rows, gathered on the
    column's device (`rows`: int64 row ids there)."""
    codes = col.codes[rows]
    return col.dictionary[codes.long()].to(torch.int32), col.valid[rows]


def _overlayed(vals, valid, delta: ColumnDelta | None, rows):
    """Effective (value, valid) state: base overridden where overlayed."""
    if delta is None or delta.n_overlay == 0:
        return vals, valid
    d_rows, d_vals, d_valid = delta.on(rows.device)
    idx = torch.searchsorted(d_rows, rows).clamp_(max=delta.n_overlay - 1)
    hit = d_rows[idx] == rows
    return (torch.where(hit, d_vals[idx], vals),
            torch.where(hit, d_valid[idx], valid))


def _stack6(*lanes) -> torch.Tensor:
    return torch.stack([t.to(torch.int32) for t in lanes])


def _corr_stack(bf, ba, df, da):
    """(corr, n_rows): the aggregate correction stack the fused delta scan
    consumes - a (6, nr) int32 tensor of [fv_eff, av_eff, valid_eff,
    fv_base, av_base, valid_base] over the filter/agg overlays' touched-row
    union ((None, 0) when both overlays are empty), built on the columns'
    device from one upload of the row ids. Only touched rows can change;
    for those the effective contribution replaces the base one, so the
    backend folds ``effective - base`` into the base scan and everything
    else cancels exactly in integer arithmetic. The aggregate reads a row's
    value regardless of the aggregate column's own validity (matching the
    eager scan), hence valid=True on the agg side.
    """
    rows = _union_rows(df, da)
    if rows is None:
        return None, 0
    r = torch.from_numpy(rows).to(bf.device)
    fv_b, fvalid_b = _row_state(bf, r)
    av_b, _ = _row_state(ba, r)
    fv_e, fvalid_e = _overlayed(fv_b, fvalid_b, df, r)
    av_e, _ = _overlayed(av_b, torch.ones_like(fvalid_b), da, r)
    return _stack6(fv_e, av_e, fvalid_e, fv_b, av_b, fvalid_b), len(rows)


def _join_eff_histogram(bj: EncodedColumn, dj: ColumnDelta | None):
    """(rcount_eff, c_eff): the delta-merged self-join build side, on the
    column's device.

    rcount_eff[c] is the EFFECTIVE occurrence count of base dictionary
    value c - the base histogram (one `torch.bincount` over the column)
    adjusted by the join overlay's removals (overlay rows' base
    contributions) and additions (overlay rows' valid effective values).
    Nonnegative by construction (a true histogram). `c_eff(vals)` evaluates
    the same effective histogram at arbitrary raw values, including values
    absent from the base dictionary (freshly written ones).
    """
    dev = bj.device
    jdict = bj.dictionary.to(torch.int64)
    bc = torch.bincount(bj.codes[bj.valid].long(), minlength=bj.dict_size)
    if dj is None or dj.n_overlay == 0:
        dvals = torch.empty(0, dtype=torch.int64, device=dev)
        dcnt = dvals
        rc = bc
    else:
        rows, d_vals, d_valid = dj.on(dev)
        rem = jdict[bj.codes[rows][bj.valid[rows]].long()]
        add = d_vals[d_valid].to(torch.int64)
        sign = torch.cat([torch.full_like(rem, -1), torch.ones_like(add)])
        dvals, inv = torch.unique(torch.cat([rem, add]), sorted=True,
                                  return_inverse=True)
        dcnt = torch.zeros_like(dvals).index_add_(0, inv, sign)
        rc = bc.clone()
        if len(jdict):
            di = torch.searchsorted(jdict, dvals).clamp_(max=len(jdict) - 1)
            hit = jdict[di] == dvals
            rc.index_add_(0, di[hit], dcnt[hit])

    def c_eff(vals):
        vals = vals.to(torch.int64)
        out = torch.zeros_like(vals)
        for keys, counts in ((jdict, bc), (dvals, dcnt)):
            if len(keys):
                i = torch.searchsorted(keys, vals).clamp_(max=len(keys) - 1)
                out += torch.where(keys[i] == vals, counts[i], 0)
        return out

    return rc, c_eff


def _join_corr_stack(bf, bj, df, dj, c_eff):
    """(corr_j, n_rows): the self-join correction stack. The fused base
    scan (with the rcount_eff override) already counts every BASE-state
    probe row against the effective build side; rows whose filter or join
    state the overlays changed are swapped out by subtracting their
    base-state contribution and adding their effective-state contribution.
    The stack's value lanes carry the WEIGHTS of those two weighted
    raw-value scans - effective build-side counts of each row's join value
    - so the backend folds only the sum delta into the join term."""
    rows = _union_rows(df, dj)
    if rows is None:
        return None, 0
    r = torch.from_numpy(rows).to(bf.device)
    fv_b, fvalid_b = _row_state(bf, r)
    jv_b, jvalid_b = _row_state(bj, r)
    fv_e, fvalid_e = _overlayed(fv_b, fvalid_b, df, r)
    jv_e, jvalid_e = _overlayed(jv_b, jvalid_b, dj, r)
    w_b = torch.where(jvalid_b, c_eff(jv_b), 0)
    w_e = torch.where(jvalid_e, c_eff(jv_e), 0)
    return _stack6(fv_e, w_e, fvalid_e, fv_b, w_b, fvalid_b), len(rows)


def _correction_cost(cost: CostLog | None, on_pim: bool,
                     n_rows_scanned: int, n_rows_touched: int) -> None:
    """Correction-pass traffic: the overlay unions are tiny relative to the
    base column, so this prices a few short raw-value scans (value + weight
    + validity per row), not another column pass. Memory traffic is per
    TOUCHED row; compute cycles are per scanned row."""
    if cost is None or n_rows_scanned == 0:
        return
    if on_pim:
        cost.add(phase="ana", island="ana", resource="pim",
                 cycles=n_rows_scanned * PIM_CYCLES_PER_ROW,
                 bytes_local=n_rows_touched * 12.0)
    else:
        cost.add(phase="ana", island="ana", resource="cpu",
                 cycles=n_rows_scanned * CPU_CYCLES_PER_ROW * 2.0,
                 bytes_offchip=n_rows_touched * 12.0 * ANA_MISS_FRACTION)


def run_query_group_dsm(
    view: dict[int, EncodedColumn],
    queries: list[Query],
    cost: CostLog | None = None,
    placement: Placement | None = None,
    on_pim: bool = True,
    backend=None,
    n_shards: int | None = None,
    deltas: dict[int, ColumnDelta] | None = None,
    base_cols: dict[int, EncodedColumn] | None = None,
) -> list[int]:
    """Execute a same-column-set query group as one fused multi-query scan.

    The backend answers all code-range predicates in a single pass over the
    encoded columns (HopperBackend: one kernel launch for the whole group,
    one device-to-host copy of the answers), which is what lets the
    accelerator path amortize launches. With ``n_shards`` > 1 (or a
    ShardedBackend) every island scans its own shard of `view`'s columns
    or ShardedViews in that same single launch and the partials reduce
    exactly. Cost events stay per-query, so modeled throughput matches
    unbatched execution.

    ``deltas`` enables the delta-merged read: the base scan runs over the
    pinned snapshot and the overlays' exact corrections are folded in - an
    aggregate correction over the filter/agg overlays' touched rows and,
    for join groups, an effective build-side histogram plus a weighted
    probe-row correction (`_corr_stack` / `_join_corr_stack`); on
    HopperBackend base scan and corrections are ONE launch.
    ``base_cols`` must then map the involved columns to the base columns
    the overlays are relative to (appends never dirty the snapshot chain,
    so the pinned snapshot holds the same rows). Answers are those of
    applying the overlays eagerly.
    """
    if not queries:
        return []
    be = get_backend(backend, n_shards=n_shards)
    q0 = queries[0]
    fcol, acol = view[q0.filter_col], view[q0.agg_col]
    # the group key includes join_col, so a group is homogeneous: either
    # every query is join-free (one fused multi-predicate scan) or every
    # query self-joins the same column (one fused scan+join call)
    no_join = [q for q in queries if q.join_col is None]
    joins = [q for q in queries if q.join_col is not None]
    df = _live_delta(deltas, q0.filter_col)
    da = _live_delta(deltas, q0.agg_col)
    dj = _live_delta(deltas, q0.join_col)
    if (df or da or dj) and base_cols is None:
        raise ValueError("delta-merged reads need base_cols (the columns "
                         "the overlays are relative to)")
    corr_rows = corr_touched = 0
    answers: dict[int, tuple] = {}
    if no_join:
        bounds = [(q.lo, q.hi) for q in no_join]
        if df or da:
            corr, nr = _corr_stack(base_cols[q0.filter_col],
                                   base_cols[q0.agg_col], df, da)
            fused = be.filter_agg_delta_batch(fcol, acol, bounds, corr)
            corr_rows += 2 * nr
            corr_touched += nr
        else:
            fused = be.filter_agg_batch(fcol, acol, bounds)
        for q, sc in zip(no_join, fused):
            answers[id(q)] = sc
    if joins:
        bounds = [(q.lo, q.hi) for q in joins]
        jcol_v = view[q0.join_col]
        if df or da or dj:
            bf, ba = base_cols[q0.filter_col], base_cols[q0.agg_col]
            bj = base_cols[q0.join_col]
            rc, c_eff = _join_eff_histogram(bj, dj)
            corr_a, nr_a = _corr_stack(bf, ba, df, da)
            corr_j, nr_j = _join_corr_stack(bf, bj, df, dj, c_eff)
            fused_j = be.filter_agg_join_delta_batch(fcol, acol, jcol_v,
                                                     bounds, rc, corr_a,
                                                     corr_j)
            corr_rows += 2 * (nr_a + nr_j)
            corr_touched += nr_a + nr_j
        else:
            fused_j = be.filter_agg_join_batch(fcol, acol, jcol_v, bounds)
        for q, scj in zip(joins, fused_j):
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
        # every join predicate - the delta corrections ride INSIDE those
        # launches, so they add scan work (_correction_cost) but no
        # launches of their own
        _launch_cost(cost, on_pim,
                     (1 if no_join else 0) + (1 if joins else 0))
        _correction_cost(cost, on_pim, corr_rows, corr_touched)
    return out


# --------------------------------------------------------------------------
# NSM operators (single-instance baselines: analytics over the row store)
# --------------------------------------------------------------------------

# NSM scan traffic per touched column: the strided access pulls whole
# cachelines (~2x the value), but OoO prefetching keeps it streaming.
NSM_BYTES_PER_TOUCHED_COL = 2.0 * VALUE_BYTES


def run_query_nsm(
    table: np.ndarray,
    q: Query,
    cost: CostLog | None = None,
    backend=None,
) -> int:
    """Execute one query against an NSM table (strided row access, §3.1-(2)).

    `backend` is validated but row-store scans always run in host numpy:
    the CUDA kernels model the in-memory units, which operate on the
    dictionary-encoded DSM replica - the single-instance baselines never
    have one (that's the point of the baseline). Pass a resolved backend
    (the session passes its own); ``None`` resolves the GPU backend.
    """
    get_backend(backend)  # validate the selection even though it's unused
    jcol = q.join_col
    result = answer_from_values(table[:, q.filter_col], table[:, q.agg_col],
                                None if jcol is None else table[:, jcol], q)
    n_rows = table.shape[0]
    scanned = n_rows * 2 * NSM_BYTES_PER_TOUCHED_COL  # filter + agg columns
    rows = n_rows
    if jcol is not None:
        scanned += 2 * n_rows * NSM_BYTES_PER_TOUCHED_COL + n_rows * 6.0
        rows += 2 * n_rows
    if cost is not None:
        cost.add(phase="ana", island="ana", resource="cpu",
                 cycles=rows * CPU_CYCLES_PER_ROW * 1.5,
                 bytes_offchip=scanned * ANA_MISS_FRACTION)
    return result


def answer_from_values(fvals: np.ndarray, avals: np.ndarray,
                       jvals: np.ndarray | None, q: Query) -> int:
    """One query's answer from the values of its filter, aggregate and
    (optional) join columns, in host numpy: the sum of the aggregate over
    the selected rows plus, for the self-join, the number of (selected
    row, any row) pairs with equal join values."""
    mask = (fvals >= q.lo) & (fvals <= q.hi)
    result = int(avals[mask].astype(np.int64).sum())
    if jvals is not None:
        uv, counts = np.unique(jvals, return_counts=True)
        lv, lcounts = np.unique(jvals[mask], return_counts=True)
        _, li, ri = np.intersect1d(lv, uv, return_indices=True)
        result += int((lcounts[li].astype(np.int64) * counts[ri]).sum())
    return result


def query_task_rows(queries: list[Query], n_rows: int) -> list[tuple[int, int, float]]:
    """(query_id, col_id, rows) scan list for the scheduler (§7.2)."""
    out = []
    for q in queries:
        out.append((q.query_id, q.filter_col, n_rows))
        out.append((q.query_id, q.agg_col, n_rows))
        if q.join_col is not None:
            out.append((q.query_id, q.join_col, n_rows))
    return out
