"""The join-group scan: aggregate plus self-join counts in one launch.

Only this entry of the hash unit's module is ported so far; the bucket
probe (`probe`, `probe_sharded`, `build_table`) comes with the stacked
islands (ROADMAP.md queue 2, K8).

The self-join cardinality of a predicate's rows against the whole column
is ``sum(rcount[jcodes[mask & jvalid]])`` with ``rcount`` the build-side
occurrence histogram, i.e. a second exact scan with the histogram as the
dictionary. ``csrc/scan_exact.cu`` answers both lanes in one pass, reading
the filter column once.
"""

from __future__ import annotations

from repro_torch.kernels.dict_ops.ops import scan_exact, scan_exact_ref


def scan_filter_agg_join_ref(fcodes, acodes, jcodes, fvalid, jvalid, adict,
                             rcount, bounds):
    """Plain version of `scan_filter_agg_join`."""
    sums, counts, jsums = scan_exact_ref(fcodes, acodes, fvalid, adict,
                                         list(bounds), jcodes, jvalid,
                                         rcount).tolist()
    return list(zip(sums, counts, jsums))


def scan_filter_agg_join(fcodes, acodes, jcodes, fvalid, jvalid, adict,
                         rcount, bounds):
    """One join-query group in ONE launch (flat columns).

    For every (code_lo, code_hi) in `bounds` returns the exact
    ``(sum, count, join_count)`` triple, where sum/count aggregate
    ``adict[acodes]`` over the filter mask and join_count is the self-join
    cardinality against the build-side histogram `rcount` (int32, one
    occurrence count per join-dictionary value, valid rows only).
    """
    bounds = list(bounds)
    if fcodes.shape[0] == 0 or not bounds:
        return [(0, 0, 0) for _ in bounds]
    sums, counts, jsums = scan_exact(fcodes, acodes, fvalid, adict, bounds,
                                     jcodes, jvalid, rcount).tolist()
    return list(zip(sums, counts, jsums))
