"""The program's own spans and counts in a traced run, laid beside the
device trace.

While a profiler is active the program keeps a record of each of its
spans (`repro_torch.tracing`): name, parent, thread, start and end on the
clock the profile's events are stamped with, the step, the counts made in
it and, for some spans, the device time between two CUDA events. The
per-layer metrics that read them share this reduction:

- the records of the traced stretch are those that fall between the start
  of its first harness `step` range and the end of its last;
- each idle gap between the device's busy intervals (`Trace.intervals`)
  goes to the innermost record open at the gap's start, on any thread (the
  one that opened last): the host work the device waited on;
- a stretch has as many steps as it has `train.step` records.

A program without `repro_torch.tracing` keeps no records, and every reader
then returns None.
"""

from __future__ import annotations

import bisect
import statistics

from bench.trace import RANGES


def program_records():
    """The program's records (`repro_torch.tracing.records()`); None where
    the program has no such module."""
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    return tracing.records()


def in_stretch(trace, records) -> list:
    """The records that fall between the first and the last harness
    `step` range of `trace`."""
    steps = [(s, e) for name, s, e in trace.ranges if name == "step"]
    if not steps or not records:
        return []
    lo = min(s for s, _ in steps)
    hi = max(e for _, e in steps)
    return [r for r in records if lo <= r.start_ns and r.end_ns <= hi]


def stretch(run) -> list:
    """The traced stretch's records of `run` ([] without a trace or
    records)."""
    if run.trace is None:
        return []
    return in_stretch(run.trace, program_records())


def gaps(trace) -> list:
    """The idle gaps between the device's busy intervals, as (start ns,
    end ns)."""
    iv = trace.intervals
    return [(a, b) for (_, a), (b, _) in zip(iv, iv[1:])]


def owners(records, points) -> list:
    """For each time in `points` (sorted or not), the innermost record open
    there on any thread (the one opened last), or None."""
    bounds = sorted({r.start_ns for r in records}
                    | {r.end_ns for r in records})
    seg = []                        # the owner of [bounds[i], bounds[i + 1])
    for b in bounds:
        best = None
        for r in records:
            if r.start_ns <= b < r.end_ns and (
                    best is None
                    or (r.start_ns, r.id) > (best.start_ns, best.id)):
                best = r
        seg.append(best)
    out = []
    for t in points:
        i = bisect.bisect_right(bounds, t) - 1
        out.append(seg[i] if i >= 0 else None)
    return out


def under(records, root: str) -> set:
    """The ids of the records named `root` and of all their descendants."""
    by_id = {r.id: r for r in records}
    hit = {}

    def test(r) -> bool:
        if r.id not in hit:
            parent = by_id.get(r.parent)
            hit[r.id] = r.name == root or (parent is not None
                                          and test(parent))
        return hit[r.id]
    return {r.id for r in records if test(r)}


def steps(records) -> int:
    return sum(r.name == "train.step" for r in records)


def idle_ms_per_step(run, root: str):
    """Device idle time a step while the host was inside `root` or one of
    its children, in ms; None without device operations or records."""
    recs = stretch(run)
    n = steps(recs)
    if not n or not run.trace.ops:
        return None
    idle = gaps(run.trace)
    ids = under(recs, root)
    got = owners(recs, [a for a, _ in idle])
    ns = sum(b - a for (a, b), o in zip(idle, got)
             if o is not None and o.id in ids)
    return ns / 1e6 / n


def idle_split(run) -> dict | None:
    """The stretch's idle seconds by the harness's range at each gap's
    start (its own rule: the innermost of `RANGES`) and, within it, by the
    innermost program span ("-" where none was open)."""
    recs = stretch(run)
    if not recs or not run.trace.ops:
        return None
    t = run.trace
    spans = sorted(t.ranges, key=lambda r: r[1])
    starts = [r[1] for r in spans]
    depth = {name: i for i, name in enumerate(RANGES)}
    idle = gaps(t)
    out: dict = {}
    for (a, b), o in zip(idle, owners(recs, [a for a, _ in idle])):
        i = bisect.bisect_right(starts, a)
        label, best = "harness", -1
        for name, s, e in spans[max(0, i - 512):i]:
            if s <= a <= e and depth.get(name, 0) >= best:
                label, best = name, depth.get(name, 0)
        by = out.setdefault(label, {})
        key = o.name if o is not None else "-"
        by[key] = by.get(key, 0) + (b - a)
    return {label: {k: ns / 1e9 for k, ns in by.items()}
            for label, by in out.items()}


def device_ms_median(run, name: str):
    """The median over the stretch's `name` records of their device time
    between the span's two events; None where none has one."""
    got = [r.device_ms for r in stretch(run)
           if r.name == name and r.device_ms is not None]
    return statistics.median(got) if got else None


def counts(records) -> dict:
    """The records' counts summed by name."""
    out: dict = {}
    for r in records:
        for k, v in r.counts.items():
            out[k] = out.get(k, 0) + v
    return out
