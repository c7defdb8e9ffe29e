"""Round-by-round discrete-event cost timeline (§5/§6 async propagation).

The phase-bucket model (`hwmodel.HardwareModel.time`) sums whole-run phase
totals per island and only approximates concurrency by moving the
analytical island's non-query phases into a side ``accel`` bucket. This
module replays a tagged `CostLog` as a dependency-ordered event graph
instead — a deterministic, heap-free list schedule — so that

* update shipping / per-column application / snapshot copies on the
  in-memory units overlap the PIM query cores round by round (the paper's
  §5/§6 performance-isolation design),
* a query group starts when its *pinned snapshot* exists, not when the
  whole run's propagation is done — propagation of round r+1 overlaps
  analytics over round r, exactly the consistency contract
  `ConsistencyManager` enforces, and
* data freshness (commit-to-visibility lag, the quantity the accelerators
  actually bound) becomes measurable per ship batch.

Node graph per round: txn execution -> log drain -> ship -> per-column
apply -> Phase-2 swap (visibility) -> snapshot -> query group. Nodes are
tagged at the emission sites (`CostLog.tagged` in the session, with
`CostLog.annotate` metadata from shipping/application/consistency) and
scheduled onto three serial lanes:

* ``txn``   — the transactional island's CPU (or PIM txn threads),
* ``ana``   — the analytical island's query cores,
* ``accel`` — the fixed-function propagation/snapshot units (merge, hash,
  sort, copy); in the software baselines (`on_pim=False`) propagation
  events carry ``island="txn"`` and land in the ``txn`` lane instead —
  which is precisely why async propagation cannot help the MI baseline.

Synchronous vs asynchronous propagation: in sync mode the txn island
stalls at a round boundary until the previous round's updates are applied
(`TimelineTag.sync_deps`); in async mode those edges are dropped and a
ship batch is released as soon as its last update has committed
(interpolated over the txn node's commit-id span), so the txn island never
waits on application. Functional answers are identical either way — the
timeline prices the very same events, it only changes *when* they run.

The timing model is chosen per spec (``timing=``); ``None`` means
``"phase"``. There is no process-wide default and no environment variable.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict

from repro_torch.core.hwmodel import CostLog, HardwareModel, TimelineTag

TIMINGS = ("phase", "timeline")


def resolve_timing(timing: str | None) -> str:
    """None -> ``"phase"``; anything outside `TIMINGS` raises."""
    if timing is None:
        return "phase"
    if timing not in TIMINGS:
        raise ValueError(f"unknown timing {timing!r}; have {TIMINGS}")
    return timing


@dataclasses.dataclass
class ScheduledNode:
    tag: TimelineTag
    lane: str
    seconds: float
    start: float = 0.0
    finish: float = 0.0


@dataclasses.dataclass
class TimelineResult:
    """One scheduled replay of a tagged CostLog."""

    makespan: float
    lane_finish: dict            # lane -> finish time of its last node
    lane_busy: dict              # lane -> sum of node durations
    freshness: dict | None       # {"mean": s, "max": s, "n_batches": k} | None
    nodes: list[ScheduledNode]

    @property
    def utilization(self) -> dict:
        """Per-lane busy fraction of the run (busy / makespan)."""
        if self.makespan <= 0:
            return {lane: 1.0 for lane in self.lane_busy}
        return {lane: busy / self.makespan
                for lane, busy in self.lane_busy.items()}


def _lane_of(tag: TimelineTag, events) -> str:
    """Lane a node executes on (see module docstring)."""
    if tag.kind == "txn":
        return "txn"
    if tag.kind == "ana":
        return "ana"
    # propagation/snapshot stages: the island of their events decides
    # whether they run on the in-memory units (ana -> "accel") or burn txn
    # CPU (the software baselines). Zero-cost stages (no events) still
    # chain dependencies; park them on the accel lane, where a
    # zero-duration node is invisible.
    islands = {e.island for e in events}
    return "accel" if (not islands or "ana" in islands) else "txn"


def _node_model(model: HardwareModel, tag: TimelineTag,
                cache: dict) -> HardwareModel:
    """The hardware model a node is priced under.

    Every MI-family node carries its emission-time analytical island count
    in ``meta["islands"]``; a node emitted under a different count than
    the run's ``hw.n_ana_islands`` is priced with a model scaled to *its*
    count. Nodes without the annotation (and every session whose count
    never changes, where the counts agree) price under the base model.
    """
    k = tag.meta.get("islands")
    if not k or int(k) == model.p.n_ana_islands:
        return model
    k = int(k)
    m = cache.get(k)
    if m is None:
        m = HardwareModel(dataclasses.replace(model.p, n_ana_islands=k))
        cache[k] = m
    return m


class _CommitClock:
    """Piecewise-linear commit-id -> time map over scheduled txn nodes.

    Each txn node's commit-id span is assumed to commit uniformly over the
    node's scheduled [start, finish] interval; ids between nodes clamp to
    the nearest boundary.
    """

    def __init__(self):
        self._spans: list[tuple[int, int, float, float]] = []

    def observe(self, tag: TimelineTag, start: float, finish: float) -> None:
        lo, hi = tag.meta.get("cid_lo", -1), tag.meta.get("cid_hi", -1)
        if lo >= 0 and hi >= lo:
            self._spans.append((int(lo), int(hi), start, finish))

    def time_of(self, cid: int) -> float:
        # Max over every span's contribution, where a span contributes its
        # interpolated time for ids inside it, its finish for ids past it
        # and nothing for ids before it. Each contribution is monotone in
        # cid, so the max is monotone too — for ANY span list, including
        # out-of-order or overlapping observations (chunked sessions can
        # emit spans whose scheduled times interleave). Ids in inter-span
        # gaps clamp to the enclosing boundary (the previous span's
        # finish); ids before every span map to 0.0 (committed before the
        # simulation started).
        t = 0.0
        for lo, hi, start, finish in self._spans:
            if cid < lo:
                continue
            if cid >= hi:
                # exact at the boundary: start + 1.0 * (finish - start) can
                # land one ulp past `finish`, which would make the last id
                # of a span later than the first id after it
                t = max(t, finish)
            else:
                frac = (cid - lo + 1) / (hi - lo + 1)
                t = max(t, start + frac * (finish - start))
        return t


def simulate_timeline(log: CostLog, model: HardwareModel,
                      async_propagation: bool = False,
                      concurrent_islands: bool = True) -> TimelineResult:
    """Deterministic list-scheduling replay of a tagged CostLog.

    Nodes run in emission (seq) order within their lane — the units are
    pipelined in program order — starting at
    ``max(lane free, dependency finishes, release time)``. Off-chip
    contention uses the same proportional channel shares as the
    phase-bucket model, so a node's duration equals its phase-model
    contribution and only the *overlap* differs.
    """
    by_node = defaultdict(list)
    untagged = []
    for e in log.events:
        (by_node[e.node] if e.node else untagged).append(e)
    if untagged and log.tags:
        raise ValueError(
            f"{len(untagged)} cost events are untagged; timeline timing "
            "needs every emission site wrapped in CostLog.tagged")
    if not log.tags:
        # nothing tagged (e.g. a bare CostLog): degenerate single-lane view
        return TimelineResult(0.0, {}, {}, None, [])

    shares = model.offchip_shares(log, concurrent_islands)
    tags = sorted(log.tags.values(), key=lambda t: t.seq)
    scheduled: dict[str, ScheduledNode] = {}
    lane_free: dict[str, float] = defaultdict(float)
    lane_busy: dict[str, float] = defaultdict(float)
    clock = _CommitClock()
    models: dict[int, HardwareModel] = {}  # island count -> scaled model

    for tag in tags:
        events = by_node.get(tag.node, [])
        lane = _lane_of(tag, events)
        seconds = (_node_model(model, tag, models).node_seconds(events,
                                                               shares)
                   if events else 0.0)
        # zero-cost nodes (shared snapshots, zero_cost_propagation stages)
        # exist only to chain dependencies: they consume no lane time, so
        # they neither wait for the lane nor hold it
        start = lane_free[lane] if events else 0.0
        deps = tag.deps if async_propagation else tag.deps + tag.sync_deps
        for d in deps:
            if d in scheduled:
                start = max(start, scheduled[d].finish)
        if async_propagation and tag.kind == "ship":
            # released once its newest update has committed — shipping
            # overlaps the txn execution that fills the final log (the
            # txn-node edge lives in sync_deps, dropped above)
            cid_hi = tag.meta.get("cid_hi", -1)
            if cid_hi >= 0:
                start = max(start, clock.time_of(int(cid_hi)))
        node = ScheduledNode(tag, lane, seconds, start, start + seconds)
        scheduled[tag.node] = node
        if events:
            lane_free[lane] = node.finish
            lane_busy[lane] += seconds
        if tag.kind == "txn":
            clock.observe(tag, node.start, node.finish)

    nodes = [scheduled[t.node] for t in tags]
    lane_finish = dict(lane_free)
    makespan = max(lane_finish.values(), default=0.0)
    return TimelineResult(makespan, lane_finish, dict(lane_busy),
                          _freshness(nodes, scheduled, clock), nodes)


def _freshness(nodes, scheduled, clock: _CommitClock) -> dict | None:
    """Commit-to-visibility lag per ship batch, weighted by update count.

    A batch becomes visible at the Phase-2 swap of its last per-column
    apply (or at ship completion when application is free). Commit times
    interpolate the batch's commit-id span through the txn nodes' schedule.
    """
    visibility: dict[str, float] = {}
    for n in nodes:
        if n.tag.kind != "apply":
            continue
        for d in n.tag.deps:
            if d in scheduled and scheduled[d].tag.kind == "ship":
                visibility[d] = max(visibility.get(d, 0.0), n.finish)
    lag_sum = weight = 0.0
    lag_max = None
    n_batches = 0
    for n in nodes:
        if n.tag.kind != "ship":
            continue
        m = n.tag.meta
        n_upd = m.get("n_updates", 0)
        if n_upd <= 0 or m.get("cid_lo", -1) < 0:
            continue
        visible = visibility.get(n.tag.node, n.finish)
        t_first = clock.time_of(int(m["cid_lo"]))
        t_last = clock.time_of(int(m["cid_hi"]))
        lag_sum += (visible - (t_first + t_last) / 2.0) * n_upd
        weight += n_upd
        lag_max = max(lag_max or 0.0, visible - t_first)
        n_batches += 1
    if not n_batches:
        return None
    return {"mean": lag_sum / weight, "max": lag_max, "n_batches": n_batches}


def query_latencies(result: TimelineResult) -> list[float]:
    """Per-query latency samples from a scheduled timeline.

    A query's latency runs from the moment its snapshot pin *could* start
    (the snapshot node's scheduled start — data visible, waiting only on
    the ana lane and the copy units) to its query group's finish. Fused
    groups answer ``meta["n"]`` queries at once (the MI session annotates
    group sizes); each contributes one sample at the group's latency, so
    percentiles weight queries, not groups. Kinds without a snapshot stage
    (SI-MVCC, Ana-Only) measure from the query node's own start.
    """
    scheduled = {n.tag.node: n for n in result.nodes}
    lats: list[float] = []
    for n in result.nodes:
        if n.tag.kind != "ana":
            continue
        start = n.start
        for d in n.tag.deps:
            dep = scheduled.get(d)
            if dep is not None and dep.tag.kind == "snapshot":
                start = min(start, dep.start)
        lats.extend([n.finish - start] * int(n.tag.meta.get("n", 1)))
    return lats
