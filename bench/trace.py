"""The harness's own spans and the device trace of a traced run.

`Spans` records the harness's calls into the program's layers. In a
traced run each call is a `record_function` range, so the profiler's
trace can say what the host was doing while the device sat idle; while
`timing` is on (a traced run's first third), a call whose wall time a
per-layer metric reads is timed between two synchronizes. The profiled
stretch and the rest of the window run without those synchronizes, and an
untraced run has neither: the window runs as a user would drive it.

`Trace` holds what `torch.profiler` recorded over a steady stretch of the
window, reduced from its raw events (the event tree would take minutes to
build for a stretch of 100,000 launches): the device operations, the
harness's host ranges, the busy time (the union of the device operations'
intervals) and the stretch's wall time.
"""

from __future__ import annotations

import bisect
import contextlib
import statistics
import time

import torch

# the harness's ranges, outermost first: a gap is labelled by the innermost
# range that holds its start
RANGES = ("round", "step", "traffic", "execute", "flush_updates",
          "query_batch", "ingest", "pipeline", "propagate", "get_batch",
          "train_step")


class Spans:
    """Wall times of the harness's calls into the program, by name."""

    def __init__(self, device: torch.device, traced: bool):
        self.device = device
        self.traced = traced
        self.timing = False     # a driver turns it on for a stretch
        self.seconds: dict[str, list[float]] = {}

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def range(self, name: str):
        """A `record_function` range in a traced run, nothing otherwise."""
        if not self.traced:
            yield
            return
        with torch.profiler.record_function(name):
            yield

    @contextlib.contextmanager
    def timed(self, name: str, key: str | None = None):
        """While `timing` is on, the call's wall time between two
        synchronizes, kept under `key` (default `name`); otherwise the call
        in its range."""
        if not self.timing:
            with self.range(name):
                yield
            return
        self.sync()
        t0 = time.perf_counter()
        with torch.profiler.record_function(name):
            yield
            self.sync()
        self.seconds.setdefault(key or name, []).append(
            time.perf_counter() - t0)

    def median_ms(self, key: str) -> float | None:
        got = self.seconds.get(key)
        return statistics.median(got) * 1e3 if got else None


def _on_device(e) -> bool:
    """A device operation of the profile (kernel, copy or fill); a
    `record_function` range's projection on the device timeline is not
    one."""
    return (str(e.device_type()).endswith("CUDA")
            and not e.is_user_annotation())


class Trace:
    """A profiled stretch. `ops`: the device operations as (name, start
    ns, end ns); `ranges`: the harness's host ranges as (name, start ns,
    end ns); `window_s`: the stretch's wall time; `launch_shapes`: per
    kernel and launch shape, the launches the program counted in the
    stretch."""

    def __init__(self, ops, ranges, window_s: float, launch_shapes: dict):
        self.ops = sorted(ops, key=lambda o: o[1])
        self.ranges = ranges
        self.window_s = window_s
        self.launch_shapes = launch_shapes
        self.intervals = _merge((o[1], o[2]) for o in self.ops)
        self.busy_s = sum(b - a for a, b in self.intervals) / 1e9

    def op_seconds(self, match) -> float:
        """Device seconds of the operations whose name `match` accepts."""
        return sum(e - s for n, s, e in self.ops if match(n)) / 1e9

    def top_ops(self, k: int = 10) -> list:
        """The `k` device operations that took most time, summed by name,
        as [name, seconds]."""
        by = {}
        for n, s, e in self.ops:
            by[n] = by.get(n, 0) + (e - s)
        top = sorted(by.items(), key=lambda kv: -kv[1])[:k]
        return [[n[:120], v / 1e9] for n, v in top]

    def idle_gaps(self, k: int = 10) -> list:
        """Idle device time between operations, summed by the innermost
        harness range that held each gap's start on the host ("harness"
        where none did), as [label, seconds], the largest `k`."""
        if not self.intervals:
            return []
        spans = sorted(self.ranges, key=lambda r: r[1])
        starts = [r[1] for r in spans]
        depth = {name: i for i, name in enumerate(RANGES)}
        by = {}
        for (_, a), (b, _) in zip(self.intervals, self.intervals[1:]):
            i = bisect.bisect_right(starts, a)
            label, best = "harness", -1
            for name, s, e in spans[max(0, i - 512):i]:
                if s <= a <= e and depth.get(name, 0) >= best:
                    label, best = name, depth.get(name, 0)
            by[label] = by.get(label, 0) + (b - a)
        top = sorted(by.items(), key=lambda kv: -kv[1])[:k]
        return [[n, v / 1e9] for n, v in top]

    def breakdown(self) -> dict:
        return {"device_ops": self.top_ops(), "idle_gaps": self.idle_gaps()}


def idle_share(run):
    """The share of the traced stretch in which no operation ran on the
    device, 100 x (1 - busy / wall); None without a trace. The reader of
    every cell's `idle_share.*` metric."""
    t = run.trace
    if t is None or not t.window_s or not t.ops:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class Profiler:
    """Profiles one stretch of the window: `start()` before a round or
    step, `stop()` after one, both at a synchronize."""

    def __init__(self, spans: Spans, launch_shapes):
        self.spans = spans
        self.launch_shapes = launch_shapes     # the program's counter
        self.prof = None
        self.trace: Trace | None = None

    @property
    def running(self) -> bool:
        return self.prof is not None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.spans.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.spans.sync()
        self._shapes0 = self.launch_shapes()
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        self.spans.sync()
        window_s = time.perf_counter() - self._t0
        self.prof.__exit__(None, None, None)
        shapes = _shape_diff(self._shapes0, self.launch_shapes())
        events = self.prof.profiler.kineto_results.events()
        ops, ranges = [], []
        for e in events:
            if _on_device(e):
                ops.append((e.name(), e.start_ns(), e.end_ns()))
            elif (e.is_user_annotation() and e.name() in RANGES
                  and str(e.device_type()).endswith("CPU")):
                ranges.append((e.name(), e.start_ns(), e.end_ns()))
        self.prof = None
        self.trace = Trace(ops, ranges, window_s, shapes)


def _shape_diff(before: dict, after: dict) -> dict:
    out = {}
    for name, seen in after.items():
        old = before.get(name, {})
        got = {s: c - old.get(s, 0) for s, c in seen.items()
               if c - old.get(s, 0)}
        if got:
            out[name] = got
    return out
