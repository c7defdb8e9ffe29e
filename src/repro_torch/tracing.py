"""Spans and counters inside the program, on the profiler's clock.

A span marks one stage of the program's work::

    with tracing.span("apply.rewrite"):
        ...
    tracing.count("apply.rows_rewritten", n)

Spans are **off** unless a `torch.profiler` is active or a `recording()`
block is open. Off, `span` is one check of the profiler's module flag and
of this module's and returns a shared do-nothing context manager: it
allocates nothing and never enters `torch.profiler.record_function`, whose
idle cost is two orders of magnitude higher. Off, `count` returns at the
same check.

On, each span keeps a `Record`: its name, its parent (the innermost span
open on the same thread when it opened), its thread, start and end from
`time.time_ns()` (the clock Kineto stamps a trace's events with, so a
record can be laid beside a profile's device operations), the step where
the call has one, and the counts made while it was the innermost open span.
A span opened with ``device=`` a CUDA device also records a
`torch.cuda.Event` on the device's current stream at each end; the events
are read only when the records are read. While a profiler is active a span
also opens ``record_function(name)``, so a trace exported from that
profile shows the program's stages. Nothing here synchronizes: a count
known only on the device is kept as a device tensor and summed when the
records are read.

Names are ``<layer>.<stage>`` and never one of the benchmark harness's own
range names (``bench/trace.py``'s ``RANGES``), which label its idle gaps.
The records sit in a bounded deque (`MAX_RECORDS`), oldest dropped first.

The kernels' launch counters are a separate, always-on count of each CUDA
launch and its shape (`repro_torch.kernels.common.count_launch`).
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time

import torch
import torch.autograd.profiler as _autograd_profiler

MAX_RECORDS = 1 << 16

_recording = 0                      # open `recording()` blocks
_recording_lock = threading.Lock()
_records: collections.deque = collections.deque(maxlen=MAX_RECORDS)
_ids = itertools.count()
_local = threading.local()          # .stack: this thread's open records


class Record:
    """One finished span (or a count made with no span open, as a record
    of its own that starts and ends where it was made). `counts` and
    `device_ms` are resolved by `records()`."""

    __slots__ = ("id", "name", "parent", "thread", "step", "start_ns",
                 "end_ns", "counts", "device_ms", "_events")

    def __init__(self, name: str, parent: int | None, step):
        self.id = next(_ids)
        self.name = name
        self.parent = parent
        self.thread = threading.get_ident()
        self.step = step
        self.start_ns = self.end_ns = 0
        self.counts: dict = {}
        self.device_ms: float | None = None
        self._events = None


def enabled() -> bool:
    """Whether spans and counts are on: for a call site whose count costs
    work to compute."""
    return bool(_recording or _autograd_profiler._is_profiler_enabled)


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Off:
    """The context manager every span is while spans are off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def _stream_of(device):
    """The current stream of `device` when it is a CUDA device, else
    None."""
    if device is False:
        return None
    device = torch.device(device)
    return torch.cuda.current_stream(device) if device.type == "cuda" else None


class _Span:
    __slots__ = ("rec", "stream", "prof")

    def __init__(self, name: str, step, device):
        stack = _stack()
        self.rec = Record(name, stack[-1].id if stack else None, step)
        self.stream = _stream_of(device)
        self.prof = None

    def __enter__(self):
        rec = self.rec
        if _autograd_profiler._is_profiler_enabled:
            self.prof = torch.profiler.record_function(rec.name)
            self.prof.__enter__()
        if self.stream is not None:
            start = torch.cuda.Event(enable_timing=True)
            start.record(self.stream)
            rec._events = (start, None)
        _stack().append(rec)
        rec.start_ns = time.time_ns()
        return rec

    def __exit__(self, *exc):
        rec = self.rec
        rec.end_ns = time.time_ns()
        stack = _stack()
        if stack and stack[-1] is rec:
            stack.pop()
        if rec._events is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(self.stream)
            rec._events = (rec._events[0], end)
        if self.prof is not None:
            self.prof.__exit__(*exc)
        _records.append(rec)
        return False


def span(name: str, step=None, device=False):
    """A context manager around one stage of the program's work; `step`
    is the training step or round where the call has one; `device` the
    device the stage runs on: on a CUDA device the span also times the
    device's current stream between two events."""
    if not (_recording or _autograd_profiler._is_profiler_enabled):
        return _OFF
    return _Span(name, step, device)


def count(name: str, n) -> None:
    """Add `n` (an int, or a device tensor summed when read) to `name`'s
    count in the innermost span open on this thread."""
    if not (_recording or _autograd_profiler._is_profiler_enabled):
        return
    stack = _stack()
    if stack:
        stack[-1].counts.setdefault(name, []).append(n)
        return
    rec = Record(name, None, None)
    rec.start_ns = rec.end_ns = time.time_ns()
    rec.counts[name] = [n]
    _records.append(rec)


@contextlib.contextmanager
def recording():
    """Spans and counts on for the block, with or without a profiler."""
    global _recording
    with _recording_lock:
        _recording += 1
    try:
        yield
    finally:
        with _recording_lock:
            _recording -= 1


def _resolve(rec: Record) -> None:
    if rec._events is not None and rec._events[1] is not None:
        start, end = rec._events
        end.synchronize()
        rec.device_ms = start.elapsed_time(end)
        rec._events = None
    for name, parts in rec.counts.items():
        if isinstance(parts, list):
            rec.counts[name] = sum(int(p) for p in parts)


def records() -> list[Record]:
    """The finished records in the order they ended, their device events
    and device counts read (this waits for the work they cover)."""
    out = list(_records)
    for rec in out:
        _resolve(rec)
    return out


def clear() -> None:
    """Drop every finished record."""
    _records.clear()
