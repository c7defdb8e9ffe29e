"""propagate_idle_ms.train: device idle time a step while the host was
inside the token pipeline's `pipeline.propagate` span or one of its
children (`ship.*`, `apply.*`, `consistency.swap`), in ms, over the traced
stretch (`bench/program_trace.py`: each idle gap goes to the innermost
program span open at its start). The run also records the stretch's idle
seconds by harness range and, within it, by program span
(`idle_by_span`)."""

from bench import program_trace


def read(run):
    split = program_trace.idle_split(run)
    if split:
        run.extra.setdefault("readings", {})["idle_by_span"] = split
    return program_trace.idle_ms_per_step(run, "pipeline.propagate")
