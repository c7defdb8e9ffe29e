"""A closed loop of HTAP rounds on `repro_torch`'s `HTAPSession`.

Set-up: the table is made on the device from the seed, copied to the host
once, and handed to the session (which builds its row store and encodes
its replica on the device); then the warm-up rounds run. The window: round
after round, back to back, each `execute` of the round's transactions
(with the ship batches and applies that synchronous propagation runs
inline) and then one `query_batch` of its queries (which first flushes the
backlog), until `seconds` have passed; the last round that starts in time
ends the window. Every round's traffic is drawn from (seed, round) as the
window goes.

After the window the peak device memory is read, the replica's final
columns are decoded by the harness (dictionary[codes]; a row the replica
marks invalid reads as -1), the session is freed, and the reference
(`bench.reference.htap`) replays every round from the seed: a sample of
the rounds, drawn from the seed, has its answers compared, and the final
table is compared cell by cell.

A traced run calls `flush_updates` before `query_batch`, and in the
window's first third times it and `execute` between synchronizes; then it
profiles a stretch of rounds.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from bench.generators import Round, Rounds, make_columns
from bench.harness import Cell, Check, Measured
from bench.reference.htap import Table
from bench.trace import Profiler, Spans


def _program():
    from repro_torch.core import engine, schema, session
    from repro_torch.kernels.common import kernel_launch_shapes
    return engine, schema, session, kernel_launch_shapes


def make_session(cell: Cell):
    """The system under test: the configuration's preset with its spec
    overrides, over the table made from the seed."""
    engine, schema, session, _ = _program()
    cfg = cell.config
    cols = make_columns(cell.seed, cfg["rows"], cfg["cols"], cfg["distinct"],
                        cfg["domain"], cell.device)
    table = torch.stack(cols, dim=1)
    del cols
    host = table.cpu().numpy()
    del table
    spec = session.PRESETS[cfg["system"]](**cfg.get("spec", {}))
    return session.HTAPSession(spec, host, device=cell.device)


class Program:
    """The harness's calls into the session, one round at a time."""

    def __init__(self, cell: Cell, spans: Spans):
        self.engine, self.schema, _, _ = _program()
        factory = cell.hooks.get("session", make_session)
        self.session = factory(cell)
        self.spans = spans
        self.answers: dict[int, list[int]] = {}

    def round(self, rnd: Round) -> float:
        """Runs the round; returns the query batch's latency in seconds."""
        s, sp = self.session, self.spans
        if rnd.index:
            s.advance_round()
        with sp.range("traffic"):
            chunk = self.schema.UpdateStream(rnd.thread, rnd.commit, rnd.op,
                                             rnd.row, rnd.col, rnd.value)
            qs = [self.engine.Query(i, f, lo, hi, a, None if j < 0 else j)
                  for i, (f, lo, hi, a, j) in enumerate(rnd.queries)]
        with sp.timed("execute"):
            s.execute(chunk)
        t0 = time.perf_counter()
        if sp.timing:
            with sp.timed("flush_updates"):
                s.flush_updates()
        with sp.range("query_batch"):
            got = s.query_batch(qs)
        latency = time.perf_counter() - t0
        self.answers[rnd.index] = list(got)
        return latency

    def final_columns(self) -> dict:
        """The replica's columns decoded by the harness, on the device."""
        out = {}
        for c, col in self.session.replica.columns.items():
            vals = col.dictionary[col.codes.long()]
            out[int(c)] = torch.where(col.valid, vals, torch.full_like(vals, -1))
        return out


def run(cell: Cell) -> Measured:
    cfg, tr = cell.config, cell.traffic
    dev = cell.device
    spans = Spans(dev, cell.trace)
    launch_shapes = _program()[3]
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    gen = Rounds(cell.seed, cfg["rows"], cfg["cols"], cfg["domain"], tr)
    prog = Program(cell, spans)
    r = 0
    for _ in range(int(tr["warmup_rounds"])):
        with spans.range("round"):
            prog.round(gen.round(r))
        r += 1
    spans.sync()
    t0 = time.perf_counter()
    setup_s = t0 - cell.t_start
    spans.timing = cell.trace
    first = r
    latencies = []
    prof = Profiler(spans, launch_shapes)
    trace_from = t0 + cell.seconds / 3
    trace_for = float(tr.get("trace_seconds", 3.0))
    while True:
        now = time.perf_counter()
        if now - t0 >= cell.seconds:
            break
        if cell.trace and prof.trace is None:
            if not prof.running and now >= trace_from:
                spans.timing = False
                prof.start()
                traced_from = time.perf_counter()
            elif prof.running and now - traced_from >= trace_for:
                prof.stop()
        with spans.range("round"):
            with spans.range("traffic"):
                rnd = gen.round(r)
            latencies.append(prog.round(rnd))
        r += 1
    spans.sync()
    window_s = time.perf_counter() - t0
    if prof.running:
        prof.stop()
    rounds = r - first
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    got_cols = prog.final_columns()
    answers = prog.answers
    del prog
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks = judge(cell, gen, r, answers, got_cols)
    n_q, n_t = gen.n_queries, gen.txns
    return Measured(
        setup_s=setup_s, window_s=window_s,
        counts={"queries": rounds * n_q, "txns": rounds * n_t,
                "rounds": rounds},
        latencies_s={"query": [x for x in latencies for _ in range(n_q)]},
        spans=spans, trace=prof.trace, memory_peak_bytes=peak, checks=checks,
        attempted=rounds * (n_q + n_t), failed=0)


def judge(cell: Cell, gen: Rounds, n_rounds: int, answers: dict,
          got_cols: dict) -> list[Check]:
    """The reference replays rounds 0 .. n_rounds - 1 from the seed; the
    answers of `check_rounds` rounds drawn from the seed (the last round
    always among them) are compared, then the final table."""
    tr = cell.traffic
    k = min(int(tr["check_rounds"]), n_rounds)
    pick = np.random.default_rng([cell.seed, 2]).choice(
        n_rounds - 1, size=k - 1, replace=False) if k > 1 else []
    sample = set(int(x) for x in pick) | {n_rounds - 1}
    ref = Table(cell.seed, cell.config, cell.device)
    wrong = compared = 0
    for r in range(n_rounds):
        rnd = gen.round(r)
        ref.apply(rnd)
        if r in sample:
            want = ref.answers(rnd.queries)
            got = answers.get(r, [])
            compared += len(want)
            wrong += sum(g != w for g, w in zip(got, want))
            wrong += abs(len(want) - len(got))
    cells = ref.cells_differing(got_cols)
    del ref
    # a run that compared nothing is not correct
    return [Check("answers_wrong", wrong + (compared == 0), 0),
            Check("cells_wrong", cells, 0)]
