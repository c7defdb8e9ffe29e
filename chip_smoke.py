#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts and is right on a GPU.

    python3 chip_smoke.py            # needs one NVIDIA Hopper card and nvcc

Drives `repro_torch` only. Phases, each printing one JSON line:

1. ``env``       versions, nvcc, the card's name and power limit.
2. ``build``     builds the CUDA sources with nvcc (seconds = set-up time).
3. ``main_path`` one HTAP session of the full system (`Polynesia` preset,
                 ``backend="hopper"``) at 10,000,000 rows x 8 columns,
                 400,000 transactions, 32 queries, 4 rounds, plus one late
                 single write and query. Answers must equal the same run on
                 ``backend="torch"`` and an independent numpy evaluation
                 over the host row store; every kernel must have been
                 launched during the run. The wrappers record the shapes
                 they launched at.
4. ``islands``   the same session on analytical islands stacked on the
                 card, once per count of ``--islands`` (4, then 3: four
                 split the 10M rows evenly, three leave padded slots, so
                 the stacked views are copies), one line per run: answers
                 and final columns must equal the one-island session's bit
                 for bit (and the host evaluation every round); the sharded
                 scan and sharded join scan must carry every query group,
                 one launch per group as on one island.
5. ``ana_only``  the `Ana-Only` preset at the same size on ``"hopper"`` and
                 ``"hopper@4"`` (the first island count): lone join queries
                 go through the bucket probe; answers must equal the host
                 evaluation.
6. ``kernels``   every hand-written kernel launched on the card and held
                 against its plain PyTorch version with exact equality
                 (integers: tolerance 0), at edge shapes and at the shapes
                 the main path just gave it (the one it launched most, and
                 the largest where that is another; for the sharded scans
                 also the one each other island count launched most,
                 under ``at_islands``); times the kernel
                 (``ms``: back-to-back bare launches; ``wrapper_ms``:
                 through the public wrapper with its checks and
                 allocations), the plain version and, where one PyTorch
                 call computes the same function, that call.

Each kernel is checked against the path that runs it (counts set to 0 just
before the path, read just after): the one-island kernels against
``main_path``, the sharded scans against ``islands``, the bucket probe
against ``ana_only``. Then the ``{"kernels": [...]}`` summary, the card's
name and power limit, and as the last line ``{"ok": true, "device":
{...}}``. Any failed phase
raises: the script exits non-zero and prints no result. Without CUDA it
exits with code 2 before doing anything.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device-memory rate (data sheet)
# The kernels' arithmetic is 32/64-bit integer compares and adds outside the
# tensor cores; the float32 rate outside the tensor cores (data sheet) stands
# in as the card's peak for them.
ALU_OPS_PER_S = 67e12

REPLACES = {
    "scan_exact": "src/repro/kernels/dict_ops/dict_ops.py:63",
    "scan_exact_join": "src/repro/kernels/hash_probe/ops.py:218",
    "scan_exact_sharded": "src/repro/kernels/dict_ops/dict_ops.py:121",
    "scan_exact_join_sharded": "src/repro/kernels/hash_probe/ops.py:244",
    "hash_probe": "src/repro/kernels/hash_probe/hash_probe.py:90 "
                  "(sharded form: hash_probe.py:68)",
    "merge_runs": "src/repro/kernels/merge_runs/merge_runs.py:94",
    "bitonic_sort": "src/repro/kernels/bitonic_sort/bitonic_sort.py:103",
    "bitonic_apply": "src/repro/kernels/dict_ops/ops.py:310 "
                     "(bitonic_sort.py:103 + bitonic_sort.py:123)",
    "snapshot_copy": "src/repro/kernels/snapshot_copy/snapshot_copy.py:54",
}
SOURCES = {
    "scan_exact": "src/repro_torch/kernels/csrc/scan_exact.cu",
    "scan_exact_join": "src/repro_torch/kernels/csrc/scan_exact.cu",
    "scan_exact_sharded": "src/repro_torch/kernels/csrc/scan_exact.cu",
    "scan_exact_join_sharded": "src/repro_torch/kernels/csrc/scan_exact.cu",
    "hash_probe": "src/repro_torch/kernels/csrc/hash_probe.cu",
    "merge_runs": "src/repro_torch/kernels/csrc/merge_runs.cu",
    "bitonic_sort": "src/repro_torch/kernels/csrc/bitonic.cu",
    "bitonic_apply": "src/repro_torch/kernels/csrc/bitonic.cu",
    "snapshot_copy": "src/repro_torch/kernels/csrc/snapshot_copy.cu",
}
# the path that runs each kernel: its launches are counted on that path
PATH_OF = {"scan_exact_sharded": "islands",
           "scan_exact_join_sharded": "islands", "hash_probe": "ana_only"}
I32_MAX = 2**31 - 1


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def time_ms(fn, reps: int) -> float:
    """Mean milliseconds of `fn` on the card over `reps` launches (CUDA
    events around the whole run, after a warm-up call)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def max_abs_err(got, want) -> int:
    """Largest absolute difference over (tuples of) integer tensors."""
    if isinstance(got, torch.Tensor):
        got, want = (got,), (want,)
    err = 0
    for g, w in zip(got, want):
        if g.shape != w.shape:
            raise AssertionError(f"shape {tuple(g.shape)} != {tuple(w.shape)}")
        if g.numel():
            err = max(err, int((g.to(torch.int64) - w.to(torch.int64))
                               .abs().max()))
    return err


def must_equal(name: str, got, want) -> int:
    err = max_abs_err(got, want)
    if err != 0:
        raise AssertionError(f"kernel check {name!r}: differs from its plain "
                             f"version (max abs err {err}, tolerance 0)")
    return err


# ---------------------------------------------------------------------------
# phase 1 + 2
# ---------------------------------------------------------------------------

def phase_env() -> str:
    from repro_torch.kernels import build
    nvcc = subprocess.run([build._nvcc(), "--version"], check=True,
                          capture_output=True, text=True).stdout.strip()
    card = card_line()
    emit("env", torch=torch.__version__, cuda=torch.version.cuda,
         nvcc=nvcc.splitlines()[-1], card=card,
         device_name=torch.cuda.get_device_name(0),
         device_count=torch.cuda.device_count())
    return card


def phase_build() -> None:
    """Builds (with ptxas' report of each kernel's registers, when the
    library is not built yet) and loads the kernels."""
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    build.build_library(verbose_ptxas=True)
    nvcc_seconds = build.build_seconds()     # 0.0 when found built
    build.load_library()
    registers, entry = {}, None
    for line in build.build_log().splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "registers" in line and entry:
            registers[entry] = int(line.split("Used ")[1].split()[0])
    emit("build", seconds=round(time.perf_counter() - t0, 3),
         nvcc_seconds=nvcc_seconds,
         sources=sorted(p.name for p in build.CSRC.glob("*.cu")),
         library=str(build.build_library().name), registers=registers)


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------

def host_answers(data: np.ndarray, queries) -> list[int]:
    """Independent numpy evaluation of each query over a row-store table."""
    hist = {}
    out = []
    for q in queries:
        fvals = data[:, q.filter_col]
        mask = (fvals >= q.lo) & (fvals <= q.hi)
        res = int(data[mask, q.agg_col].astype(np.int64).sum())
        if q.join_col is not None:
            if q.join_col not in hist:
                _, inv, counts = np.unique(data[:, q.join_col],
                                           return_inverse=True,
                                           return_counts=True)
                hist[q.join_col] = counts[inv.reshape(-1)]
            res += int(hist[q.join_col][mask].astype(np.int64).sum())
        out.append(res)
    return out


def drive(spec, table, stream, late, queries, late_query, n_rounds,
          check_host: bool):
    """One session through the public entry points: n_rounds of
    execute + query_batch, then one late single write and one query.
    Returns (answers, seconds per round, session, RunResult)."""
    from repro_torch.core.session import HTAPSession
    from repro_torch.core.workload import split_queries, split_stream
    session = HTAPSession(spec, table)
    answers, seconds = [], []
    rounds = list(zip(split_stream(stream, n_rounds),
                      split_queries(queries, n_rounds)))
    rounds.append((late, [late_query]))
    for r, (chunk, qs) in enumerate(rounds):
        if r:
            session.advance_round()
        t0 = time.perf_counter()
        session.execute(chunk)
        got = session.query_batch(qs)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        if check_host:
            want = host_answers(session.store.data, qs)
            if got != want:
                raise AssertionError(
                    f"round {r}: answers differ from the host evaluation: "
                    f"{got} != {want}")
        answers.extend(got)
    return answers, seconds, session, session.finish()


def make_workload(args) -> dict:
    """The sessions' workload from --seed: table, update stream, queries,
    one late single write and one late query."""
    from repro_torch.core import engine, schema
    t0 = time.perf_counter()
    rng = np.random.default_rng(args.seed)
    sch = schema.make_schema("t", args.cols, 32)
    table = schema.gen_table(rng, sch, args.rows)
    stream = schema.gen_update_stream(rng, sch, args.rows, args.txns,
                                      write_ratio=0.5)
    queries = engine.gen_queries(rng, args.queries, args.cols,
                                 join_fraction=0.5)
    # the late single write: one column touched, so the ship batch takes
    # the single-column path (sort unit + dictionary merge on their own)
    late = schema.UpdateStream(
        thread_id=np.zeros(1, np.int32),
        commit_id=np.full(1, args.txns, np.int64), op=np.ones(1, np.int8),
        row=rng.integers(0, args.rows, size=1).astype(np.int64),
        col=np.zeros(1, np.int32),
        value=rng.integers(0, 1 << 24, size=1).astype(np.int32))
    late_query = engine.Query(args.queries, 0, 0, 1 << 24, 1, 0)
    return dict(table=table, stream=stream, late=late, queries=queries,
                late_query=late_query,
                setup_seconds=time.perf_counter() - t0)


def drive_spec(spec, wl, args, check_host: bool):
    return drive(spec, wl["table"], wl["stream"], wl["late"], wl["queries"],
                 wl["late_query"], args.rounds, check_host)


def same_columns(got: dict, want: dict, what: str) -> None:
    for c, col in got.items():
        ref = want[c]
        if not (torch.equal(col.codes, ref.codes)
                and torch.equal(col.valid, ref.valid)
                and torch.equal(col.dictionary, ref.dictionary)
                and col.version == ref.version):
            raise AssertionError(f"final column {c} differs: {what}")


def phase_main_path(args, wl) -> tuple[dict, dict, list, dict]:
    """Returns the launches per kernel and, per kernel, the launches each
    shape got, both of the `hopper` session alone, and that session's
    answers and final columns."""
    from repro_torch.core.session import SystemSpec
    from repro_torch.kernels.common import (kernel_launch_counts,
                                            kernel_launch_shapes,
                                            reset_kernel_launch_counts)
    torch.cuda.reset_peak_memory_stats()
    reset_kernel_launch_counts()
    answers, seconds, session, result = drive_spec(
        SystemSpec.polynesia(backend="hopper"), wl, args, check_host=True)
    launches = kernel_launch_counts()
    shapes = kernel_launch_shapes()
    peak = torch.cuda.max_memory_allocated()

    if len(answers) != args.queries + 1:
        raise AssertionError("wrong number of answers")
    cols = session.replica.columns
    for c, col in cols.items():
        for t in (col.codes, col.valid, col.dictionary):
            if t.device.type != "cuda":
                raise AssertionError(f"column {c} has a tensor on {t.device}")
    missing = [k for k in REPLACES
               if k not in PATH_OF and launches.get(k, 0) < 1]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing} (counts {launches})")
    if result.stats["kernel_launches"] != launches:
        raise AssertionError("session launch stats disagree with the counters")

    ref_answers, ref_seconds, ref_session, _ = drive_spec(
        SystemSpec.polynesia(backend="torch"), wl, args, check_host=False)
    if kernel_launch_counts() != launches:
        raise AssertionError("the plain backend launched a CUDA kernel")
    if answers != ref_answers:
        raise AssertionError(f"hopper answers {answers} != torch answers "
                             f"{ref_answers}")
    same_columns(cols, ref_session.replica.columns, "hopper vs torch")
    del ref_session

    total = sum(seconds)
    emit("main_path", rows=args.rows, cols=args.cols, txns=args.txns + 1,
         queries=len(answers), rounds=args.rounds, seed=args.seed,
         setup_seconds=wl["setup_seconds"], round_seconds=seconds,
         txns_per_s=(args.txns + 1) / total, queries_per_s=len(answers) / total,
         torch_backend_round_seconds=ref_seconds,
         ship_batches=session._ship_i, applications=session.applications,
         snapshots=session.cons.snapshots_created, launches=launches,
         distinct_launch_shapes={k: len(v) for k, v in shapes.items()},
         max_dictionary=max(c.dict_size for c in cols.values()),
         peak_device_bytes=peak, modeled_txn_seconds=result.txn_seconds,
         modeled_ana_seconds=result.ana_seconds,
         answers_checksum=sum(answers), ok=True)
    return launches, shapes, answers, cols


SCANS = ("scan_exact", "scan_exact_join")
SHARDED_SCANS = ("scan_exact_sharded", "scan_exact_join_sharded")


def phase_islands(args, wl, one_launches, one_answers, one_cols
                  ) -> tuple[dict, dict]:
    """The main path on each island count of `args.islands`, stacked on the
    card; returns the launches and launch shapes of all its runs."""
    from repro_torch.core.session import SystemSpec
    from repro_torch.kernels.common import (kernel_launch_counts,
                                            kernel_launch_shapes,
                                            reset_kernel_launch_counts)
    one_scans = sum(one_launches.get(k, 0) for k in SCANS)
    reset_kernel_launch_counts()
    for n in args.islands:
        before = kernel_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        # the one-island session's final columns stay allocated for the
        # comparison; the run's own peak is the peak above them
        held = torch.cuda.memory_allocated()
        answers, seconds, session, result = drive_spec(
            SystemSpec.polynesia(backend="hopper", n_shards=n), wl, args,
            check_host=True)
        after = kernel_launch_counts()
        launches = {k: v - before.get(k, 0) for k, v in after.items()
                    if v != before.get(k, 0)}
        peak = torch.cuda.max_memory_allocated()

        if answers != one_answers:
            raise AssertionError(f"hopper@{n} answers {answers} != "
                                 f"one-island answers {one_answers}")
        same_columns(session.replica.columns, one_cols,
                     f"hopper@{n} vs one island")
        missing = [k for k in SHARDED_SCANS if launches.get(k, 0) < 1]
        if missing or any(launches.get(k, 0) for k in SCANS):
            raise AssertionError(f"the islands' scans did not run sharded: "
                                 f"{launches}")
        n_scans = sum(launches.get(k, 0) for k in SHARDED_SCANS)
        if n_scans != one_scans:
            raise AssertionError(f"{n_scans} sharded scan launches on {n} "
                                 f"islands, {one_scans} on one: one launch "
                                 "per query group is the contract")
        stats = result.stats
        if (stats["islands"] != n or stats["sharded_views"] < 1
                or session.hw.n_ana_islands != n):
            raise AssertionError(f"the session did not run on islands: "
                                 f"{stats}")
        n_rows = next(iter(session.replica.columns.values())).n_rows
        total = sum(seconds)
        emit("islands", islands=n, rows=n_rows,
             padded_slots=-(-n_rows // n) * n - n_rows,
             round_seconds=seconds, txns_per_s=(args.txns + 1) / total,
             queries_per_s=len(answers) / total, peak_device_bytes=peak,
             held_device_bytes=held, launches=launches, scan_launches=n_scans,
             one_island_scan_launches=one_scans,
             sharded_views=stats["sharded_views"],
             views_shared=stats["views_shared"],
             modeled_ana_seconds=result.ana_seconds,
             answers_checksum=sum(answers), ok=True)
        del session
    return kernel_launch_counts(), kernel_launch_shapes()


def phase_ana_only(args, wl) -> tuple[dict, dict]:
    """`Ana-Only` (lone queries over the initial table) on one island and on
    the first island count; returns the launches and shapes of both runs
    together."""
    from repro_torch.core import htap
    from repro_torch.kernels.common import (kernel_launch_counts,
                                            kernel_launch_shapes,
                                            reset_kernel_launch_counts)
    want = host_answers(wl["table"], wl["queries"])
    reset_kernel_launch_counts()
    seconds, probes = {}, {}
    for spec in ("hopper", f"hopper@{args.islands[0]}"):
        before = kernel_launch_counts().get("hash_probe", 0)
        t0 = time.perf_counter()
        res = htap.run("Ana-Only", wl["table"], queries=wl["queries"],
                       backend=spec)
        torch.cuda.synchronize()
        seconds[spec] = time.perf_counter() - t0
        if res.results != want:
            raise AssertionError(f"Ana-Only on {spec}: {res.results} != host "
                                 f"{want}")
        probes[spec] = kernel_launch_counts().get("hash_probe", 0) - before
        n_joins = sum(q.join_col is not None for q in wl["queries"])
        if probes[spec] != n_joins:
            raise AssertionError(f"Ana-Only on {spec}: {probes[spec]} probe "
                                 f"launches for {n_joins} lone join queries")
    launches = kernel_launch_counts()
    emit("ana_only", queries=len(want), seconds=seconds, probe_launches=probes,
         launches=launches, answers_checksum=sum(want), ok=True)
    return launches, kernel_launch_shapes()


# ---------------------------------------------------------------------------
# phase 6: every kernel against its plain version
# ---------------------------------------------------------------------------
# Each kernel has a `*_cost(shape)` -> (bytes, operations) of one launch at a
# shape its wrapper recorded (each input read once, each output written
# once; compares, adds and moves outside the tensor cores), an `edge_*`
# check, and a `measure_*` that holds and times it at one recorded shape.

def bits(x: int) -> int:
    """Steps of a binary search over x entries."""
    return max(1, math.ceil(math.log2(x + 1)))


def next_pow2(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def sort_ops(width: int) -> int:
    """Compare-exchanges (two operations each) of a bitonic sort network."""
    lg = next_pow2(width).bit_length() - 1
    return (next_pow2(width) // 2) * (lg * (lg + 1) // 2) * 2


def scan_cost(shape, join):
    n, k, q = shape[0], shape[1], shape[-1]
    nbytes = n * (4 + 4 + 1) + k * 4 + q * 8 + (3 if join else 2) * q * 8
    if join:
        nbytes += n * (4 + 1) + shape[2] * 4
    return nbytes, n * (2 * q + 2) * (2 if join else 1)


def scan_sharded_cost(shape, join):
    """(S, W, k[, kj], Q): every slot of the stacked shards is read once."""
    n_shards, width = shape[0], shape[1]
    nbytes, ops = scan_cost((n_shards * width,) + tuple(shape[2:]), join)
    lanes = 3 if join else 2
    return nbytes + (n_shards - 1) * lanes * shape[-1] * 8, ops


def probe_cost(shape):
    """(S, W, n_buckets, slots): each query read and written once, the
    table read once; a mod, a sign fix, and a compare and max per slot."""
    n_shards, width, n_buckets, slots = shape
    q = n_shards * width
    return q * 8 + n_buckets * slots * 8, q * (2 * slots + 3)


def merge_cost(shape):
    rows, wa, wb = shape
    return (2 * rows * (wa + wb) * 12,
            rows * (wa * bits(wb) + wb * bits(wa)))


def sort_cost(shape):
    rows, width = shape
    return 2 * rows * width * 4, rows * sort_ops(width)


def apply_cost(shape):
    rows, w_old, w_val = shape
    w_merge = next_pow2(w_old + w_val)
    return (rows * 4 * (w_old + w_val + w_val + w_merge),
            rows * (sort_ops(w_val) + w_old * bits(w_val)
                    + w_val * bits(w_old)))


def snapshot_cost(shape):
    n, block = shape
    return 2 * n * 4 + (n + block - 1) // block, n


def scan_inputs(gen, n, kf, ka, kj, dev, invalid=0.1):
    fcodes = torch.randint(0, kf, (n,), generator=gen, device=dev,
                           dtype=torch.int32)
    acodes = torch.randint(0, ka, (n,), generator=gen, device=dev,
                           dtype=torch.int32)
    jcodes = torch.randint(0, kj, (n,), generator=gen, device=dev,
                           dtype=torch.int32)
    fvalid = torch.rand(n, generator=gen, device=dev) >= invalid
    jvalid = torch.rand(n, generator=gen, device=dev) >= invalid
    adict = torch.sort(torch.randint(-2**31, 2**31 - 1, (ka,), generator=gen,
                                     device=dev, dtype=torch.int64)
                       ).values.to(torch.int32)
    rcount = torch.randint(0, max(n, 2), (kj,), generator=gen, device=dev,
                           dtype=torch.int32)
    return fcodes, acodes, jcodes, fvalid, jvalid, adict, rcount


def edge_scan(gen, dev) -> int:
    """Ragged tails, one row, Q over one register tile, a dictionary larger
    than L1, unaligned views."""
    from repro_torch.kernels.dict_ops import scan_exact, scan_exact_ref
    cases = 0
    for n, kf, ka, kj, nq in ((1, 3, 3, 3, 1), (1_000_003, 40, 40, 40, 5),
                              (777_777, 64, 100_000, 60_000, 19),
                              (4096, 2, 2, 2, 8), (65_537, 1000, 50_000, 9, 9)):
        f, a, j, fv, jv, ad, rc = scan_inputs(gen, n, kf, ka, kj, dev)
        lows = torch.randint(0, kf, (nq,), generator=gen, device=dev).tolist()
        bounds = [(lo, lo + 1 + (i * 7) % kf) for i, lo in enumerate(lows)]
        bounds[0] = (0, kf)                      # everything
        for off in (0, 1):                       # off=1: unaligned pointers
            args = (f[off:], a[off:], fv[off:], ad, bounds)
            must_equal(f"scan n={n} off={off}", scan_exact(*args),
                       scan_exact_ref(*args))
            jargs = args + (j[off:], jv[off:], rc)
            must_equal(f"scan+join n={n} off={off}", scan_exact(*jargs),
                       scan_exact_ref(*jargs))
            cases += 2
    return cases


def measure_scan(gen, dev, shape, join: bool) -> dict:
    from repro_torch.kernels.dict_ops import (launch_scan_exact, scan_exact,
                                              scan_exact_ref)
    n, k, nq = shape[0], shape[1], shape[-1]
    kj = shape[2] if join else 1
    f, a, j, fv, jv, ad, rc = scan_inputs(gen, n, k, k, kj, dev, invalid=0.0)
    span = max(1, 3 * k // 10)                   # each range selects ~30 %
    bounds = [((q * k) // (nq + 1), (q * k) // (nq + 1) + span)
              for q in range(nq)]
    extra = (j, jv, rc) if join else ()
    args = (f, a, fv, ad, bounds) + extra
    err = must_equal(f"scan {shape}", scan_exact(*args), scan_exact_ref(*args))
    res = torch.zeros((3 if join else 2, nq), dtype=torch.int64, device=dev)
    barr = torch.tensor(bounds, dtype=torch.int32, device=dev)
    bare = (f, a, fv.view(torch.uint8), ad, barr, res) + (
        (j, jv.view(torch.uint8), rc) if join else ())
    return dict(max_abs_err=err,
                ms=time_ms(lambda: launch_scan_exact(*bare), 50),
                wrapper_ms=time_ms(lambda: scan_exact(*args), 20),
                plain_ms=time_ms(lambda: scan_exact_ref(*args), 3),
                library_ms=None)


def stacked(flat, sizes):
    """Lay a flat tensor's rows out as shards of `sizes` (zero padded), as
    a ShardedView does."""
    from repro_torch.core.dsm import stack_rows
    bounds = np.concatenate([[0], np.cumsum(sizes)]).tolist()
    return stack_rows([flat[lo:hi] for lo, hi in zip(bounds, bounds[1:])],
                      max(sizes))


def edge_scan_sharded(gen, dev) -> int:
    """An empty shard, more shards than rows, a padded tail, a width that
    is not a multiple of 4 (no 16-byte loads), k = 0, many shards."""
    from repro_torch.kernels.dict_ops import scan_exact, scan_exact_ref
    cases = 0
    for sizes, k, nq in (((0, 40, 41), 30, 3), ((1, 1, 0, 0, 0), 3, 1),
                         ((250_001, 250_000, 250_000, 250_000), 25_000, 9),
                         ((1001, 1000), 64, 19), ((7,) * 100, 5, 2),
                         ((2_500_000,) * 4, 100_000, 1)):
        n = sum(sizes)
        f, a, j, fv, jv, ad, rc = scan_inputs(gen, max(n, 1), k, k, k, dev)
        lay = [stacked(t[:n], sizes) for t in (f, a, j, fv, jv)]
        bounds = [(0, k)] + [(i % k, i % k + 1 + i % 7) for i in range(nq - 1)]
        args = (lay[0], lay[1], lay[3], ad, bounds)
        must_equal(f"sharded scan {sizes[:4]}", scan_exact(*args),
                   scan_exact_ref(*args))
        jargs = args + (lay[2], lay[4], rc)
        must_equal(f"sharded join scan {sizes[:4]}", scan_exact(*jargs),
                   scan_exact_ref(*jargs))
        cases += 2
    # k = 0: only padded (invalid) slots, nothing is gathered
    z = torch.zeros((3, 5), dtype=torch.int32, device=dev)
    zv = torch.zeros((3, 5), dtype=torch.bool, device=dev)
    empty = torch.empty(0, dtype=torch.int32, device=dev)
    must_equal("sharded scan k=0", scan_exact(z, z, zv, empty, [(0, 1)], z,
                                              zv, empty),
               scan_exact_ref(z, z, zv, empty, [(0, 1)], z, zv, empty))
    return cases + 1


def measure_scan_sharded(gen, dev, shape, join: bool) -> dict:
    from repro_torch.kernels.dict_ops import (launch_scan_exact, scan_exact,
                                              scan_exact_ref)
    n_shards, width, k, nq = shape[0], shape[1], shape[2], shape[-1]
    kj = shape[3] if join else 1
    f, a, j, fv, jv, ad, rc = scan_inputs(gen, n_shards * width, k, k, kj,
                                          dev, invalid=0.0)
    f, a, j, fv, jv = (t.reshape(n_shards, width) for t in (f, a, j, fv, jv))
    span = max(1, 3 * k // 10)
    bounds = [((q * k) // (nq + 1), (q * k) // (nq + 1) + span)
              for q in range(nq)]
    extra = (j, jv, rc) if join else ()
    args = (f, a, fv, ad, bounds) + extra
    err = must_equal(f"sharded scan {shape}", scan_exact(*args),
                     scan_exact_ref(*args))
    res = torch.zeros((n_shards, 3 if join else 2, nq), dtype=torch.int64,
                      device=dev)
    barr = torch.tensor(bounds, dtype=torch.int32, device=dev)
    bare = (f, a, fv.view(torch.uint8), ad, barr, res) + (
        (j, jv.view(torch.uint8), rc) if join else ())
    return dict(max_abs_err=err,
                ms=time_ms(lambda: launch_scan_exact(*bare), 50),
                wrapper_ms=time_ms(lambda: scan_exact(*args), 20),
                plain_ms=time_ms(lambda: scan_exact_ref(*args), 3),
                library_ms=None)


def probe_table(gen, dev, n_keys, lo=-(1 << 24), hi=1 << 24):
    """A bucket table over `n_keys` distinct keys (negative ones too), its
    keys on the card, and their values."""
    from repro_torch.kernels.hash_probe import build_table
    keys = torch.randperm(hi - lo, generator=gen, device=dev)[:n_keys] + lo
    keys = keys.to(torch.int32)
    vals = torch.randint(0, 1 << 20, (n_keys,), generator=gen, device=dev,
                         dtype=torch.int32)
    return build_table(keys.cpu().numpy(), vals.cpu().numpy()), keys


def probe_queries(gen, keys, n):
    """n queries, half of them keys of the table, half random misses."""
    hits = keys[torch.randint(0, max(len(keys), 1), (n - n // 2,),
                              generator=gen, device=keys.device)]
    miss = torch.randint(-(1 << 24), 1 << 24, (n // 2,), generator=gen,
                         device=keys.device, dtype=torch.int32)
    return torch.cat([hits, miss])


def edge_probe(gen, dev) -> int:
    """Negative keys, the int32 extremes, a query equal to EMPTY (it hits
    the free slots: 0), misses, one key, a large table, ragged islands."""
    from repro_torch.kernels.hash_probe import (EMPTY, build_table, probe,
                                                probe_ref, probe_sharded)
    cases = 0
    for n_keys, n_q in ((1, 5), (37, 1000), (25_133, 1_000_000)):
        table, keys = probe_table(gen, dev, n_keys)
        q = probe_queries(gen, keys, n_q)
        q[:3] = torch.tensor([EMPTY, -1, 0], dtype=torch.int32, device=dev)
        kt, vt = table.on(dev)
        must_equal(f"probe {n_keys} keys", probe(table, q, default=-9),
                   probe_ref(kt, vt, q, -9))
        parts = [q[:0], q[:3], q[3:700], q[:64]]
        for g, part in zip(probe_sharded(table, parts, default=-9), parts):
            must_equal(f"sharded probe {n_keys} keys", g,
                       probe_ref(kt, vt, part, -9))
        cases += 2
    ext = np.asarray([2**31 - 1, -2**31 + 1, 5, -5], dtype=np.int32)
    table = build_table(ext, np.arange(4, dtype=np.int32) + 1)
    q = torch.tensor([2**31 - 1, -2**31 + 1, EMPTY, -5, 6], dtype=torch.int32,
                     device=dev)
    kt, vt = table.on(dev)
    got = probe(table, q)
    must_equal("probe extremes", got, probe_ref(kt, vt, q, -1))
    if got.tolist() != [1, 2, 0, 4, -1]:
        raise AssertionError(f"probe extremes: {got.tolist()}")
    return cases + 1


def measure_probe(gen, dev, shape) -> dict:
    """At the recorded (S, W, n_buckets, slots): a table of the same bucket
    count (n_buckets // 2 keys at the builder's load factor), W queries per
    island. Also the sharded form at four islands of the same width."""
    from repro_torch.kernels.hash_probe import (launch_hash_probe, probe,
                                                probe_ref, probe_sharded)
    n_shards, width, n_buckets, _ = shape
    table, keys = probe_table(gen, dev, max(1, n_buckets // 2))
    kt, vt = table.on(dev)
    q = probe_queries(gen, keys, n_shards * width).reshape(n_shards, width)
    flat = q.reshape(-1) if n_shards == 1 else q
    got = probe(table, flat) if n_shards == 1 else \
        torch.stack(probe_sharded(table, list(q)))
    err = must_equal(f"probe {shape}", got, probe_ref(kt, vt, flat, -1))
    out = torch.empty_like(flat)
    skeys = torch.sort(keys).values
    four = list(probe_queries(gen, keys, 4 * width).reshape(4, width))
    sh_err = max(must_equal(f"sharded probe {shape}", g,
                            probe_ref(kt, vt, p, -1))
                 for g, p in zip(probe_sharded(table, four), four))
    stack4 = torch.stack(four)
    out4 = torch.empty_like(stack4)
    return dict(max_abs_err=err, slots_measured=int(kt.shape[1]),
                ms=time_ms(lambda: launch_hash_probe(flat, kt, vt, -1, out),
                           200),
                wrapper_ms=time_ms(lambda: probe(table, flat.reshape(-1)),
                                   200),
                plain_ms=time_ms(lambda: probe_ref(kt, vt, flat, -1), 50),
                library_ms=time_ms(lambda: torch.searchsorted(skeys, flat),
                                   200),
                sharded=dict(
                    shape=[4, width, int(kt.shape[0]), int(kt.shape[1])],
                    max_abs_err=sh_err,
                    ms=time_ms(lambda: launch_hash_probe(stack4, kt, vt, -1,
                                                         out4), 200),
                    wrapper_ms=time_ms(lambda: probe_sharded(table, four),
                                       200),
                    plain_ms=time_ms(lambda: probe_ref(kt, vt, stack4, -1),
                                     50)))


def sorted_runs(gen, dev, rows, w, lo=-2**62, hi=2**62):
    k = torch.randint(lo, hi, (rows, w), generator=gen, device=dev,
                      dtype=torch.int64)
    return torch.sort(k, dim=1).values


def edge_merge(gen, dev) -> int:
    from repro_torch.kernels.merge_runs import (merge_pair_ref,
                                                merge_sorted_pair,
                                                merge_sorted_pairs,
                                                merge_sorted_runs)
    cases = 0
    for rows, wa, wb in ((1, 1, 1), (1, 512, 512), (3, 1000, 7), (8, 0, 33),
                         (2, 40_000, 1024)):
        a, b = sorted_runs(gen, dev, rows, wa), sorted_runs(gen, dev, rows, wb)
        if wa and wb:    # equal keys across runs, and the int64 extremes
            b[:, 0] = a[:, 0]
            a[:, -1] = 2**63 - 1
            b[:, -1] = 2**63 - 1
            a[0, 0] = -2**63
            a, b = torch.sort(a, dim=1).values, torch.sort(b, dim=1).values
        ai = torch.arange(wa, device=dev, dtype=torch.int32).repeat(rows, 1)
        bi = wa + torch.arange(wb, device=dev, dtype=torch.int32).repeat(rows, 1)
        must_equal(f"merge {rows}x({wa}+{wb})", merge_sorted_pair(a, b, ai, bi),
                   merge_pair_ref(a, b, ai, bi))
        cases += 1
    # the k-way tree over ragged runs with commit ids beyond 2^31
    host = [np.sort(np.random.default_rng(i).integers(2**31, 2**40, size=s))
            for i, s in enumerate((257, 0, 300, 255, 1))]
    keys, src = merge_sorted_runs(host, device=dev)
    cat = np.concatenate(host)
    order = np.argsort(cat, kind="stable")
    must_equal("merge tree", (keys, src),
               (torch.from_numpy(cat[order]).to(dev),
                torch.from_numpy(order.astype(np.int32)).to(dev)))
    pairs = merge_sorted_pairs([host[0], host[2]], [host[3], host[4]],
                               device=dev)
    for got, (x, y) in zip(pairs, ((host[0], host[3]), (host[2], host[4]))):
        must_equal("merge pairs", got,
                   torch.from_numpy(np.sort(np.concatenate([x, y]))).to(dev))
    return cases + 2


def measure_merge(gen, dev, shape) -> dict:
    from repro_torch.kernels.merge_runs import (launch_merge_runs,
                                                merge_pair_ref,
                                                merge_sorted_pair)
    rows, wa, wb = shape
    a = sorted_runs(gen, dev, rows, wa, 0, 2**40)
    b = sorted_runs(gen, dev, rows, wb, 0, 2**40)
    ai = torch.arange(wa, device=dev, dtype=torch.int32).repeat(rows, 1)
    bi = wa + torch.arange(wb, device=dev, dtype=torch.int32).repeat(rows, 1)
    args = (a, b, ai, bi)
    err = must_equal(f"merge {shape}", merge_sorted_pair(*args),
                     merge_pair_ref(*args))
    ok, oi = merge_sorted_pair(*args)
    return dict(max_abs_err=err,
                ms=time_ms(lambda: launch_merge_runs(a, ai, b, bi, ok, oi), 200),
                wrapper_ms=time_ms(lambda: merge_sorted_pair(*args), 200),
                plain_ms=time_ms(lambda: merge_pair_ref(*args), 50),
                library_ms=None)


def rand_i32(gen, dev, rows, w):
    return torch.randint(-2**31, 2**31 - 1, (rows, w), generator=gen,
                         device=dev, dtype=torch.int64).to(torch.int32)


def apply_stacks(gen, dev, rows, n_old, w_old, n_val, w_val):
    """Sentinel-padded (old dictionaries, update values) of a ship batch."""
    old = torch.full((rows, w_old), I32_MAX, dtype=torch.int32, device=dev)
    old[:, :n_old] = torch.sort(rand_i32(gen, dev, rows, n_old), dim=1).values
    val = torch.full((rows, w_val), I32_MAX, dtype=torch.int32, device=dev)
    val[:, :n_val] = rand_i32(gen, dev, rows, n_val)
    val[:, 0] = old[:, 0]                        # a value already present
    return old, val


def edge_bitonic(gen, dev) -> int:
    from repro_torch.kernels.bitonic_sort import (apply_pipeline_batch,
                                                  apply_pipeline_batch_ref,
                                                  sort_rows, sort_rows_ref)
    cases = 0
    for rows, w in ((1, 1), (1, 5), (8, 1024), (3, 1000), (2, 32768),
                    (2, 70_000), (1, 200_001)):  # wider than one tile
        x = rand_i32(gen, dev, rows, w)
        x[0, 0] = I32_MAX
        x[0, -1] = -2**31
        must_equal(f"sort {rows}x{w}", sort_rows(x), sort_rows_ref(x))
        cases += 1
    for rows, w in ((1, 7), (3, 1000), (2, 70_000)):   # float32, NaN last
        x = torch.randn((rows, w), generator=gen, device=dev) * 1e6
        x[:, 0], x[:, 1], x[:, 2] = float("nan"), float("inf"), -0.0
        x[:, -1] = float("-inf")
        torch.testing.assert_close(sort_rows(x), sort_rows_ref(x), rtol=0,
                                   atol=0, equal_nan=True)
        cases += 1
    for rows, n_old, w_old, n_val, w_val in (
            (1, 1, 8, 1, 8), (8, 32, 32, 100, 128), (2, 5000, 8192, 1024, 1024),
            (3, 40_000, 65536, 700, 1024),       # merge row wider than 32768
            (2, 100, 128, 40_000, 65536)):       # more values than one tile
        old, val = apply_stacks(gen, dev, rows, n_old, w_old, n_val, w_val)
        must_equal(f"apply {rows}x({w_old}+{w_val})",
                   apply_pipeline_batch(old, val),
                   apply_pipeline_batch_ref(old, val))
        cases += 1
    return cases


def measure_sort(gen, dev, shape) -> dict:
    from repro_torch.kernels.bitonic_sort import (MAX_TILE, launch_sort_tiles,
                                                  sort_rows, sort_rows_ref)
    rows, width = shape
    x = rand_i32(gen, dev, rows, width)
    err = must_equal(f"sort {shape}", sort_rows(x), sort_rows_ref(x))
    wrapper_ms = time_ms(lambda: sort_rows(x), 200)
    pad = next_pow2(width)
    if pad <= MAX_TILE:      # one tile: the wrapper makes exactly this launch
        buf = torch.empty((rows, pad), dtype=torch.int32, device=dev)
        ms = time_ms(lambda: launch_sort_tiles(x, buf, pad), 200)
    else:                    # tile sorts + merges: only the wrapper does all
        ms = wrapper_ms
    return dict(max_abs_err=err, ms=ms, wrapper_ms=wrapper_ms,
                plain_ms=time_ms(lambda: sort_rows_ref(x), 50),
                library_ms=time_ms(lambda: torch.sort(x, dim=1), 50))


def measure_apply(gen, dev, shape) -> dict:
    from repro_torch.kernels.bitonic_sort import (MAX_TILE,
                                                  apply_pipeline_batch,
                                                  apply_pipeline_batch_ref,
                                                  launch_bitonic_apply)
    rows, w_old, w_val = shape
    # buckets are powers of two above the real lengths: fill three quarters
    old, val = apply_stacks(gen, dev, rows, max(1, 3 * w_old // 4), w_old,
                            max(1, 3 * w_val // 4), w_val)
    err = must_equal(f"apply {shape}", apply_pipeline_batch(old, val),
                     apply_pipeline_batch_ref(old, val))
    wrapper_ms = time_ms(lambda: apply_pipeline_batch(old, val), 100)
    if w_val <= MAX_TILE:    # the wrapper makes exactly this launch
        svals, merged = apply_pipeline_batch(old, val)
        ms = time_ms(lambda: launch_bitonic_apply(old, val, svals, merged),
                     100)
    else:
        ms = wrapper_ms
    return dict(max_abs_err=err, ms=ms, wrapper_ms=wrapper_ms,
                plain_ms=time_ms(lambda: apply_pipeline_batch_ref(old, val),
                                 20),
                library_ms=None)


def edge_snapshot(gen, dev) -> int:
    from repro_torch.kernels.snapshot_copy import (snapshot_copy,
                                                   snapshot_copy_ref)
    cases = 0
    for n in (1, 8192, 8193, 100_000, 3 * 8192 + 5):
        nc = (n + 8191) // 8192
        src = torch.randint(0, 1000, (n + 1,), generator=gen, device=dev,
                            dtype=torch.int32)
        prev = torch.randint(0, 1000, (n + 1,), generator=gen, device=dev,
                             dtype=torch.int32)
        for dirty in (torch.zeros(nc, dtype=torch.bool, device=dev),
                      torch.ones(nc, dtype=torch.bool, device=dev),
                      torch.rand(nc, generator=gen, device=dev) < 0.5):
            for off in (0, 1):                   # off=1: unaligned pointers
                s, p = src[off:n + off], prev[off:n + off]
                must_equal(f"snapshot n={n} off={off}",
                           snapshot_copy(s, p, dirty),
                           snapshot_copy_ref(s, p, dirty))
                cases += 1
        must_equal("snapshot int32 flags",
                   snapshot_copy(src[:n], prev[:n], dirty.to(torch.int32)),
                   snapshot_copy_ref(src[:n], prev[:n], dirty))
        cases += 1
    return cases


def measure_snapshot(gen, dev, shape) -> dict:
    """Half the chunks dirty: the copy moves the same bytes whatever the
    flags say (a chunk is read from one side and written once)."""
    from repro_torch.kernels.snapshot_copy import (launch_snapshot_copy,
                                                   snapshot_copy,
                                                   snapshot_copy_ref)
    n, block = shape
    nc = (n + block - 1) // block
    src = torch.randint(0, 25_000, (n,), generator=gen, device=dev,
                        dtype=torch.int32)
    prev = torch.randint(0, 25_000, (n,), generator=gen, device=dev,
                         dtype=torch.int32)
    dirty = torch.rand(nc, generator=gen, device=dev) < 0.5
    args = (src, prev, dirty, block)
    err = must_equal(f"snapshot {shape}", snapshot_copy(*args),
                     snapshot_copy_ref(*args))
    mask = torch.repeat_interleave(dirty, block)[:n]
    res = torch.empty_like(src)
    flags = dirty.view(torch.uint8)
    return dict(
        max_abs_err=err,
        ms=time_ms(lambda: launch_snapshot_copy(src, prev, flags, res, block),
                   50),
        wrapper_ms=time_ms(lambda: snapshot_copy(*args), 20),
        plain_ms=time_ms(lambda: snapshot_copy_ref(*args), 5),
        library_ms=time_ms(lambda: torch.where(mask, src, prev), 20))


# kernel name -> (cost of one launch at a shape, measurement at a shape)
KERNELS = {
    "scan_exact": (lambda s: scan_cost(s, False),
                   lambda g, d, s: measure_scan(g, d, s, False)),
    "scan_exact_join": (lambda s: scan_cost(s, True),
                        lambda g, d, s: measure_scan(g, d, s, True)),
    "scan_exact_sharded": (
        lambda s: scan_sharded_cost(s, False),
        lambda g, d, s: measure_scan_sharded(g, d, s, False)),
    "scan_exact_join_sharded": (
        lambda s: scan_sharded_cost(s, True),
        lambda g, d, s: measure_scan_sharded(g, d, s, True)),
    "hash_probe": (probe_cost, measure_probe),
    "merge_runs": (merge_cost, measure_merge),
    "bitonic_sort": (sort_cost, measure_sort),
    "bitonic_apply": (apply_cost, measure_apply),
    "snapshot_copy": (snapshot_cost, measure_snapshot),
}


def with_bound(m: dict, shape, cost, launches: int) -> dict:
    nbytes, ops = cost(shape)
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / ALU_OPS_PER_S * 1e3
    return dict(m, shape=list(shape), launches_at_shape=launches,
                bound_ms=max(by_bytes, by_ops),
                bound_by="bytes" if by_bytes >= by_ops else "operations")


def phase_kernels(shapes: dict) -> dict:
    """`shapes`: per kernel, the launches each shape got on its path.
    Returns per kernel the measurement at the shape launched most (ties:
    the costlier), with the costliest shape's under ``largest`` where that
    is another."""
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    cases = (edge_scan(gen, dev) + edge_scan_sharded(gen, dev)
             + edge_probe(gen, dev) + edge_merge(gen, dev)
             + edge_bitonic(gen, dev) + edge_snapshot(gen, dev))
    measured = {}
    for name, (cost, measure) in KERNELS.items():
        seen = shapes[name]
        most = max(seen, key=lambda s: (seen[s], cost(s)))
        largest = max(seen, key=cost)
        measured[name] = with_bound(measure(gen, dev, most), most, cost,
                                    seen[most])
        cases += 1
        if largest != most:
            measured[name]["largest"] = with_bound(
                measure(gen, dev, largest), largest, cost, seen[largest])
            cases += 1
        if name in SHARDED_SCANS:
            # the islands runs' other island counts, at the shape each
            # launched most: an even split and an uneven one differ
            by_count = {}
            for shape, n in seen.items():
                best = by_count.get(shape[0])
                if best is None or (n, cost(shape)) > (seen[best],
                                                       cost(best)):
                    by_count[shape[0]] = shape
            measured[name]["at_islands"] = {
                str(count): with_bound(measure(gen, dev, shape), shape, cost,
                                       seen[shape])
                for count, shape in sorted(by_count.items())
                if count != most[0]}
            cases += len(by_count) - 1
    torch.cuda.synchronize()
    emit("kernels", cases=cases, tolerance=0,
         kernels=[dict(name=k, ok=True, **m) for k, m in measured.items()])
    return measured


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=10_000_000)
    ap.add_argument("--cols", type=int, default=8)
    ap.add_argument("--txns", type=int, default=400_000)
    ap.add_argument("--queries", type=int, default=32)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--islands", default="4,3",
                    type=lambda s: [int(n) for n in s.split(",")],
                    help="island counts of the islands phase, in order")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device - this script runs only on a GPU",
              file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails here if the package is missing)
    for mod in list(sys.modules):
        if mod == "jax" or mod.startswith("jax.") or mod == "repro" \
                or mod.startswith("repro."):
            raise AssertionError(f"{mod} was imported")

    card = phase_env()
    phase_build()
    wl = make_workload(args)
    runs = {}
    main_launches, main_shapes, answers, cols = phase_main_path(args, wl)
    runs["main_path"] = (main_launches, main_shapes)
    runs["islands"] = phase_islands(args, wl, main_launches, answers, cols)
    del cols
    runs["ana_only"] = phase_ana_only(args, wl)
    # every kernel's launches and shapes from the path that runs it
    launches = {k: runs[PATH_OF.get(k, "main_path")][0][k] for k in REPLACES}
    measured = phase_kernels({k: runs[PATH_OF.get(k, "main_path")][1][k]
                              for k in REPLACES})

    print(json.dumps({"kernels": [
        dict(name=k, route="cuda", source=SOURCES[k], replaces=REPLACES[k],
             launches=launches[k], **m)
        for k, m in measured.items()]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
