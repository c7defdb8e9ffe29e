#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts and is right on a GPU.

    python3 chip_smoke.py            # needs one NVIDIA Hopper card and nvcc

Drives `repro_torch` only. Phases, each printing one JSON line:

1. ``env``       versions, nvcc, the card's name and power limit.
2. ``build``     builds the CUDA sources with nvcc (seconds = set-up time),
                 with each scan kernel instance's registers, spills and
                 blocks an SM (``scan_instances``; the join lane's
                 one-predicate pass must hold 2 blocks of 512 an SM).
3. ``main_path`` one HTAP session of the full system (`Polynesia` preset,
                 ``backend="hopper"``) at 10,000,000 rows x 8 columns,
                 400,000 transactions, 32 queries, 4 rounds, plus one late
                 single write and query. Answers must equal the same run on
                 ``backend="torch"`` and an independent numpy evaluation
                 over the host row store; every kernel must have been
                 launched during the run, the merge unit exactly once for
                 each call of its wrappers that merges two or more runs
                 (ship batches' logs, dictionary merges: `MergeCalls`).
                 The wrappers record the shapes they launched at.
4. ``islands``   the same session on analytical islands stacked on the
                 card, once per count of ``--islands`` (4, then 3: four
                 split the 10M rows evenly, three leave padded slots, so
                 the stacked views are copies), one line per run: answers
                 and final columns must equal the one-island session's bit
                 for bit (and the host evaluation every round); the sharded
                 scan and sharded join scan must carry every query group,
                 one launch per group as on one island.
5. ``delta``     the same session on the delta-store update plane
                 (``delta_store=True``, compaction every
                 ``--delta-capacity`` appended entries), once per count of
                 ``--delta-islands`` (1, then 4), one line per run: answers
                 must equal the eager one-island session's (and the host
                 evaluation every round), and the final columns, each
                 decoded with its live overlay folded in, its values and
                 validity; the query groups must have gone through the
                 fused delta kernels with a non-empty correction stack (the
                 group scan and the join group scan on one island, the
                 sharded group scan and the values delta on islands), and
                 the merge unit launched once a merge asked for (ship
                 batches, dictionary merges and overlay merges).
6. ``mesh``      the same session on the mesh placement: analytical island
                 s resident on its own device, each island applying its
                 own rows there, a query group one scan launch per device
                 over a table of its islands (up to 16 a launch), the
                 devices' int64 partials added on island 0's device. With
                 one card the islands share it (``devices=[cuda:0] * 4``,
                 then ``hopper@1/mesh``; ``--mesh-islands 4,1``), one line
                 per run: answers and final columns must equal the
                 one-island session's (and the host evaluation every
                 round), every view must be adopted from the Phase-2
                 install (``views_resident`` > 0, ``sharded_views`` 0), no
                 stacked or flat scan may launch, and the mesh scans must
                 launch (the sum over devices of ceil(islands there / 16))
                 times as often as one island launches the flat scans (once
                 a query group on one card). Then the same
                 four islands on the delta store (answers equal the eager
                 session's; the values-delta launches are reported). With
                 two or more cards, ``hopper@min(4, cards)/mesh`` over
                 distinct cards with the same checks (``mesh_cards``);
                 with one, a line saying it was skipped.
7. ``ana_only``  the `Ana-Only` preset at the same size on ``"hopper"`` and
                 ``"hopper@4"`` (the first island count): lone join queries
                 go through the bucket probe, one launch a query, against a
                 table built once per joined dictionary (``tables_built``,
                 at most the distinct join columns); answers must equal the
                 host evaluation.
8. ``float_scan`` the reference's original float32 scan
                 (``scan_filter_agg(exact=False)``, as
                 ``examples/htap_analytics.py`` calls it) for every query's
                 filter and aggregate column over the main path's final
                 columns: one launch per query; counts must equal the exact
                 scan's and the plain version's, sums lie within
                 `float_scan_error_bound` of the exact int64 sums (the worst
                 case of the kernel's summation order, about 2e-6 of
                 sum(|v|) at 10M rows) and within 1e-5 * sum(|v|) of the
                 plain version's.
9. ``lm_serve``  the LM serving path at full width, one line per model of
                 ``--lm-models``: gemma2-9b (42 layers, bf16 weights from
                 `init_lm` on the card, seed ``--seed``) serves ``--lm-batch``
                 4 requests of ``--lm-prompt`` 256 prompt tokens fed one at a
                 time through `make_serve_step`, then ``--lm-gen`` 32
                 generated tokens, with a cache of 4096 slots:
                 every attention layer of every step is one flash-decode
                 launch (42 x (P + G - 1)); afterwards, untimed, the same
                 tokens go through `lm_decode_step` on a new cache: every
                 logit must be finite and each argmax the served token;
                 falcon-mamba-7b (64 layers) runs `make_prefill_step` over 4 x
                 ``--lm-prefill`` 2048 tokens twice (64 selective-scan
                 launches a call), then serves as gemma2 through the plain
                 Mamba step. Before each, a cross-check at full width, float32
                 weights and reduced depth (one period of gemma2; two layers
                 of falcon-mamba): prefill logits against token-by-token
                 decode logits at every one of 64 positions,
                 2e-3 relative plus absolute (the reference's
                 ``test_decode_matches_parallel_apply``); the prefill takes
                 the plain attention or the scan kernel, the decode the
                 decode kernel or the plain step. After each model's run,
                 4 more serve steps under `torch.profiler` give the device
                 time per step and the device's busy share.
10. ``kernels``   every hand-written kernel launched on the card and held
                 against its plain PyTorch version - the HTAP kernels with
                 exact equality (integers: tolerance 0), flash-decode
                 attention at 2e-5 and the selective scan at 3e-5 in float32
                 (a bf16 cache is compared after up-casting; flash-decode
                 with bf16 queries and output, as serving runs it, within
                 one bf16 rounding more: 2**-8 relative), the float32
                 scan as in ``float_scan`` - at edge shapes and at the
                 shapes the path just gave it (the one it launched most, and
                 the largest where that is another; for the sharded scans
                 also the one each other island count launched most, under
                 ``at_islands``; for flash-decode also the ``decode_32k``
                 cache length, S = 32768 at B = 4, with gemma2's heads under
                 ``at_decode_32k`` and kimi-k2's (H 64, Hkv 8, d 112) under
                 ``at_decode_32k_d112``, each with its splits, waves,
                 achieved GB/s and ptxas' registers; for the merge unit
                 the k-way merge at a ship batch's shape, four runs of 256,
                 under ``at_ship`` where the path launched another most,
                 and bit for bit at k in {1, 2, 3, 4, 7, 8, 70} with empty
                 and one-entry runs, ties across runs, int64.max and
                 inputs too large for shared memory; for the selective
                 scan ptxas' registers and spills of each instance, and
                 ``bound_sfu_ms`` (the
                 exponentials on the SFUs alone); for the bucket probe
                 the host's cost of one launch, item by item, under
                 ``host_us``; for the join scans and the float32 scan the
                 instances they ran, under ``instances``; the join lane
                 bit for bit at Q = 1, 2, 8, 9 and 17 over views 0 - 3
                 rows into their columns, columns at different offsets,
                 shards off 16-byte boundaries and correction stacks of 0
                 and 1 rows; the float32 scan at views 0 - 3 rows in and
                 twice a case, the two sums bit for bit one);
                 times the kernel (``ms``: back-to-back bare launches;
                 ``device_ms``: the device's own time of 20 bare launches
                 under `torch.profiler`, a launch, for small kernels well
                 below ``ms``, which is then the host's launch rate;
                 ``wrapper_ms``: through the public wrapper with its checks
                 and allocations), the plain version and, where one PyTorch
                 call computes the same function, that call; for the delta
                 groups also the same launch without the correction lane
                 (``base_ms``). The tile merge (K6, ``bitonic_merge_rows``)
                 runs only where a sort row is wider than 32,768 keys: it is
                 reported with its launches on every path
                 (``launches_by_path``, 0 where none) and measured at the
                 shape a path gave it, else at (2, 32768, 32768), with
                 ``torch.sort`` of the concatenated runs beside it.

Each kernel is checked against the path that runs it (counts set to 0 just
before the path, read just after): the one-island kernels against
``main_path``, the sharded scans against ``islands``, the delta kernels
against ``delta``, the mesh scans against ``mesh`` (counted under
``scan_exact_mesh`` and ``scan_exact_join_mesh`` a launch, at (islands in
the launch, widest island, ...), measured with the islands on one card),
the bucket
probe against ``ana_only``, the float32 scan
against ``float_scan``, flash-decode attention and the selective scan
against ``lm_serve`` (each model's serve run). The raw-value
scan has no caller on these paths (nor in the reference's kernel backend):
it is the values delta's kernel over a 3-row stack and is held and timed
beside it, under ``raw_value_scan``. Then the ``{"kernels": [...]}``
summary, the card's name and power limit, and as the last line ``{"ok":
true, "device": {...}}``. Any failed phase raises: the script exits
non-zero and prints no result. Without CUDA it exits with code 2 before
doing anything.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
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
    "bitonic_merge_rows": "src/repro/kernels/bitonic_sort/bitonic_sort.py:123",
    "bitonic_apply": "src/repro/kernels/dict_ops/ops.py:310 "
                     "(bitonic_sort.py:103 + bitonic_sort.py:123)",
    "snapshot_copy": "src/repro/kernels/snapshot_copy/snapshot_copy.py:54",
    "scan_exact_group": "src/repro/kernels/dict_ops/ops.py:372 "
                        "(dict_ops.py:63 + 2 x dict_ops.py:176)",
    "scan_exact_group_sharded": "src/repro/kernels/dict_ops/ops.py:414 "
                                "(dict_ops.py:121 + 2 x dict_ops.py:176)",
    "scan_exact_join_group": "src/repro/kernels/hash_probe/ops.py:383 "
                             "(2 x dict_ops.py:63 + 4 x dict_ops.py:176)",
    "scan_values_delta": "src/repro/kernels/dict_ops/ops.py:453 "
                         "(2 x dict_ops.py:176; the raw-value scan "
                         "dict_ops.py:176 alone is raw_value_scan)",
    "scan_exact_mesh": "src/repro/kernels/dict_ops/ops.py:539 "
                       "(_mesh_scan_call; dict_ops.py:121 per island)",
    "scan_exact_join_mesh": "src/repro/kernels/hash_probe/ops.py:431 "
                            "(_mesh_join_call; 2 x dict_ops.py:121 per "
                            "island)",
    "scan_float": "src/repro/kernels/dict_ops/dict_ops.py:218",
    "decode_attn": "src/repro/kernels/decode_attn/decode_attn.py:74",
    "selective_scan": "src/repro/kernels/selective_scan/selective_scan.py:59",
}
SOURCES = {
    "scan_exact": "src/repro_torch/kernels/csrc/scan_exact.cu",
    "scan_exact_join": "src/repro_torch/kernels/csrc/scan_exact.cu",
    "scan_exact_sharded": "src/repro_torch/kernels/csrc/scan_exact.cu",
    "scan_exact_join_sharded": "src/repro_torch/kernels/csrc/scan_exact.cu",
    "hash_probe": "src/repro_torch/kernels/csrc/hash_probe.cu",
    "merge_runs": "src/repro_torch/kernels/csrc/merge_runs.cu",
    "bitonic_sort": "src/repro_torch/kernels/csrc/bitonic.cu",
    "bitonic_merge_rows": "src/repro_torch/kernels/csrc/bitonic.cu",
    "bitonic_apply": "src/repro_torch/kernels/csrc/bitonic.cu",
    "snapshot_copy": "src/repro_torch/kernels/csrc/snapshot_copy.cu",
    "scan_exact_group": "src/repro_torch/kernels/csrc/scan_exact.cu",
    "scan_exact_group_sharded": "src/repro_torch/kernels/csrc/scan_exact.cu",
    "scan_exact_join_group": "src/repro_torch/kernels/csrc/scan_exact.cu",
    "scan_values_delta": "src/repro_torch/kernels/csrc/scan_exact.cu",
    "scan_exact_mesh": "src/repro_torch/kernels/csrc/scan_exact.cu",
    "scan_exact_join_mesh": "src/repro_torch/kernels/csrc/scan_exact.cu",
    "scan_float": "src/repro_torch/kernels/csrc/scan_float.cu",
    "decode_attn": "src/repro_torch/kernels/csrc/decode_attn.cu",
    "selective_scan": "src/repro_torch/kernels/csrc/selective_scan.cu",
}
# the path that runs each kernel: its launches are counted on that path
PATH_OF = {"scan_exact_sharded": "islands",
           "scan_exact_join_sharded": "islands", "hash_probe": "ana_only",
           "scan_exact_group": "delta", "scan_exact_group_sharded": "delta",
           "scan_exact_join_group": "delta", "scan_values_delta": "delta",
           "scan_exact_mesh": "mesh", "scan_exact_join_mesh": "mesh",
           "scan_float": "float_scan", "decode_attn": "lm_serve",
           "selective_scan": "lm_serve"}
# kernels a path launches only for some data: the tile merge (K6) sorts a
# row wider than one tile's 32,768 keys, which the paths may not have. Each
# is reported with its launches on every path, measured at the shape a path
# launched most or, where none did, at NO_CALLER_SHAPE, and is not required
# to have launched.
NO_CALLER_SHAPE = {"bitonic_merge_rows": (2, 32768, 32768)}
I32_MIN, I32_MAX = -2**31, 2**31 - 1


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def time_ms(fn, reps: int) -> float:
    """Mean milliseconds of `fn` on the card over `reps` launches (CUDA
    events around the whole run, after min(reps, 10) warm-up calls: after
    one, a long kernel's first timed launches still ran slower)."""
    for _ in range(min(reps, 10)):
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


DEVICE_REPS = 20


def device_time(fn, reps: int = DEVICE_REPS) -> dict:
    """`fn`'s device time under `torch.profiler`, a call (``device_ms``):
    for each CUDA kernel (or copy) its `reps` calls ran, its mean own time
    times the launches of it a call (its count over `reps`, rounded: the
    profiler has been seen to drop an event of 20), summed; and the
    kernels a call (``device_kernels``). The profiler has been seen to
    record no device time at all in one window of many (K17, K18), so an
    empty window is profiled once more; where the second records nothing
    either, the CUDA-event time of the same calls stands in, and
    ``device_ms_source`` says so."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if str(e.device_type).endswith("CUDA")
                   and e.self_device_time_total > 0]
        if kernels:
            break
    if not kernels:
        return dict(device_ms=time_ms(fn, reps), device_kernels=None,
                    device_ms_source="cuda events (the profiler recorded "
                                     "no device time)")
    a_call = [max(1, round(e.count / reps)) for e in kernels]
    return dict(device_ms=sum(e.self_device_time_total / e.count * n
                              for e, n in zip(kernels, a_call)) / 1e3,
                device_kernels=sum(a_call),
                device_events=sum(e.count for e in kernels),
                device_ms_source="torch.profiler")


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


def must_be_close(name: str, got, want, tol: float) -> float:
    """Largest absolute difference of two float tensors (after up-casting
    to float32); raises above `tol` relative plus absolute."""
    got, want = got.float(), want.float()
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    err = float((got - want).abs().max()) if got.numel() else 0.0
    if not torch.allclose(got, want, rtol=tol, atol=tol):
        raise AssertionError(f"kernel check {name!r}: differs from its plain "
                             f"version (max abs err {err}, tolerance {tol} "
                             "relative plus absolute)")
    return err


# A bf16 output against the plain version's float32 answer on the same
# (bf16-valued) inputs: 2e-5 relative plus absolute for the float32 work,
# then one round-to-nearest to bf16, at most 2**-8 of the value.
BF16_OUT_ATOL = 2e-5 * (1 + 2**-8)
BF16_OUT_RTOL = 2**-8 + BF16_OUT_ATOL


def must_be_close_bf16(name: str, got, want) -> float:
    """`got` bf16, `want` float32; raises outside BF16_OUT_RTOL relative
    plus BF16_OUT_ATOL absolute; returns the largest absolute difference."""
    if got.dtype != torch.bfloat16:
        raise AssertionError(f"{name}: output {got.dtype}, not bfloat16")
    got = got.float()
    err = float((got - want).abs().max()) if got.numel() else 0.0
    if got.shape != want.shape or not torch.allclose(
            got, want, rtol=BF16_OUT_RTOL, atol=BF16_OUT_ATOL):
        raise AssertionError(f"kernel check {name!r}: bf16 output differs "
                             f"from its plain version (max abs err {err}, "
                             f"tolerance {BF16_OUT_RTOL} relative plus "
                             f"{BF16_OUT_ATOL})")
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
        elif "spill stores" in line and entry:
            SPILLS[entry] = sum(int(w) for w in re.findall(
                r"(\d+) bytes spill", line))
        elif "registers" in line and entry:
            registers[entry] = int(line.split("Used ")[1].split()[0])
    REGISTERS.update(registers)
    instances = scan_instances()
    narrow = join_instances(1)
    if any(v["blocks_per_sm"] < 2 for v in narrow.values()):
        raise AssertionError(f"the join lane's one-predicate pass holds "
                             f"fewer than 2 blocks of 512 an SM: {narrow}")
    emit("build", seconds=round(time.perf_counter() - t0, 3),
         nvcc_seconds=nvcc_seconds,
         sources=sorted(p.name for p in build.CSRC.glob("*.cu")),
         library=str(build.build_library().name), registers=registers,
         scan_instances=instances)


REGISTERS: dict[str, int] = {}     # ptxas' count per kernel entry (build)
SPILLS: dict[str, int] = {}        # ptxas' spill stores + loads, bytes


def scan_key(join, vec, corr, qn) -> str:
    return (f"scan_exact<{'join' if join else 'scan'},"
            f"{'vec' if vec else 'rows'},{'corr' if corr else 'base'},"
            f"qn={qn}>")


def island_key(join, qn) -> str:
    return f"scan_islands<{'join' if join else 'scan'},qn={qn}>"


def float_key(vec) -> str:
    return f"scan_float<{'vec' if vec else 'rows'}>"


def instance_key(entry: str) -> str | None:
    """The scan kernel instance a ptxas entry name is, if it is one."""
    for pat, key in (
            (r"scan_exact_kernelILb([01])ELb([01])ELb([01])ELi(\d+)EE",
             scan_key),
            (r"scan_islands_kernelILb([01])ELi(\d+)EE", island_key),
            (r"scan_float_kernelILb([01])EE", float_key)):
        m = re.search(pat, entry)
        if m:
            return key(*(int(x) for x in m.groups()))
    return None


def scan_instances() -> dict[str, dict]:
    """Per instance of the exact scan's kernel (join lane or not, 16-byte
    loads or rows, correction slice or base, predicates a pass), of the
    island kernel and of the float scan: the occupancy API's blocks an SM
    (512 threads a block for the scans, 256 for the float scan; not asked
    for the island kernel) and, when this process built the library,
    ptxas' registers and spill bytes."""
    import ctypes
    from repro_torch.kernels import build
    ptxas = {instance_key(e): dict(registers=n, spill_bytes=SPILLS.get(e, 0))
             for e, n in REGISTERS.items()}

    def occupancy(name, *args):
        blocks = ctypes.c_int(0)
        build.check(build.entry(name)(*args, ctypes.byref(blocks)), name)
        return blocks.value
    out = {}
    for j, q in ((0, 8), (1, 1), (1, 8)):
        for v in (0, 1):
            for c in (0, 1):
                key = scan_key(j, v, c, q)
                out[key] = dict(ptxas.get(key, {}), blocks_per_sm=occupancy(
                    "scan_exact_occupancy", j, v, c, q))
        out[island_key(j, q)] = dict(ptxas.get(island_key(j, q), {}),
                                     blocks_per_sm=None)
    for v in (0, 1):
        out[float_key(v)] = dict(ptxas.get(float_key(v), {}),
                                 blocks_per_sm=occupancy(
                                     "scan_float_occupancy", v))
    return out


def join_qn(nq: int) -> int:
    """Predicates a pass of the join lane for a Q-predicate group (the
    host's choice in scan_exact.cu)."""
    return 1 if nq == 1 else 8


def join_instances(nq: int) -> dict[str, dict]:
    """The join lane's instances a Q-predicate group runs (by 16-byte
    loads and correction slice)."""
    every = scan_instances()
    keys = [scan_key(1, v, c, join_qn(nq)) for v in (0, 1) for c in (0, 1)]
    return {k: every[k] for k in keys}


def decode_registers() -> dict[str, int]:
    """ptxas' registers of each instance of the flash-decode split pass:
    the float32-cache pass by G bucket, the bf16-cache (mma) pass by query
    type."""
    out = {}
    for entry, n in REGISTERS.items():
        m = re.search(r"decode_attn_(simt|mma)ILi(\d+)E", entry)
        if m and m.group(1) == "simt":
            out[f"float32 cache, G<={m.group(2)}"] = n
        elif m:
            q = "bf16" if m.group(2) == "1" else "float32"
            out[f"bf16 cache, {q} q"] = n
    return out


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
          check_host: bool, devices=None):
    """One session through the public entry points: n_rounds of
    execute + query_batch, then one late single write and one query.
    Returns (answers, seconds per round, session, RunResult)."""
    from repro_torch.core.session import HTAPSession
    from repro_torch.core.workload import split_queries, split_stream
    session = HTAPSession(spec, table, devices=devices)
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


def drive_spec(spec, wl, args, check_host: bool, devices=None):
    return drive(spec, wl["table"], wl["stream"], wl["late"], wl["queries"],
                 wl["late_query"], args.rounds, check_host, devices)


def same_columns(got: dict, want: dict, what: str) -> None:
    for c, col in got.items():
        ref = want[c]
        if not (torch.equal(col.codes, ref.codes)
                and torch.equal(col.valid, ref.valid)
                and torch.equal(col.dictionary, ref.dictionary)
                and col.version == ref.version):
            raise AssertionError(f"final column {c} differs: {what}")


class MergeCalls:
    """Counts the calls of the merge unit's wrappers (K5) where
    `core.backend` and `core.application` import them, each call that
    merges entries of two or more runs: `merge_sorted_runs` (ship batches'
    logs, dictionary merges, the delta plane's overlay merges) and
    `merge_sorted_pairs` (a batch of dictionary merges). The unit launches
    once for each."""

    SITES = (("backend", "merge_sorted_runs"),
             ("backend", "merge_sorted_pairs"),
             ("application", "merge_sorted_runs"))

    def __enter__(self):
        from repro_torch.core import application, backend
        modules = dict(backend=backend, application=application)
        self.counts, self._saved = {}, []
        for m, name in self.SITES:
            module, fn = modules[m], getattr(modules[m], name)
            self.counts[f"{m}.{name}"] = 0
            self._saved.append((module, name, fn))
            setattr(module, name, self._counted(f"{m}.{name}", fn))
        return self

    def _counted(self, key, fn):
        # merge_sorted_runs(runs, ...) / merge_sorted_pairs(a_list, b_list)
        n_lists = 2 if key.endswith("pairs") else 1

        def inner(*args, **kwargs):
            lists = args[:n_lists]
            n_runs = sum(len(runs) for runs in lists)
            n = sum(len(r) for runs in lists for r in runs)
            self.counts[key] += n_runs >= 2 and n > 0
            return fn(*args, **kwargs)
        return inner

    def __exit__(self, *exc):
        for module, name, fn in self._saved:
            setattr(module, name, fn)

    def check(self, launches: dict, what: str) -> dict:
        """K5's launches must be one a merge call."""
        want = sum(self.counts.values())
        if launches.get("merge_runs", 0) != want:
            raise AssertionError(
                f"{what}: {launches.get('merge_runs', 0)} merge-unit launches"
                f", expected one a merge call: {self.counts}")
        return dict(self.counts, merge_runs=want)


def phase_main_path(args, wl) -> tuple[dict, dict, list, dict, list]:
    """Returns the launches per kernel and, per kernel, the launches each
    shape got, both of the `hopper` session alone, and that session's
    answers, final columns and round seconds."""
    from repro_torch.core.session import SystemSpec
    from repro_torch.kernels.common import (kernel_launch_counts,
                                            kernel_launch_shapes,
                                            reset_kernel_launch_counts)
    torch.cuda.reset_peak_memory_stats()
    reset_kernel_launch_counts()
    with MergeCalls() as merges:
        answers, seconds, session, result = drive_spec(
            SystemSpec.polynesia(backend="hopper"), wl, args,
            check_host=True)
    launches = kernel_launch_counts()
    shapes = kernel_launch_shapes()
    peak = torch.cuda.max_memory_allocated()
    merge_unit = merges.check(result.stats["kernel_launches"], "main_path")

    if len(answers) != args.queries + 1:
        raise AssertionError("wrong number of answers")
    cols = session.replica.columns
    for c, col in cols.items():
        for t in (col.codes, col.valid, col.dictionary):
            if t.device.type != "cuda":
                raise AssertionError(f"column {c} has a tensor on {t.device}")
    missing = [k for k in REPLACES if k not in PATH_OF
               and k not in NO_CALLER_SHAPE and launches.get(k, 0) < 1]
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
         ship_batches=session._ship_i, merge_unit=merge_unit,
         applications=session.applications,
         snapshots=session.cons.snapshots_created, launches=launches,
         distinct_launch_shapes={k: len(v) for k, v in shapes.items()},
         max_dictionary=max(c.dict_size for c in cols.values()),
         peak_device_bytes=peak, modeled_txn_seconds=result.txn_seconds,
         modeled_ana_seconds=result.ana_seconds,
         answers_checksum=sum(answers), ok=True)
    return launches, shapes, answers, cols, seconds


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


# rows of the correction stack(s) of a delta kernel's launch, from the shape
# its wrapper recorded
STACK_ROWS = {"scan_exact_group": lambda s: s[-1],
              "scan_exact_group_sharded": lambda s: s[-1],
              "scan_exact_join_group": lambda s: s[-2] + s[-1],
              "scan_values_delta": lambda s: s[0]}
# the delta kernels that must carry query groups with a non-empty stack:
# on one island, and on several
DELTA_ONE = ("scan_exact_group", "scan_exact_join_group")
DELTA_ISLANDS = ("scan_exact_group_sharded", "scan_values_delta")


def folded_columns(session) -> dict:
    """Each final column decoded, with its live overlay folded in:
    {col: (values, valid)} on the card."""
    out = {}
    for c, col in session.replica.columns.items():
        vals = col.dictionary[col.codes.long()].clone()
        valid = col.valid.clone()
        d = session._deltas.get(c)
        if d is not None and d.n_overlay:
            rows, dvals, dvalid = d.on(col.device)
            vals[rows] = dvals.to(vals.dtype)
            valid[rows] = dvalid
        out[c] = (vals, valid)
    return out


def phase_delta(args, wl, one_answers, one_cols, one_seconds
                ) -> tuple[dict, dict]:
    """The main path on the delta-store plane, once per count of
    `args.delta_islands`; returns the launches and launch shapes of all its
    runs."""
    from repro_torch.core.session import SystemSpec
    from repro_torch.kernels.common import (kernel_launch_counts,
                                            kernel_launch_shapes,
                                            reset_kernel_launch_counts)
    want = {c: (col.dictionary[col.codes.long()], col.valid)
            for c, col in one_cols.items()}
    reset_kernel_launch_counts()
    for n in args.delta_islands:
        before, shapes_before = kernel_launch_counts(), kernel_launch_shapes()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        with MergeCalls() as merges:
            answers, seconds, session, result = drive_spec(
                SystemSpec.polynesia(backend="hopper", n_shards=n,
                                     delta_store=True,
                                     delta_capacity=args.delta_capacity),
                wl, args, check_host=True)
        after, shapes_after = kernel_launch_counts(), kernel_launch_shapes()
        launches = {k: v - before.get(k, 0) for k, v in after.items()
                    if v != before.get(k, 0)}
        peak = torch.cuda.max_memory_allocated()
        merge_unit = merges.check(result.stats["kernel_launches"],
                                  f"delta on {n} island(s)")

        if answers != one_answers:
            raise AssertionError(f"delta plane on {n} island(s): answers "
                                 f"{answers} != eager answers {one_answers}")
        for c, (vals, valid) in folded_columns(session).items():
            if not (torch.equal(vals, want[c][0])
                    and torch.equal(valid, want[c][1])):
                raise AssertionError(f"delta plane on {n} island(s): final "
                                     f"column {c} with its overlay folded "
                                     "differs from the eager column")
        stack_rows = {}
        for k, rows_of in STACK_ROWS.items():
            run = {s: m - shapes_before.get(k, {}).get(s, 0)
                   for s, m in shapes_after.get(k, {}).items()}
            stack_rows[k] = sum(rows_of(s) * m for s, m in run.items())
        need = DELTA_ONE if n == 1 else DELTA_ISLANDS
        missing = [k for k in need if stack_rows[k] < 1]
        if missing:
            raise AssertionError(f"delta plane on {n} island(s): no query "
                                 f"group went through {missing} with a "
                                 f"non-empty stack (launches {launches})")
        stats = result.stats
        total = sum(seconds)
        emit("delta", islands=n, capacity=session.delta_capacity,
             round_seconds=seconds, eager_round_seconds=one_seconds,
             txns_per_s=(args.txns + 1) / total,
             queries_per_s=len(answers) / total,
             delta_appends=stats["delta_appends"],
             compactions=stats["compactions"],
             delta_live_entries=stats["delta_live_entries"],
             applications=stats["applications"],
             ship_batches=session._ship_i, merge_unit=merge_unit,
             peak_device_bytes=peak, held_device_bytes=held,
             launches=launches, stack_rows_scanned=stack_rows,
             modeled_txn_seconds=result.txn_seconds,
             modeled_ana_seconds=result.ana_seconds,
             answers_checksum=sum(answers), ok=True)
        del session
    return kernel_launch_counts(), kernel_launch_shapes()


# the mesh scans, one launch per device and group of up to 16 islands, and
# the flat scans whose launches one island makes for the same query groups
MESH_SCANS = {"scan_exact_mesh": "scan_exact",
              "scan_exact_join_mesh": "scan_exact_join"}


def mesh_launches_a_group(devices) -> int:
    """The mesh scans' launches for one query group: one per device and
    group of up to MAX_ISLANDS of its islands (every island of these runs
    holds rows)."""
    from repro_torch.kernels.dict_ops import MAX_ISLANDS
    per_device = {}
    for d in devices:
        per_device[d] = per_device.get(d, 0) + 1
    return sum(-(-n // MAX_ISLANDS) for n in per_device.values())


def mesh_run(args, wl, spec, devices, one_launches, one_answers, one_cols,
             what: str) -> None:
    """One eager session on the mesh placement, checked against the
    one-island session."""
    from repro_torch.kernels.common import kernel_launch_counts
    before = kernel_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    answers, seconds, session, result = drive_spec(spec, wl, args,
                                                   check_host=True,
                                                   devices=devices)
    launches = {k: v - before.get(k, 0)
                for k, v in kernel_launch_counts().items()
                if v != before.get(k, 0)}
    peak = torch.cuda.max_memory_allocated()
    n = session.islands
    if answers != one_answers:
        raise AssertionError(f"{what}: answers {answers} != one-island "
                             f"answers {one_answers}")
    same_columns(session.replica.columns, one_cols, f"{what} vs one island")
    stats = result.stats
    if (stats["placement"] != "mesh" or stats["views_resident"] < 1
            or stats["sharded_views"] != 0 or stats["islands"] != n):
        raise AssertionError(f"{what}: not the mesh's resident views: "
                             f"{stats}")
    sharded = [k for k in launches if k.endswith("_sharded")]
    if sharded:
        raise AssertionError(f"{what}: stacked scans launched: {sharded}")
    per_group = mesh_launches_a_group(session.be.devices)
    for mesh, flat in MESH_SCANS.items():
        if launches.get(flat, 0):
            raise AssertionError(f"{what}: {launches[flat]} flat {flat} "
                                 "launches on the mesh path")
        if launches.get(mesh, 0) != per_group * one_launches.get(flat, 0):
            raise AssertionError(
                f"{what}: {launches.get(mesh, 0)} {mesh} launches, "
                f"{per_group} a group x the one-island "
                f"{one_launches.get(flat, 0)} expected")
    total = sum(seconds)
    emit("mesh", run=what, islands=n,
         devices=[str(d) for d in session.be.devices],
         round_seconds=seconds, txns_per_s=(args.txns + 1) / total,
         queries_per_s=len(answers) / total, peak_device_bytes=peak,
         held_device_bytes=held, launches=launches,
         scan_launches={k: launches.get(k, 0) for k in MESH_SCANS},
         launches_a_group=per_group,
         one_island_scan_launches={k: one_launches.get(k, 0) for k in SCANS},
         views_resident=stats["views_resident"],
         views_shared=stats["views_shared"],
         modeled_ana_seconds=result.ana_seconds,
         answers_checksum=sum(answers), ok=True)
    del session


def phase_mesh(args, wl, one_launches, one_answers, one_cols, dev=None
               ) -> tuple[dict, dict]:
    """The main path on the mesh placement: each island count of
    `args.mesh_islands` with the islands on the one card (`dev`, default
    cuda:0), the first on the delta store, and over distinct cards when
    there are two or more. Returns the phase's launches and launch
    shapes."""
    from repro_torch.core.session import SystemSpec
    from repro_torch.kernels.common import (kernel_launch_counts,
                                            kernel_launch_shapes,
                                            reset_kernel_launch_counts)
    card0 = torch.device("cuda", 0) if dev is None else dev
    reset_kernel_launch_counts()
    for n in args.mesh_islands:
        mesh_run(args, wl, SystemSpec.polynesia(backend=f"hopper@{n}/mesh"),
                 [card0] * n, one_launches, one_answers, one_cols,
                 f"hopper@{n}/mesh on one card")

    # the delta store on the first island count, islands on the one card
    n = args.mesh_islands[0]
    want = {c: (col.dictionary[col.codes.long()], col.valid)
            for c, col in one_cols.items()}
    before = kernel_launch_counts()
    answers, seconds, session, result = drive_spec(
        SystemSpec.polynesia(backend=f"hopper@{n}/mesh", delta_store=True,
                             delta_capacity=args.delta_capacity),
        wl, args, check_host=True, devices=[card0] * n)
    launches = {k: v - before.get(k, 0)
                for k, v in kernel_launch_counts().items()
                if v != before.get(k, 0)}
    if answers != one_answers:
        raise AssertionError(f"delta plane on hopper@{n}/mesh: answers "
                             f"{answers} != eager answers {one_answers}")
    for c, (vals, valid) in folded_columns(session).items():
        if not (torch.equal(vals, want[c][0])
                and torch.equal(valid, want[c][1])):
            raise AssertionError(f"delta plane on hopper@{n}/mesh: final "
                                 f"column {c} with its overlay folded "
                                 "differs from the eager column")
    if result.stats["placement"] != "mesh" or any(
            k.endswith("_sharded") or k in SCANS for k in launches):
        raise AssertionError(f"delta plane on hopper@{n}/mesh did not stay "
                             f"on the mesh: {launches}")
    total = sum(seconds)
    emit("mesh", run=f"hopper@{n}/mesh delta store on one card", islands=n,
         capacity=session.delta_capacity, round_seconds=seconds,
         txns_per_s=(args.txns + 1) / total,
         queries_per_s=len(answers) / total,
         delta_appends=result.stats["delta_appends"],
         compactions=result.stats["compactions"],
         values_delta_launches=launches.get("scan_values_delta", 0),
         launches=launches, answers_checksum=sum(answers), ok=True)
    del session

    cards = torch.cuda.device_count()
    if cards >= 2:
        n = min(4, cards)
        mesh_run(args, wl, SystemSpec.polynesia(backend=f"hopper@{n}/mesh"),
                 None, one_launches, one_answers, one_cols,
                 f"hopper@{n}/mesh on {n} cards")
    else:
        emit("mesh_cards", skipped="1 card visible")
    return kernel_launch_counts(), kernel_launch_shapes()


def phase_ana_only(args, wl) -> tuple[dict, dict]:
    """`Ana-Only` (lone queries over the initial table) on one island and on
    the first island count; returns the launches and shapes of both runs
    together."""
    from repro_torch.core import htap
    from repro_torch.kernels.common import (kernel_launch_counts,
                                            kernel_launch_shapes,
                                            reset_kernel_launch_counts)
    from repro_torch.kernels.hash_probe import tables_built
    want = host_answers(wl["table"], wl["queries"])
    joined = {q.join_col for q in wl["queries"] if q.join_col is not None}
    reset_kernel_launch_counts()
    seconds, probes, tables = {}, {}, {}
    for spec in ("hopper", f"hopper@{args.islands[0]}"):
        before = kernel_launch_counts().get("hash_probe", 0)
        built = tables_built()
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
        tables[spec] = tables_built() - built
        if tables[spec] > len(joined):
            raise AssertionError(f"Ana-Only on {spec}: {tables[spec]} bucket "
                                 f"tables built for {len(joined)} joined "
                                 "dictionaries")
    launches = kernel_launch_counts()
    emit("ana_only", queries=len(want), seconds=seconds, probe_launches=probes,
         tables_built=tables, joined_columns=len(joined), launches=launches,
         answers_checksum=sum(want), ok=True)
    return launches, kernel_launch_shapes()


# ---------------------------------------------------------------------------
# phase 7: the float32 scan over the main path's columns
# ---------------------------------------------------------------------------

FLOAT_SCAN_PLAIN_RTOL = 1e-5   # of sum(|v|): the CPU tests' tolerance
FLOAT_SCAN_TOL = ("count exact; sum within float_scan_error_bound of the "
                  "exact sum and 1e-5 * sum(|v|) of the plain version's")


def float_scan_check(name, got, plain, exact, abs_sum, n, dev) -> float:
    """The kernel's (sum, count) `got` against the exact scan's `exact`:
    count equal, sum within `float_scan_error_bound` (the worst case of the
    kernel's own summation order, about 2e-6 * sum(|v|) at 10M rows); and
    against the plain version's `plain`: count equal, sums within
    FLOAT_SCAN_PLAIN_RTOL * sum(|v|). Returns the error against the exact
    sum relative to sum(|v|)."""
    from repro_torch.kernels.dict_ops.ops import (float_scan_error_bound,
                                                  float_scan_parts)
    (s, c), (ps, pc), (es, ec) = got, plain, exact
    err = abs(float(s) - es)
    bound = float_scan_error_bound(n, float_scan_parts(dev, n), abs_sum)
    if int(c) != ec or err > bound:
        raise AssertionError(
            f"{name}: float32 scan ({float(s)}, {int(c)}) against exact "
            f"({es}, {ec}): error {err} over its bound {bound} (sum(|v|) "
            f"{abs_sum}, n {n})")
    if int(pc) != ec or abs(float(s) - float(ps)) > \
            FLOAT_SCAN_PLAIN_RTOL * abs_sum:
        raise AssertionError(
            f"{name}: float32 scan ({float(s)}, {int(c)}) against its plain "
            f"version ({float(ps)}, {int(pc)}), tolerance "
            f"{FLOAT_SCAN_PLAIN_RTOL} * sum(|v|) {abs_sum}")
    return err / abs_sum if abs_sum else 0.0


def abs_sum(fcodes, acodes, valid, adict, lo, hi) -> int:
    """sum(|dict[acodes]|) over the rows a predicate selects (int64)."""
    mask = (fcodes >= lo) & (fcodes < hi) & valid
    return int(torch.where(mask, adict[acodes.long()].long().abs(), 0).sum())


def phase_float_scan(args, wl, cols) -> tuple[dict, dict]:
    """Every query's filter and aggregate columns through the float32 scan
    over the main path's final columns (one launch a query), then the same
    predicates through the exact scan to hold it against."""
    from repro_torch.core.backend import get_backend
    from repro_torch.kernels.common import (kernel_launch_counts,
                                            kernel_launch_shapes,
                                            reset_kernel_launch_counts)
    from repro_torch.kernels.dict_ops import (scan_filter_agg,
                                              scan_filter_agg_float_ref)
    be = get_backend("hopper")
    queries = list(wl["queries"]) + [wl["late_query"]]
    preds = []
    for q in queries:
        fcol, acol = cols[q.filter_col], cols[q.agg_col]
        preds.append((fcol, acol) + be.code_range(fcol, q.lo, q.hi))
    reset_kernel_launch_counts()
    t0 = time.perf_counter()
    got = [scan_filter_agg(f.codes, a.codes, f.valid, a.dictionary, lo, hi,
                           exact=False) for f, a, lo, hi in preds]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches, shapes = kernel_launch_counts(), kernel_launch_shapes()
    if launches != {"scan_float": len(queries)}:
        raise AssertionError(f"float scan launches {launches} for "
                             f"{len(queries)} queries")
    rel = []
    for (f, a, lo, hi), s_c in zip(preds, got):
        cols_pred = (f.codes, a.codes, f.valid, a.dictionary, lo, hi)
        rel.append(float_scan_check(
            "float_scan", s_c, scan_filter_agg_float_ref(*cols_pred),
            scan_filter_agg(*cols_pred), abs_sum(*cols_pred), f.n_rows,
            f.codes.device))
    emit("float_scan", queries=len(queries), seconds=seconds,
         launches=launches, max_rel_err=max(rel), tolerance=FLOAT_SCAN_TOL,
         ok=True)
    return launches, shapes


# ---------------------------------------------------------------------------
# phase 8: the LM serving path
# ---------------------------------------------------------------------------

def serve(model, cfg, prompts, n_gen: int, max_len: int):
    """Greedy serving as `examples/serve_lm.py`: the prompt fed one token
    at a time through `make_serve_step`, then the generated tokens fed
    back. Returns (generated (B, n_gen), prompt seconds, generation
    seconds, cache)."""
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models.lm import init_lm_cache
    dev = prompts.device
    batch, n_prompt = prompts.shape
    cache = init_lm_cache(cfg, batch, max_len, dtype=cfg.adtype, device=dev)
    step = make_serve_step(cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n_prompt):
        tok, cache = step(model, cache, prompts[:, i:i + 1], i)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out = [tok]
    for i in range(n_prompt, n_prompt + n_gen - 1):
        tok, cache = step(model, cache, tok, i)
        out.append(tok)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    gen = torch.cat(out, dim=1)
    if gen.shape != (batch, n_gen) or int(gen.min()) < 0 \
            or int(gen.max()) >= cfg.vocab_size:
        raise AssertionError(f"{cfg.name}: bad generated tokens {gen.shape}")
    return gen, t1 - t0, t2 - t1, cache


def replay(model, cfg, prompts, gen, max_len: int) -> int:
    """After the timed run, untimed: the same tokens through
    `lm_decode_step` on a new cache. Every step's logits must be finite
    and their argmax the token `make_serve_step` gave there. Returns the
    steps checked."""
    from repro_torch.models.lm import init_lm_cache, lm_decode_step
    batch, n_prompt = prompts.shape
    feed = torch.cat([prompts, gen[:, :-1]], dim=1)
    cache = init_lm_cache(cfg, batch, max_len, dtype=cfg.adtype,
                          device=prompts.device)
    finite = torch.ones((), dtype=torch.bool, device=prompts.device)
    greedy = []
    for i in range(feed.shape[1]):
        logits, cache = lm_decode_step(model, cache, feed[:, i:i + 1], i, cfg)
        finite &= torch.isfinite(logits).all()
        if i >= n_prompt - 1:
            greedy.append(torch.argmax(logits[:, -1], dim=-1))
    del cache
    if not bool(finite):
        raise AssertionError(f"{cfg.name}: a decode step gave a logit that "
                             "is not finite")
    greedy = torch.stack(greedy, dim=1).to(gen.dtype)
    if not torch.equal(greedy, gen):
        raise AssertionError(
            f"{cfg.name}: the argmax of lm_decode_step's logits differs from "
            f"make_serve_step's tokens at {int((greedy != gen).sum())} of "
            f"{gen.numel()} places")
    return feed.shape[1]


def profile_steps(model, cfg, cache, tok, start: int, n: int) -> dict:
    """`n` more serve steps under `torch.profiler`: device time per step
    (the CUDA kernels' own times, summed) against the wall time, which the
    profiler inflates; "not measured" when it records no device time."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.steps import make_serve_step
    step = make_serve_step(cfg)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(start, start + n):
            tok, cache = step(model, cache, tok, i)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [(e.key, e.self_device_time_total, e.count)
               for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA")
               and e.self_device_time_total > 0]
    device_us = sum(k[1] for k in kernels)
    if not device_us:
        return {"device_time": "not measured (no device events)"}
    top = sorted(kernels, key=lambda k: -k[1])[:6]
    return dict(steps=n, wall_ms_per_step=wall / n * 1e3,
                device_ms_per_step=device_us / 1e3 / n,
                device_busy_share=device_us / 1e6 / wall,
                kernel_launches_per_step=sum(k[2] for k in kernels) / n,
                top_kernels=[dict(name=k[0][:60], ms_per_step=k[1] / 1e3 / n,
                                  calls_per_step=k[2] / n) for k in top])


def cross_check(cfg, args, dev) -> dict:
    """Full width, float32 weights, reduced depth: the prefill's logits
    against token-by-token decode logits at every prompt position."""
    import dataclasses
    from repro_torch.models.lm import (init_lm, init_lm_cache, lm_apply,
                                       lm_decode_step)
    depth = cfg.period if cfg.period > 1 else 2
    small = dataclasses.replace(cfg, n_layers=depth, param_dtype="float32",
                                activ_dtype="float32")
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    model = init_lm(small, generator=gen, device=dev)
    n = LM_CHECK
    toks = torch.randint(0, cfg.vocab_size, (2, n), generator=gen,
                         device=dev, dtype=torch.int32)
    want, _ = lm_apply(model, toks, small)
    cache = init_lm_cache(small, 2, n, dtype=torch.float32, device=dev)
    err, scale = 0.0, float(want.abs().max())
    for i in range(n):
        got, cache = lm_decode_step(model, cache, toks[:, i:i + 1], i, small)
        if not torch.allclose(got[:, 0], want[:, i], rtol=2e-3, atol=2e-3):
            raise AssertionError(
                f"{cfg.name} cross-check: decode logits at position {i} "
                f"differ from the prefill's (max abs err "
                f"{float((got[:, 0] - want[:, i]).abs().max())}, tolerance "
                "2e-3 relative plus absolute)")
        err = max(err, float((got[:, 0] - want[:, i]).abs().max()))
    if not bool(torch.isfinite(want).all()):
        raise AssertionError(f"{cfg.name} cross-check: prefill logits not "
                             "finite")
    del model, cache
    return dict(layers=depth, dtype="float32", batch=2, positions=n,
                max_abs_err=err, max_abs_logit=scale, tolerance=2e-3)


def add_counts(into: tuple[dict, dict], launches: dict, shapes: dict):
    counts, seen = into
    for k, v in launches.items():
        counts[k] = counts.get(k, 0) + v
    for k, by_shape in shapes.items():
        acc = seen.setdefault(k, {})
        for shape, v in by_shape.items():
            acc[shape] = acc.get(shape, 0) + v


LM_MAX_LEN = 4096        # KV cache slots per request
LM_CHECK = 64            # positions of the reduced-depth cross-check
LM_PROFILE_STEPS = 4     # serve steps traced after each model's run


def phase_lm_serve(args, dev=None) -> tuple[dict, dict]:
    """Each model of `--lm-models` at full width and depth in bf16; returns
    the launches and launch shapes of the models' runs together (the
    cross-checks are not counted). `dev` is the card (a rehearsal on the
    CPU passes the CPU and smoke configs)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.common import (kernel_launch_counts,
                                            kernel_launch_shapes,
                                            reset_kernel_launch_counts)
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models.lm import init_lm
    dev = torch.device("cuda", 0) if dev is None else dev
    torch.backends.cuda.matmul.allow_tf32 = False    # float32 is float32
    torch.backends.cudnn.allow_tf32 = False
    total = ({}, {})
    for name in args.lm_models:
        cfg = get_config(name)
        check = cross_check(cfg, args, dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        t0 = time.perf_counter()
        model = init_lm(cfg, generator=gen, device=dev)
        torch.cuda.synchronize()
        init_seconds = time.perf_counter() - t0
        weight_bytes = sum(p.numel() * p.element_size()
                           for p in model.parameters())
        B, P, G = args.lm_batch, args.lm_prompt, args.lm_gen
        n_attn = sum(cfg.blocks[i % cfg.period].mixer != "mamba"
                     for i in range(cfg.n_layers))
        n_mamba = cfg.n_layers - n_attn
        fields = {}
        reset_kernel_launch_counts()
        if n_mamba:
            prefill = make_prefill_step(cfg)
            toks = torch.randint(0, cfg.vocab_size, (B, args.lm_prefill),
                                 generator=gen, device=dev,
                                 dtype=torch.int32)
            secs = []
            for _ in range(2):                     # the first call warms up
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logits = prefill(model, {"tokens": toks})
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
            if logits.shape != (B, cfg.vocab_size) or \
                    not bool(torch.isfinite(logits).all()):
                raise AssertionError(f"{name}: bad prefill logits")
            fields.update(prefill_tokens=B * args.lm_prefill,
                          prefill_seconds=secs,
                          prefill_tokens_per_s=B * args.lm_prefill / secs[1])
        prompts = torch.randint(0, cfg.vocab_size, (B, P), generator=gen,
                                device=dev, dtype=torch.int32)
        out, prompt_s, gen_s, cache = serve(model, cfg, prompts, G,
                                            LM_MAX_LEN)
        torch.cuda.synchronize()
        launches, shapes = kernel_launch_counts(), kernel_launch_shapes()
        # after the counts: the profiled steps and the replay are not part
        # of the run
        prof = profile_steps(model, cfg, cache, out[:, -1:], P + G - 1,
                             LM_PROFILE_STEPS)
        del cache
        peak = torch.cuda.max_memory_allocated()
        checked = replay(model, cfg, prompts, out, LM_MAX_LEN)
        want = {}
        if n_attn:
            want["decode_attn"] = n_attn * (P + G - 1)
        if n_mamba:
            want["selective_scan"] = n_mamba * 2
        if launches != want:
            raise AssertionError(f"{name}: launches {launches}, expected "
                                 f"{want} ({n_attn} attention layers x "
                                 f"{P + G - 1} decode steps, {n_mamba} Mamba "
                                 "layers x 2 prefill calls)")
        add_counts(total, launches, shapes)
        emit("lm_serve", model=name, layers=cfg.n_layers,
             d_model=cfg.d_model, vocab=cfg.vocab_size,
             params=sum(p.numel() for p in model.parameters()),
             weight_bytes=weight_bytes, dtype=str(cfg.pdtype), batch=B,
             prompt=P, generated=G, max_len=LM_MAX_LEN, seed=args.seed,
             init_seconds=init_seconds, decode_steps=P + G - 1,
             finite_checked_steps=checked,
             prompt_seconds=prompt_s, prompt_ms_per_step=prompt_s / P * 1e3,
             gen_seconds=gen_s, gen_ms_per_step=gen_s / (G - 1) * 1e3,
             decode_tokens_per_s=B * (G - 1) / gen_s,
             peak_device_bytes=peak, launches=launches,
             first_tokens=out[0, :8].tolist(), cross_check=check,
             profile=prof, **fields, ok=True)
        del model, out
        torch.cuda.empty_cache()
    return total


# ---------------------------------------------------------------------------
# phase 9: every kernel against its plain version
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
    """(rows, wa, wb): the row-wise pair merge, keys and index lanes read
    and written; (k, n): the k-way merge of n keys in k runs of about n / k,
    keys read, keys and source indices written, each entry a search of its
    run's offset and k - 1 binary searches."""
    if len(shape) == 2:
        k, n = shape
        return (20 * n + 4 * (k + 1),
                n * (bits(k) + (k - 1) * bits(max(n // k, 1))))
    rows, wa, wb = shape
    return (2 * rows * (wa + wb) * 12,
            rows * (wa * bits(wb) + wb * bits(wa)))


def sort_cost(shape):
    rows, width = shape
    return 2 * rows * width * 4, rows * sort_ops(width)


def apply_cost(shape):
    """(rows, w_old, w_val): old and the values read, the sorted values and
    the merged row written; the values' sort network once and a compare,
    a select and a move a merged slot."""
    rows, w_old, w_val = shape
    w_merge = next_pow2(w_old + w_val)
    return (rows * 4 * (w_old + w_val + w_val + w_merge),
            rows * (sort_ops(w_val) + 3 * w_merge))


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
                **({"instances": join_instances(nq)} if join else {}),
                ms=time_ms(lambda: launch_scan_exact(*bare), 50),
                **device_time(lambda: launch_scan_exact(*bare)),
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
                **({"instances": join_instances(nq)} if join else {}),
                ms=time_ms(lambda: launch_scan_exact(*bare), 50),
                **device_time(lambda: launch_scan_exact(*bare)),
                wrapper_ms=time_ms(lambda: scan_exact(*args), 20),
                plain_ms=time_ms(lambda: scan_exact_ref(*args), 3),
                library_ms=None)


def scan_mesh_cost(shape, join):
    """(N, W, k[, kj], Q), N islands of W rows in one launch: every
    island's rows read once, its dictionary (and histogram) once each, the
    bounds in, one (2|3, Q) partial out."""
    n_isl, width, k, q = shape[0], shape[1], shape[2], shape[-1]
    lanes = 3 if join else 2
    nbytes = n_isl * (width * (9 + (5 if join else 0)) + k * 4
                      + (shape[3] * 4 if join else 0)) + q * 8 + lanes * q * 8
    return nbytes, n_isl * width * (2 * q + 2) * (2 if join else 1)


def mesh_islands(flat_tensors, sizes):
    """Split flat tensors into per-island slices of `sizes`."""
    cuts = np.concatenate([[0], np.cumsum(sizes)]).tolist()
    return [[t[lo:hi] for lo, hi in zip(cuts, cuts[1:])]
            for t in flat_tensors]


def edge_scan_mesh(gen, dev) -> int:
    """The mesh scans' edges, islands on the one card: an empty island,
    more islands than rows, uneven splits (so unaligned island bases), 17,
    33 and 100 islands (two, three and seven launches of up to 16), Q = 1,
    3 and 33, a dictionary holding int32's extremes (and negatives), each
    island's dictionary its own tensor."""
    from repro_torch.kernels.dict_ops import (scan_exact_mesh,
                                              scan_exact_mesh_ref)
    cases = 0
    for sizes, k, nq in (((0, 40, 41), 30, 3), ((1, 1, 0, 0, 0), 3, 1),
                         ((250_001, 250_000, 250_000, 250_000), 25_000, 33),
                         ((1001, 1000), 64, 3), ((7,) * 100, 5, 1),
                         ((2_500_000,) * 4, 100_000, 33),
                         ((1001,) * 17, 300, 9),
                         (tuple(5000 + 3 * i for i in range(33)), 1000, 3)):
        n = sum(sizes)
        f, a, j, fv, jv, ad, rc = scan_inputs(gen, max(n, 1), k, k, k, dev)
        ad[0], ad[-1] = I32_MIN, I32_MAX
        ad = torch.sort(ad).values
        fi, ai, ji, fvi, jvi = mesh_islands(
            [t[:n] for t in (f, a, j, fv, jv)], sizes)
        bounds = [(0, k)] + [(i % k, i % k + 1 + i % 7)
                             for i in range(nq - 1)]
        dicts = [ad.clone() for _ in sizes] if len(sizes) in (17, 33) \
            else [ad] * len(sizes)
        args = (fi, ai, fvi, dicts, bounds)
        must_equal(f"mesh scan {sizes[:4]} Q={nq}", scan_exact_mesh(*args),
                   scan_exact_mesh_ref(*args))
        jargs = args + (ji, jvi, [rc] * len(sizes))
        must_equal(f"mesh join scan {sizes[:4]} Q={nq}",
                   scan_exact_mesh(*jargs), scan_exact_mesh_ref(*jargs))
        cases += 2
    return cases


def measure_scan_mesh(gen, dev, shape, join: bool) -> dict:
    """At (N, W, k[, kj], Q), the N islands on the one card: `ms` the bare
    launches (one a group of up to 16 islands, with the adds of other
    devices' partials: none here), `wrapper_ms` through the wrapper."""
    from repro_torch.kernels.dict_ops import (launch_scan_exact_mesh,
                                              mesh_launch_groups,
                                              scan_exact_mesh,
                                              scan_exact_mesh_ref)
    n_isl, width, k, nq = shape[0], shape[1], shape[2], shape[-1]
    kj = shape[3] if join else 1
    f, a, j, fv, jv, ad, rc = scan_inputs(gen, n_isl * width, k, k, kj, dev,
                                          invalid=0.0)
    fi, ai, ji, fvi, jvi = mesh_islands((f, a, j, fv, jv), [width] * n_isl)
    span = max(1, 3 * k // 10)
    bounds = [((q * k) // (nq + 1), (q * k) // (nq + 1) + span)
              for q in range(nq)]
    extra = (ji, jvi, [rc] * n_isl) if join else ()
    args = (fi, ai, fvi, [ad] * n_isl, bounds) + extra
    err = must_equal(f"mesh scan {shape}", scan_exact_mesh(*args),
                     scan_exact_mesh_ref(*args))
    islands = [(fi[s], ai[s], fvi[s].view(torch.uint8), ad) + (
        (ji[s], jvi[s].view(torch.uint8), rc) if join else ())
        for s in range(n_isl)]
    groups = mesh_launch_groups([dev] * n_isl, [width] * n_isl)
    barrs = {dev: torch.tensor(bounds, dtype=torch.int32, device=dev)}
    outs = {dev: torch.zeros((3 if join else 2, nq), dtype=torch.int64,
                             device=dev)}

    def bare():
        return launch_scan_exact_mesh(islands, groups, barrs, outs)
    return dict(max_abs_err=err, launches_a_call=len(groups),
                **({"instances": {island_key(1, join_qn(nq)): (
                    scan_instances()[island_key(1, join_qn(nq))])}}
                   if join else {}),
                ms=time_ms(bare, 50), **device_time(bare),
                wrapper_ms=time_ms(lambda: scan_exact_mesh(*args), 20),
                plain_ms=time_ms(lambda: scan_exact_mesh_ref(*args), 3),
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
                host_us=probe_host_costs(table, flat.reshape(-1), kt, vt,
                                         out.reshape(-1), skeys),
                ms=time_ms(lambda: launch_hash_probe(flat, kt, vt, -1, out),
                           200),
                **device_time(lambda: launch_hash_probe(flat, kt, vt, -1,
                                                        out)),
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


HOST_REPS = 10_000


def host_us(fn) -> float:
    """Microseconds of the host's clock per call of `fn` over HOST_REPS
    calls (after one warm-up; the card is synchronised after the loop, not
    inside it)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(HOST_REPS):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds / HOST_REPS * 1e6


def probe_host_costs(table, q, kt, vt, out, skeys) -> dict:
    """The host's cost of one probe launch at the path's shape, item by
    item: what `build.launch` and the wrapper `probe` do, each in a loop of
    its own; beside them what the first design did instead (a device guard
    and a `torch.cuda.Stream` object a launch) and `torch.searchsorted`."""
    from repro_torch.kernels import build
    from repro_torch.kernels.common import check_tensor, count_launch, on_gpu
    from repro_torch.kernels.hash_probe import launch_hash_probe, probe
    fn = build.entry("hash_probe")
    idx = q.device.index
    stream = torch._C._cuda_getCurrentRawStream(idx)
    shape = (1, q.shape[0]) + tuple(kt.shape)

    def arguments():
        return (q.data_ptr(), 1, q.shape[-1], kt.data_ptr(), vt.data_ptr(),
                kt.shape[0], kt.shape[1], -1, out.data_ptr())

    args = arguments() + (stream,)

    def checks():
        table.on(q.device)
        on_gpu(q)
        check_tensor(q, torch.int32, "queries", 1)

    def old_guard():
        with torch.cuda.device(q.device):
            pass

    return dict(
        reps=HOST_REPS,
        ctypes_call_and_launch=host_us(lambda: fn(*args)),
        stream_lookup=host_us(
            lambda: torch._C._cuda_getCurrentRawStream(idx)),
        device_check=host_us(torch._C._cuda_getDevice),
        arguments=host_us(arguments),
        bare_launch=host_us(lambda: launch_hash_probe(q, kt, vt, -1, out)),
        checks=host_us(checks),
        allocation=host_us(lambda: torch.empty_like(q)),
        count_launch=host_us(lambda: count_launch("hash_probe", shape)),
        wrapper=host_us(lambda: probe(table, q)),
        first_design_guard=host_us(old_guard),
        first_design_stream=host_us(
            lambda: torch.cuda.current_stream().cuda_stream),
        library_searchsorted=host_us(lambda: torch.searchsorted(skeys, q)))


def sorted_runs(gen, dev, rows, w, lo=-2**62, hi=2**62):
    k = torch.randint(lo, hi, (rows, w), generator=gen, device=dev,
                      dtype=torch.int64)
    return torch.sort(k, dim=1).values


def kway_runs(gen, dev, lens, lo=-2**62, hi=2**62):
    """Ascending int64 runs of `lens` entries on the card."""
    return [torch.sort(torch.randint(lo, hi, (n,), generator=gen, device=dev,
                                     dtype=torch.int64)).values
            for n in lens]


def edge_merge(gen, dev) -> int:
    from repro_torch.kernels.merge_runs import (MAX_RUNS, merge_pair_ref,
                                                merge_runs_ref,
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
    # the k-way merge, bit for bit against the stable sort of the
    # concatenation: empty runs, one-entry runs, equal keys across runs
    # (narrow key ranges), int64.max and int64.min, shared-memory inputs and
    # ones too large for it (over 4,096 keys), more runs than one launch
    for k, lens, lo, hi in (
            (1, (300,), -5, 5), (2, (1, 0), 0, 1), (2, (700, 300), -20, 20),
            (3, (0, 1, 500), -3, 3), (4, (256, 256, 255, 257), 0, 2**40),
            (4, (3000, 2000, 1, 0), -100, 100), (7, (0, 9, 1, 64, 0, 33, 2),
                                                 -9, 9),
            (8, (1300,) * 8, 0, 500), (MAX_RUNS + 6, (17,) * (MAX_RUNS + 6),
                                       -50, 50)):
        runs = kway_runs(gen, dev, lens, lo, hi)
        for i, r in enumerate(runs):
            if r.numel() > 1:
                r[-1] = 2**63 - 1
                if i % 2:
                    r[0] = -2**63
        got = merge_sorted_runs(runs, device=dev)
        must_equal(f"merge k={k} {lens[:8]}", got, merge_runs_ref(runs))
        cases += 1
    # host runs (commit ids beyond 2^31) copied to the card by the wrapper
    host = [np.sort(np.random.default_rng(i).integers(2**31, 2**40, size=s))
            for i, s in enumerate((257, 0, 300, 255, 1))]
    keys, src = merge_sorted_runs(host, device=dev)
    cat = np.concatenate(host)
    order = np.argsort(cat, kind="stable")
    must_equal("merge host runs", (keys, src),
               (torch.from_numpy(cat[order]).to(dev),
                torch.from_numpy(order.astype(np.int32)).to(dev)))
    pairs = merge_sorted_pairs([host[0], host[2]], [host[3], host[4]],
                               device=dev)
    for got, (x, y) in zip(pairs, ((host[0], host[3]), (host[2], host[4]))):
        must_equal("merge pairs", got,
                   torch.from_numpy(np.sort(np.concatenate([x, y]))).to(dev))
    return cases + 2


SHIP_MERGE = (4, 1024)     # a ship batch: four thread logs of about 256


def measure_merge(gen, dev, shape) -> dict:
    """(k, n): the k-way merge of k runs of about n / k commit-id-like
    keys: `ms` the bare launch, `wrapper_ms` `merge_sorted_runs` on the
    card's runs, `plain_ms` its plain version, `library_ms` one
    `torch.sort(cat, stable=True)`. (rows, wa, wb): the row-wise pair
    merge (no library call returns its index lane as one call)."""
    from repro_torch.kernels.merge_runs import (launch_merge_kway,
                                                launch_merge_runs,
                                                merge_pair_ref,
                                                merge_runs_ref,
                                                merge_sorted_pair,
                                                merge_sorted_runs,
                                                run_offsets)
    if len(shape) == 2:
        k, n = shape
        lens = [n // k + (r < n % k) for r in range(k)]
        runs = kway_runs(gen, dev, lens, 0, 2**40)
        want = merge_runs_ref(runs)
        err = must_equal(f"merge {shape}", merge_sorted_runs(runs), want)
        cat = torch.cat(runs)
        offs = run_offsets(lens)
        ok, oi = torch.empty_like(cat), torch.empty(n, dtype=torch.int32,
                                                    device=dev)
        return dict(max_abs_err=err, runs=lens[:8],
                    ms=time_ms(lambda: launch_merge_kway(cat, offs, ok, oi),
                               200),
                    **device_time(lambda: launch_merge_kway(cat, offs, ok,
                                                            oi)),
                    wrapper_ms=time_ms(lambda: merge_sorted_runs(runs), 200),
                    plain_ms=time_ms(lambda: merge_runs_ref(runs), 200),
                    library_ms=time_ms(
                        lambda: torch.sort(cat, stable=True), 200),
                    library="torch.sort(cat, stable=True)")
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
                **device_time(lambda: launch_merge_runs(a, ai, b, bi, ok, oi)),
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
    # the tile merge: values sorted in every merge block up to 2,048 (w_val
    # 1, 2,048), the separate sort above (4,096; 65,536 with pairwise
    # merges), old widths that are not a multiple of a tile (4,096 slots) or
    # of 4, a row of sentinels only, values all equal to an old key,
    # int32.min, 1 and 65 rows, the path's (8, 32,768, 256)
    for rows, n_old, w_old, n_val, w_val, case in (
            (1, 1, 8, 1, 8, None), (8, 32, 32, 100, 128, None),
            (2, 5000, 8192, 1024, 1024, None),
            (3, 40_000, 65536, 700, 1024, None),
            (2, 100, 128, 40_000, 65536, None),
            (3, 40, 64, 1, 1, None), (2, 5000, 8192, 2000, 2048, None),
            (2, 6000, 8192, 3000, 4096, None),
            (3, 4500, 5003, 200, 256, None), (2, 4000, 4097, 20, 32, None),
            (3, 300, 512, 50, 64, "old_sentinels_only"),
            (4, 300, 512, 60, 64, "values_equal_an_old_key"),
            (2, 300, 512, 70, 128, "int32_min"),
            (1, 9000, 16384, 100, 128, None), (65, 90, 128, 20, 32, None),
            (8, 24_000, 32768, 200, 256, None)):
        old, val = apply_stacks(gen, dev, rows, n_old, w_old, n_val, w_val)
        if case == "old_sentinels_only":
            old[0] = I32_MAX
        elif case == "values_equal_an_old_key":
            val[:, :n_val] = old[:, n_old // 2:n_old // 2 + 1]
        elif case == "int32_min":
            val[:, 1] = I32_MIN
            old[:, 0] = I32_MIN
        must_equal(f"apply {rows}x({w_old}+{w_val}) {case or ''}",
                   apply_pipeline_batch(old, val),
                   apply_pipeline_batch_ref(old, val))
        cases += 1
    # the tile merge alone (K6): runs of any lengths, float32 keys with NaN
    from repro_torch.kernels.bitonic_sort import (launch_merge_rows,
                                                  merge_rows_ref)
    for rows, wa, wb, w_out, dtype in ((1, 1, 1, 2, torch.int32),
                                       (3, 5000, 7, 8192, torch.int32),
                                       (2, 0, 33, 40, torch.int32),
                                       (2, 32768, 32768, 65536, torch.int32),
                                       (3, 4099, 3001, 9000, torch.float32)):
        if dtype == torch.int32:
            a = torch.sort(rand_i32(gen, dev, rows, wa), dim=1).values
            b = torch.sort(rand_i32(gen, dev, rows, wb), dim=1).values
        else:
            a = torch.randn((rows, wa), generator=gen, device=dev)
            b = torch.randn((rows, wb), generator=gen, device=dev)
            a[:, :3] = float("nan")
            b[:, 1] = a[:, 7]
            a, b = torch.sort(a, dim=1).values, torch.sort(b, dim=1).values
        out = torch.empty((rows, w_out), dtype=dtype, device=dev)
        launch_merge_rows(a.data_ptr(), wa, wa, b.data_ptr(), wb, wb, out,
                          w_out, w_out, rows)
        torch.testing.assert_close(out, merge_rows_ref(a, b, w_out), rtol=0,
                                   atol=0, equal_nan=True)
        cases += 1
    return cases


def measure_sort(gen, dev, shape) -> dict:
    from repro_torch.kernels.bitonic_sort import (MAX_TILE, launch_sort_rows,
                                                  sort_rows, sort_rows_ref)
    rows, width = shape
    x = rand_i32(gen, dev, rows, width)
    err = must_equal(f"sort {shape}", sort_rows(x), sort_rows_ref(x))
    out = torch.empty((rows, next_pow2(width)), dtype=torch.int32,
                      device=dev)
    scratch = torch.empty_like(out) if out.shape[1] > MAX_TILE else None

    def bare():          # the wrapper's one call of the C entry
        launch_sort_rows(x, out, scratch)
    return dict(max_abs_err=err, ms=time_ms(bare, 200), **device_time(bare),
                wrapper_ms=time_ms(lambda: sort_rows(x), 200),
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
    svals, merged = apply_pipeline_batch(old, val)
    scratch = torch.empty_like(val) if w_val > MAX_TILE else None

    def bare():          # the wrapper's one call of the C entry
        launch_bitonic_apply(old, val, svals, merged, scratch)
    return dict(max_abs_err=err, ms=time_ms(bare, 100), **device_time(bare),
                wrapper_ms=time_ms(lambda: apply_pipeline_batch(old, val),
                                   100),
                plain_ms=time_ms(lambda: apply_pipeline_batch_ref(old, val),
                                 20),
                library_ms=None)


def merge_rows_cost(shape):
    """(rows, wa, wb): both runs read, the merged row written (int32); a
    compare, a select and a move a slot (a merge's least work)."""
    rows, wa, wb = shape
    return rows * (wa + wb) * 8, rows * (wa + wb) * 3


def measure_merge_rows(gen, dev, shape) -> dict:
    """K6, the tile merge alone, at (rows, wa, wb) int32 runs: `ms` the
    bare launch, `library_ms` one `torch.sort` of the concatenated runs,
    `plain_ms` the plain version (the same sort with the output width's
    padding). No public wrapper: the sort's pairwise merges call it."""
    from repro_torch.kernels.bitonic_sort import (launch_merge_rows,
                                                  merge_rows_ref)
    rows, wa, wb = shape
    a = torch.sort(rand_i32(gen, dev, rows, wa), dim=1).values
    b = torch.sort(rand_i32(gen, dev, rows, wb), dim=1).values
    out = torch.empty((rows, wa + wb), dtype=torch.int32, device=dev)

    def bare():
        launch_merge_rows(a.data_ptr(), wa, wa, b.data_ptr(), wb, wb, out,
                          wa + wb, wa + wb, rows)
    bare()
    err = must_equal(f"merge rows {shape}", out, merge_rows_ref(a, b, wa + wb))
    cat = torch.cat([a, b], dim=1)
    return dict(max_abs_err=err, ms=time_ms(bare, 100), **device_time(bare),
                wrapper_ms=None,
                plain_ms=time_ms(lambda: merge_rows_ref(a, b, wa + wb), 20),
                library_ms=time_ms(lambda: torch.sort(cat, dim=1), 20),
                library="torch.sort(cat(a, b), dim=1)")


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
        **device_time(lambda: launch_snapshot_copy(src, prev, flags, res,
                                                   block)),
        wrapper_ms=time_ms(lambda: snapshot_copy(*args), 20),
        plain_ms=time_ms(lambda: snapshot_copy_ref(*args), 5),
        library_ms=time_ms(lambda: torch.where(mask, src, prev), 20))


def values_cost(shape, rows=6):
    """(nr, Q): the stack read once, bounds in, (2, Q) int64 out; per row
    and predicate two compares, a select and an add per triple."""
    nr, nq = shape
    return nr * rows * 4 + nq * 8 + 2 * nq * 8, nr * nq * 4 * (rows // 3)


def group_cost(shape, kind):
    """The base scan's cost plus the correction lane's over its stack(s)
    and the output's one more row."""
    if kind == "flat":
        *base, nr = shape
        nbytes, ops = scan_cost(tuple(base), False)
        stacks = (nr,)
    elif kind == "sharded":
        *base, nr = shape
        nbytes, ops = scan_sharded_cost(tuple(base), False)
        stacks = (nr,)
    else:
        *base, nr_a, nr_j = shape
        nbytes, ops = scan_cost(tuple(base), True)
        stacks = (nr_a, nr_j)
    nq = base[-1]
    for nr in stacks:
        b, o = values_cost((nr, nq))
        nbytes, ops = nbytes + b - 2 * nq * 8, ops + o
    return nbytes + (3 if kind == "join" else 2) * nq * 8, ops


EDGE_VBOUNDS = [(I32_MIN, I32_MAX), (5, -5), (0, I32_MAX), (-1000, 1000),
                (I32_MIN, I32_MIN), (-7, 7), (100, 900), (-900, -100), (0, 0)]


def corr_stack(gen, dev, rows, nr, lo=-1000, hi=1000, extremes=True):
    """A (rows, nr) int32 correction stack: values in [lo, hi) (and the
    int32 ends), validity lanes 0/1."""
    x = torch.randint(lo, hi, (rows, nr), generator=gen, device=dev,
                      dtype=torch.int32)
    if extremes and nr:
        x[0, 0], x[1, 0] = I32_MIN, I32_MAX
        if rows == 6:
            x[3, 0], x[4, 0] = I32_MAX, I32_MIN
    for r in (2, 5)[:rows // 3]:
        x[r] = torch.rand(nr, generator=gen, device=dev) < 0.8
    return x


def edge_delta(gen, dev) -> int:
    """The correction lane alone (3- and 6-row stacks) and fused with the
    flat, the sharded (3 and 4 islands, padded slots) and the join scans:
    stacks of 0, 1, 3 and 4097 rows, negative and int32-extreme values,
    empty ranges, hi = int32.max, Q of 1, 3 and 9 (two predicate
    slices)."""
    from repro_torch.kernels.dict_ops import (scan_exact_group,
                                              scan_exact_group_ref,
                                              scan_values_exact,
                                              scan_values_exact_ref)
    cases = 0
    n, k = 65_537, 40
    f, a, j, fv, jv, ad, rc = scan_inputs(gen, n, k, k, k, dev)
    for nr in (0, 1, 3, 4097):
        for nq in (1, 3, 9):
            vb = EDGE_VBOUNDS[-nq:] if nq == 3 else EDGE_VBOUNDS[:nq]
            for rows in (3, 6):
                st = corr_stack(gen, dev, rows, nr)
                must_equal(f"values lane {rows}x{nr} Q={nq}",
                           scan_values_exact(st, vb),
                           scan_values_exact_ref(st, vb))
                cases += 1
            bounds = [(0, k)] + [(i % k, i % k + 1 + i % 7)
                                 for i in range(nq - 1)]
            ca = corr_stack(gen, dev, 6, nr)
            cj = corr_stack(gen, dev, 6, nr + 2 if nr else 0, 0, 5000)
            off = nr % 2                        # odd: unaligned pointers
            args = (f[off:], a[off:], fv[off:], ad, bounds, ca, vb)
            must_equal(f"group nr={nr} Q={nq}", scan_exact_group(*args),
                       scan_exact_group_ref(*args))
            jargs = args + (j[off:], jv[off:], rc, cj)
            must_equal(f"join group nr={nr} Q={nq}",
                       scan_exact_group(*jargs), scan_exact_group_ref(*jargs))
            for sizes in ((21_846, 21_846, 21_845), (16_385,) * 4):
                m = sum(sizes)
                lay = [stacked(t[:m], sizes) for t in (f, a, fv)]
                sargs = (lay[0], lay[1], lay[2], ad, bounds, ca, vb)
                must_equal(f"sharded group {len(sizes)} nr={nr} Q={nq}",
                           scan_exact_group(*sargs),
                           scan_exact_group_ref(*sargs))
            cases += 4
    return cases


JOIN_LANE_QS = (1, 2, 8, 9, 17)


def edge_join_lane(gen, dev) -> int:
    """The join lane's passes bit for bit: Q = 1 (its one-predicate pass),
    2 and 8 (the wide pass), 9 and 17 (a second and a third grid slice of
    8); flat views at row offsets 0 - 3 (16-byte loads after 0 - 3 head
    rows) of 1, 3, 4,101 and 1,000,003 rows, columns at different offsets
    (read a row at a time), shards 1,001 wide (each after the first starts
    off a 16-byte boundary), and the join group with empty and one-row
    correction stacks; about 10 % of the rows are fvalid but not
    jvalid."""
    from repro_torch.kernels.dict_ops import (scan_exact, scan_exact_group,
                                              scan_exact_group_ref,
                                              scan_exact_ref)
    cases = 0
    k = 5000
    f, a, j, fv, jv, ad, rc = scan_inputs(gen, 1_000_003 + 4, k, k, k, dev)
    ad[0], ad[-1] = I32_MIN, I32_MAX
    ad = torch.sort(ad).values
    cols = (f, a, fv, j, jv)
    for nq in JOIN_LANE_QS:
        lows = torch.randint(0, k, (nq,), generator=gen, device=dev).tolist()
        bounds = ([(0, k), (7, 7)] + [(lo, lo + 1 + (i * 37) % k)
                                      for i, lo in enumerate(lows)])[:nq]
        vb = (EDGE_VBOUNDS * 2)[:nq]

        def check(what, view, corr=None):
            f_, a_, fv_, j_, jv_ = view
            args = (f_, a_, fv_, ad, bounds, j_, jv_, rc)
            if corr is None:
                must_equal(f"join lane {what} Q={nq}", scan_exact(*args),
                           scan_exact_ref(*args))
            else:
                gargs = (f_, a_, fv_, ad, bounds, corr[0], vb, j_, jv_, rc,
                         corr[1])
                must_equal(f"join group {what} Q={nq}",
                           scan_exact_group(*gargs),
                           scan_exact_group_ref(*gargs))
        for n in (1, 3, 4101, 1_000_003):
            for off in range(4):
                check(f"n={n} off={off}",
                      [t[off:off + n] for t in cols])
                cases += 1
        n = 65_537                       # every column at its own offset
        check("columns at offsets 1, 2, 3, 0, 1",
              [t[o:o + n] for t, o in zip(cols, (1, 2, 3, 0, 1))])
        sizes = (1001, 1000, 999)
        check(f"shards {sizes}",
              [stacked(t[:sum(sizes)], sizes) for t in cols])
        cases += 2
        for nr in (0, 1):
            corr = (corr_stack(gen, dev, 6, nr),
                    corr_stack(gen, dev, 6, nr, 0, 5000))
            for off in (0, 3):
                check(f"stacks of {nr} n=4101 off={off}",
                      [t[off:off + 4101] for t in cols], corr)
                cases += 1
    return cases


def delta_vbounds(nq):
    """Q inclusive ranges over the workload's value domain, ~30 % each."""
    dom = 1 << 24
    return [((q * dom) // (nq + 1), (q * dom) // (nq + 1) + 3 * dom // 10)
            for q in range(nq)]


def measure_group(gen, dev, shape, kind) -> dict:
    """At a recorded shape: the fused kernel (`ms`, the bare launch), the
    same launch without the correction lane (`base_ms`: the flat, sharded
    or join scan alone over the same columns), the wrapper and the plain
    version."""
    from repro_torch.kernels.dict_ops import (launch_scan_exact,
                                              scan_exact_group,
                                              scan_exact_group_ref)
    join = kind == "join"
    if kind == "sharded":
        n_shards, width, k, nq, nr = shape
        n = n_shards * width
    elif join:
        n, k, kj, nq, nr, nr_j = shape
    else:
        n, k, nq, nr = shape
    f, a, j, fv, jv, ad, rc = scan_inputs(gen, n, k, k, kj if join else 1,
                                          dev, invalid=0.0)
    if kind == "sharded":
        f, a, fv = (t.reshape(n_shards, width) for t in (f, a, fv))
    span = max(1, 3 * k // 10)
    bounds = [((q * k) // (nq + 1), (q * k) // (nq + 1) + span)
              for q in range(nq)]
    vb = delta_vbounds(nq)
    ca = corr_stack(gen, dev, 6, nr, 0, 1 << 24, extremes=False)
    extra = ()
    if join:
        extra = (j, jv, rc, corr_stack(gen, dev, 6, nr_j, 0, 1 << 24,
                                       extremes=False))
    args = (f, a, fv, ad, bounds, ca, vb) + extra
    err = must_equal(f"{kind} group {shape}", scan_exact_group(*args),
                     scan_exact_group_ref(*args))
    slices = 1 if f.dim() == 1 else f.shape[0]
    lanes = 3 if join else 2
    res = torch.zeros((slices + 1, lanes, nq), dtype=torch.int64, device=dev)
    base_res = torch.zeros((slices, lanes, nq), dtype=torch.int64,
                           device=dev)
    barr = torch.tensor(bounds, dtype=torch.int32, device=dev)
    vbarr = torch.tensor(vb, dtype=torch.int32, device=dev)
    cols = (f, a, fv.view(torch.uint8), ad, barr)
    jl = (j, jv.view(torch.uint8), rc) if join else ()
    def bare():
        launch_scan_exact(*cols, res, *jl, corr_a=ca,
                          corr_j=extra[3] if join else None,
                          vbounds_dev=vbarr)
    return dict(
        max_abs_err=err,
        **({"instances": join_instances(nq)} if join else {}),
        ms=time_ms(bare, 50), **device_time(bare),
        base_ms=time_ms(lambda: launch_scan_exact(*cols, base_res, *jl), 50),
        wrapper_ms=time_ms(lambda: scan_exact_group(*args), 20),
        plain_ms=time_ms(lambda: scan_exact_group_ref(*args), 3),
        library_ms=None)


def measure_values(gen, dev, shape, rows) -> dict:
    from repro_torch.kernels.dict_ops import (launch_scan_exact,
                                              scan_values_exact,
                                              scan_values_exact_ref)
    nr, nq = shape
    st = corr_stack(gen, dev, rows, nr, 0, 1 << 24, extremes=False)
    vb = delta_vbounds(nq)
    err = must_equal(f"values lane {rows}x{shape}", scan_values_exact(st, vb),
                     scan_values_exact_ref(st, vb))
    res = torch.zeros((1, 2, nq), dtype=torch.int64, device=dev)
    vbarr = torch.tensor(vb, dtype=torch.int32, device=dev)
    def bare():
        launch_scan_exact(None, None, None, None, None, res, corr_a=st,
                          vbounds_dev=vbarr)
    return dict(max_abs_err=err, ms=time_ms(bare, 200), **device_time(bare),
                wrapper_ms=time_ms(lambda: scan_values_exact(st, vb), 200),
                plain_ms=time_ms(lambda: scan_values_exact_ref(st, vb), 20),
                library_ms=None)


def measure_values_delta(gen, dev, shape) -> dict:
    """The values delta at its recorded shape; beside it the raw-value scan
    (the same kernel over a 3-row stack), which no path launches, at the
    same made-up shape."""
    m = measure_values(gen, dev, shape, 6)
    m["raw_value_scan"] = with_bound(measure_values(gen, dev, shape, 3),
                                     shape, lambda s: values_cost(s, 3), 0)
    return m


# -- the float32 scan, flash-decode attention, the selective scan ----------

def float_scan_cost(shape):
    """(n, k): each row's 9 bytes read once, the (1,) sum and count out; a
    gather of 4 bytes per selected row is data-dependent and not counted;
    two compares, an and, a convert and an add per row."""
    n, k = shape
    return n * 9 + 8, n * 5


def edge_float_scan(gen, dev) -> int:
    """Ragged tails, one row, views at row offsets 0 - 3 (16-byte loads
    after 0 - 3 head rows), columns at different offsets (a row at a time),
    an empty range; every call twice, the two sums bit for bit one."""
    from repro_torch.kernels.dict_ops import (scan_filter_agg,
                                              scan_filter_agg_float_ref)
    cases = 0
    for n, k in ((1, 3), (3, 7), (255, 40), (257, 1000),
                 (1_000_003, 50_000)):
        f, a, _, fv, _, ad, _ = scan_inputs(gen, n + 3, k, k, 1, dev)
        views = [(o, o, o) for o in range(4)] + [(1, 2, 0)]
        for fo, ao, vo in views:
            fc, ac, vv = f[fo:fo + n], a[ao:ao + n], fv[vo:vo + n]
            for lo, hi in ((0, k), (k // 3, k // 2 + 1), (1, 1)):
                cols_pred = (fc, ac, vv, ad, lo, hi)
                name = f"float scan n={n} offsets {fo},{ao},{vo}"
                got = scan_filter_agg(*cols_pred, exact=False)
                again = scan_filter_agg(*cols_pred, exact=False)
                if not (torch.equal(got[0].view(torch.int32),
                                    again[0].view(torch.int32))
                        and torch.equal(got[1], again[1])):
                    raise AssertionError(f"{name}: two calls differ: "
                                         f"{got} and {again}")
                float_scan_check(
                    name, got, scan_filter_agg_float_ref(*cols_pred),
                    scan_filter_agg(*cols_pred), abs_sum(*cols_pred), n, dev)
                cases += 1
    return cases


def measure_float_scan(gen, dev, shape) -> dict:
    from repro_torch.kernels.dict_ops import (launch_scan_float,
                                              scan_filter_agg,
                                              scan_filter_agg_float_ref)
    from repro_torch.kernels.dict_ops.ops import (float_scan_counter,
                                                  float_scan_parts)
    n, k = shape
    f, a, _, fv, _, ad, _ = scan_inputs(gen, n, k, k, 1, dev, invalid=0.0)
    lo, hi = k // 4, k // 4 + max(1, 3 * k // 10)   # about 30 % of rows
    s, c = scan_filter_agg(f, a, fv, ad, lo, hi, exact=False)
    es, ec = scan_filter_agg(f, a, fv, ad, lo, hi)
    rel = float_scan_check(f"float scan {shape}", (s, c),
                           scan_filter_agg_float_ref(f, a, fv, ad, lo, hi),
                           (es, ec), abs_sum(f, a, fv, ad, lo, hi), n, dev)
    parts = float_scan_parts(dev, n)
    psum = torch.empty(parts, dtype=torch.float32, device=dev)
    pcnt = torch.empty(parts, dtype=torch.int32, device=dev)
    out_s = torch.empty(1, dtype=torch.float32, device=dev)
    out_c = torch.empty(1, dtype=torch.int32, device=dev)
    counter = float_scan_counter(dev)
    fvu = fv.view(torch.uint8)

    def bare():
        launch_scan_float(f, a, fvu, ad, lo, hi, psum, pcnt, counter, out_s,
                          out_c)
    return dict(
        max_abs_err=abs(float(s) - es), rel_err=rel,
        tolerance=FLOAT_SCAN_TOL, parts=parts,
        instances={float_key(v): scan_instances()[float_key(v)]
                   for v in (0, 1)},
        ms=time_ms(bare, 50), **device_time(bare),
        wrapper_ms=time_ms(lambda: scan_filter_agg(f, a, fv, ad, lo, hi,
                                                   exact=False), 20),
        plain_ms=time_ms(lambda: scan_filter_agg_float_ref(f, a, fv, ad, lo,
                                                           hi), 3),
        library_ms=None)


def decode_cost(shape, kv_bytes=2, q_bytes=2):
    """(B, S, H, Hkv, d, length): the valid prefix of K and V read once
    (slots past `length` are never read), q in, out written; a dot product
    and an update of the output (two multiply-adds) per (head, slot,
    element), a softcap and an exponential per (head, slot)."""
    B, S, H, Hkv, d, length = shape
    nbytes = 2 * B * length * Hkv * d * kv_bytes + 2 * B * H * d * q_bytes
    return nbytes, B * H * length * (4 * d + 8)


def decode_inputs(gen, dev, shape, q_dtype, kv_dtype):
    B, S, H, Hkv, d, length = shape
    q = torch.randn((B, H, d), generator=gen, device=dev).to(q_dtype)
    k = torch.randn((B, S, Hkv, d), generator=gen, device=dev).to(kv_dtype)
    v = torch.randn((B, S, Hkv, d), generator=gen, device=dev).to(kv_dtype)
    return q, k, v


def edge_decode(gen, dev) -> int:
    """Ragged S, length 1 and length = S, G 1 to 8, d 16 to 256 (kimi-k2's
    112 with G 8 among them), softcap on and off, a full rolling cache (S =
    window = length), a float32 and a bf16 cache (float32 queries: the
    plain version up-casts the cache), then bf16 queries and output."""
    from repro_torch.kernels.decode_attn import (decode_attention,
                                                 decode_attention_ref)
    cases = 0
    for shape, cap in (((2, 1000, 8, 8, 128, 1), 0.0),
                       ((3, 777, 10, 2, 128, 777), 50.0),
                       ((1, 4097, 56, 8, 128, 3001), 0.0),
                       ((2, 9, 4, 2, 64, 5), 30.0),
                       ((1, 300, 8, 1, 256, 300), 0.0),
                       ((2, 4096, 16, 8, 256, 4096), 50.0),   # rolling, full
                       ((1, 5000, 28, 4, 128, 4999), 0.0),    # G 7
                       ((2, 1001, 64, 8, 112, 1), 50.0),      # kimi-k2: d 112
                       ((1, 777, 64, 8, 112, 777), 0.0),
                       ((3, 4099, 64, 8, 112, 2050), 50.0),
                       ((2, 300, 4, 2, 16, 300), 30.0),       # smoke configs
                       ((1, 97, 8, 8, 16, 1), 0.0),
                       ((2, 513, 12, 4, 48, 400), 50.0),
                       ((1, 2000, 24, 8, 96, 1999), 0.0),
                       ((1, 65, 8, 2, 240, 64), 50.0)):
        B, S, H, Hkv, d, length = shape
        for kv in (torch.float32, torch.bfloat16):
            q, k, v = decode_inputs(gen, dev, shape, torch.float32, kv)
            want = decode_attention_ref(q, k, v, length, d ** -0.5, cap)
            must_be_close(f"decode {shape} cap={cap} {kv}",
                          decode_attention(q, k, v, length, softcap=cap),
                          want, 2e-5)
            cases += 1
        q = q.bfloat16()                    # the serving path's types
        must_be_close_bf16(f"decode {shape} cap={cap} bf16 q",
                           decode_attention(q, k, v, length, softcap=cap),
                           decode_attention_ref(q.float(), k, v, length,
                                                d ** -0.5, cap))
        cases += 1
    return cases


def measure_decode(gen, dev, shape) -> dict:
    """Checked against the plain version with float32 queries (2e-5) and
    at the path's types, bf16 queries and cache (one bf16 rounding more),
    then timed at the path's types; with the split plan (splits, the
    resident blocks of one wave, waves), the achieved rate and ptxas'
    registers of the instance that ran."""
    from repro_torch.kernels.decode_attn import (decode_attention,
                                                 decode_attention_ref,
                                                 launch_decode_attention)
    from repro_torch.kernels.decode_attn.ops import (resident_blocks,
                                                     split_counters,
                                                     split_plan)
    import torch.nn.functional as F
    B, S, H, Hkv, d, length = shape
    cap = 50.0
    q, k, v = decode_inputs(gen, dev, shape, torch.float32, torch.bfloat16)
    err = must_be_close(f"decode {shape}",
                        decode_attention(q, k, v, length, softcap=cap),
                        decode_attention_ref(q, k, v, length, d ** -0.5, cap),
                        2e-5)
    q = q.bfloat16()
    err_bf16 = must_be_close_bf16(
        f"decode {shape} bf16 q", decode_attention(q, k, v, length,
                                                   softcap=cap),
        decode_attention_ref(q.float(), k, v, length, d ** -0.5, cap))
    out = torch.empty_like(q)
    G = H // Hkv
    resident = resident_blocks(dev, True, True, d, G)
    ns, chunk = split_plan(length, B, Hkv, resident)
    pm = torch.empty(B * H * ns, dtype=torch.float32, device=dev)
    pl = torch.empty_like(pm)
    pa = torch.empty(B * H * ns * d, dtype=torch.float32, device=dev)
    cnt = split_counters(dev, B * Hkv)
    scale = d ** -0.5
    q4 = q[:, :, None, :]
    kl = k[:, :length].transpose(1, 2)
    vl = v[:, :length].transpose(1, 2)
    def bare():
        launch_decode_attention(q, k, v, length, out, scale, cap, ns, chunk,
                                pm, pl, pa, cnt)
    ms = time_ms(bare, 50)
    return dict(
        max_abs_err=err, tolerance=2e-5, max_abs_err_bf16=err_bf16,
        tolerance_bf16=f"{BF16_OUT_RTOL} relative plus {BF16_OUT_ATOL}",
        splits=ns, chunk=chunk, resident_blocks=resident,
        waves=ns * B * Hkv / resident,
        registers=decode_registers().get("bf16 cache, bf16 q"),
        ms=ms, **device_time(bare),
        achieved_GBps=decode_cost(shape)[0] / ms / 1e6,
        wrapper_ms=time_ms(lambda: decode_attention(q, k, v, length,
                                                    softcap=cap), 20),
        plain_ms=time_ms(lambda: decode_attention_ref(q, k, v, length, scale,
                                                      cap), 3),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            q4, kl, vl, enable_gqa=True), 20),
        library="F.scaled_dot_product_attention, softcap 0, on the valid "
                "prefix (a transposed view of the cache)")


def ssm_cost(shape):
    """(B, T, D, N): x and dt read and y written (12 B per (t, channel)),
    B_t and C_t (8 N B per step), A and the skip; per (t, channel, state)
    an exponential, three multiply-adds and a multiply."""
    B, T, D, N = shape
    return (12 * B * T * D + 8 * B * T * N + 4 * D * (N + 1),
            B * T * D * (7 * N + 3))


SFU_EXP_PER_CLOCK = 16     # exponentials an SM's SFUs take a clock (sm_90)


def sm_clock_hz() -> float:
    """The card's highest SM clock (`nvidia-smi clocks.max.sm`)."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], check=True,
                         capture_output=True, text=True).stdout
    return float(out.split()[0]) * 1e6


def ssm_sfu_bound_ms(shape) -> float:
    """The B T D N exponentials alone on the SFUs: 16 a clock an SM, every
    SM, at the card's highest clock."""
    B, T, D, N = shape
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return B * T * D * N / (SFU_EXP_PER_CLOCK * sms * sm_clock_hz()) * 1e3


def ssm_inputs(gen, dev, shape):
    B, T, D, N = shape
    x = torch.randn((B, T, D), generator=gen, device=dev)
    dt = torch.randn((B, T, D), generator=gen, device=dev).abs() * 0.1
    a = -torch.randn((D, N), generator=gen, device=dev).abs()
    b = torch.randn((B, T, N), generator=gen, device=dev)
    c = torch.randn((B, T, N), generator=gen, device=dev)
    d = torch.randn((D,), generator=gen, device=dev)
    return x, dt, a, b, c, d


def ssm_registers() -> dict[str, dict]:
    """ptxas' registers and spill bytes of each selective-scan instance, by
    d_state and staging (16-byte or 4-byte copies)."""
    out = {}
    for entry, n in REGISTERS.items():
        m = re.search(r"selective_scan_kernelILi(\d+)ELb([01])E", entry)
        if m:
            staging = "16B" if m.group(2) == "1" else "4B"
            out[f"N{m.group(1)} {staging}"] = dict(
                registers=n, spill_bytes=SPILLS.get(entry, 0))
    return out


SSM_EDGES = ((1, 1, 1, 4), (2, 257, 100, 8), (3, 1000, 130, 16),
             (1, 33, 8192, 16), (4, 31, 4096, 4),
             # falcon-mamba-7b's prefill; D not a multiple of a block's 32
             # channels (16-byte staging), and D % 4 != 0 (4-byte staging)
             (4, 2048, 8192, 16), (2, 300, 8200, 16), (2, 129, 4101, 8))


def edge_ssm(gen, dev) -> int:
    """T and D not multiples of the tiles, one step, one channel, N 4, 8
    and 16, the prefill's shape."""
    from repro_torch.kernels.selective_scan import (selective_scan,
                                                    selective_scan_ref)
    for shape in SSM_EDGES:
        args = ssm_inputs(gen, dev, shape)
        must_be_close(f"selective scan {shape}", selective_scan(*args),
                      selective_scan_ref(*args), 3e-5)
    return len(SSM_EDGES)


def measure_ssm(gen, dev, shape) -> dict:
    """Held to 3e-5; `bound_sfu_ms` beside the bytes and operations
    bound."""
    from repro_torch.kernels.selective_scan import (launch_selective_scan,
                                                    selective_scan,
                                                    selective_scan_ref)
    args = ssm_inputs(gen, dev, shape)
    t0 = time.perf_counter()
    want = selective_scan_ref(*args)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = must_be_close(f"selective scan {shape}", selective_scan(*args),
                        want, 3e-5)
    y = torch.empty_like(args[0])
    return dict(
        max_abs_err=err, tolerance=3e-5,
        ms=time_ms(lambda: launch_selective_scan(*args, y), 10),
        **device_time(lambda: launch_selective_scan(*args, y)),
        wrapper_ms=time_ms(lambda: selective_scan(*args), 10),
        plain_ms=plain_ms, library_ms=None,
        bound_sfu_ms=ssm_sfu_bound_ms(shape), registers=ssm_registers())


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
    "bitonic_merge_rows": (merge_rows_cost, measure_merge_rows),
    "bitonic_apply": (apply_cost, measure_apply),
    "snapshot_copy": (snapshot_cost, measure_snapshot),
    "scan_exact_group": (lambda s: group_cost(s, "flat"),
                         lambda g, d, s: measure_group(g, d, s, "flat")),
    "scan_exact_group_sharded": (
        lambda s: group_cost(s, "sharded"),
        lambda g, d, s: measure_group(g, d, s, "sharded")),
    "scan_exact_join_group": (lambda s: group_cost(s, "join"),
                              lambda g, d, s: measure_group(g, d, s, "join")),
    "scan_values_delta": (values_cost, measure_values_delta),
    "scan_exact_mesh": (lambda s: scan_mesh_cost(s, False),
                        lambda g, d, s: measure_scan_mesh(g, d, s, False)),
    "scan_exact_join_mesh": (
        lambda s: scan_mesh_cost(s, True),
        lambda g, d, s: measure_scan_mesh(g, d, s, True)),
    "scan_float": (float_scan_cost, measure_float_scan),
    "decode_attn": (decode_cost, measure_decode),
    "selective_scan": (ssm_cost, measure_ssm),
}
DECODE_32K = (4, 32768, 16, 8, 256, 32768)    # gemma2's heads at decode_32k
DECODE_32K_D112 = (4, 32768, 64, 8, 112, 32768)   # kimi-k2's heads


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
             + edge_join_lane(gen, dev)
             + edge_scan_mesh(gen, dev) + edge_probe(gen, dev) + edge_merge(gen, dev)
             + edge_bitonic(gen, dev) + edge_snapshot(gen, dev)
             + edge_delta(gen, dev) + edge_float_scan(gen, dev)
             + edge_decode(gen, dev) + edge_ssm(gen, dev))
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
        if name == "merge_runs" and most != SHIP_MERGE:
            measured[name]["at_ship"] = with_bound(
                measure(gen, dev, SHIP_MERGE), SHIP_MERGE, cost,
                seen.get(SHIP_MERGE, 0))
            cases += 1
        if name == "decode_attn":
            for key, shape in (("at_decode_32k", DECODE_32K),
                               ("at_decode_32k_d112", DECODE_32K_D112)):
                measured[name][key] = with_bound(measure(gen, dev, shape),
                                                 shape, cost, 0)
                cases += 1
    torch.cuda.synchronize()
    emit("kernels", cases=cases,
         tolerance="0 (integers); float32: decode_attn 2e-5 (bf16 output: "
                   f"{BF16_OUT_RTOL} relative plus {BF16_OUT_ATOL}), "
                   f"selective_scan 3e-5, scan_float: {FLOAT_SCAN_TOL}",
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
    ap.add_argument("--delta-islands", default="1,4",
                    type=lambda s: [int(n) for n in s.split(",")],
                    help="island counts of the delta phase, in order")
    ap.add_argument("--delta-capacity", type=int, default=4096,
                    help="appended entries per column between compactions")
    ap.add_argument("--mesh-islands", default="4,1",
                    type=lambda s: [int(n) for n in s.split(",")],
                    help="island counts of the mesh phase with the islands "
                         "on one card, in order (the first also runs the "
                         "delta store)")
    ap.add_argument("--lm-models", default="gemma2-9b,falcon-mamba-7b",
                    type=lambda s: [m for m in s.split(",") if m],
                    help="models of the lm_serve phase, in order (full "
                         "configs)")
    ap.add_argument("--lm-batch", type=int, default=4,
                    help="requests served at once")
    ap.add_argument("--lm-prompt", type=int, default=256,
                    help="prompt tokens per request, fed one at a time")
    ap.add_argument("--lm-gen", type=int, default=32,
                    help="generated tokens per request (at least 2)")
    ap.add_argument("--lm-prefill", type=int, default=2048,
                    help="prompt length of the Mamba model's prefill calls")
    args = ap.parse_args(argv)
    if args.lm_gen < 2 or (args.lm_prompt + args.lm_gen - 1
                           + LM_PROFILE_STEPS > LM_MAX_LEN):
        ap.error(f"--lm-gen must be at least 2 and the prompt plus the "
                 f"generated tokens must fit {LM_MAX_LEN} cache slots")

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
    main_launches, main_shapes, answers, cols, seconds = phase_main_path(
        args, wl)
    runs["main_path"] = (main_launches, main_shapes)
    runs["islands"] = phase_islands(args, wl, main_launches, answers, cols)
    runs["delta"] = phase_delta(args, wl, answers, cols, seconds)
    runs["mesh"] = phase_mesh(args, wl, main_launches, answers, cols)
    runs["ana_only"] = phase_ana_only(args, wl)
    runs["float_scan"] = phase_float_scan(args, wl, cols)
    del cols
    torch.cuda.empty_cache()
    runs["lm_serve"] = phase_lm_serve(args)
    # every kernel's launches and shapes from the path that runs it
    missing = [k for k in REPLACES if k not in NO_CALLER_SHAPE
               and k not in runs[PATH_OF.get(k, "main_path")][0]]
    if missing:
        raise AssertionError(f"kernels never launched on their paths: "
                             f"{missing}")
    launches = {k: runs[PATH_OF.get(k, "main_path")][0].get(k, 0)
                for k in REPLACES}
    shapes = {k: runs[PATH_OF.get(k, "main_path")][1][k] for k in REPLACES
              if k not in NO_CALLER_SHAPE}
    by_path = {}
    for k, shape in NO_CALLER_SHAPE.items():
        # the shapes any path launched it at, else the made-up one
        by_path[k] = {p: r[0].get(k, 0) for p, r in runs.items()}
        seen = {}
        for r in runs.values():
            for sh, c in r[1].get(k, {}).items():
                seen[sh] = seen.get(sh, 0) + c
        shapes[k] = seen or {shape: 0}
    measured = phase_kernels(shapes)

    print(json.dumps({"kernels": [
        dict(name=k, route="cuda", source=SOURCES[k], replaces=REPLACES[k],
             launches=launches[k], **m,
             **({"launches_by_path": by_path[k]} if k in by_path else {}))
        for k, m in measured.items()]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
