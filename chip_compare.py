#!/usr/bin/env python3
"""Times the kernels that recent changes redesigned, and the scans beside
them as controls, of two checkouts in turns on one card, so that a change
is compared with its parent under the same clocks and host.

    git archive <parent> | tar -x -C build/parent
    python3 chip_compare.py build/parent .      # needs one Hopper card
    python3 chip_compare.py build/parent . --only flash   # the blocked
                                                # attention alone

Runs each tree in its own process, in the order A, B, B, A, each through
that tree's own `chip_smoke.py` measurement functions (its wrappers, its
kernels, built from its sources into its own `build/`), with one timing
rule for both: 10 warm-up calls, then CUDA events around the timed calls.
Prints the card's name and power limit, then one JSON line per run, each
kernel at a shape its path launched it at: K7 at the main path's ship
batch (8 rows, 32,768 + 256); K15 and its join form at four islands of
2,500,000 rows on the one card (k 25,000, Q 1); at 10,000,000 rows the
exact scan K1, the join scan K9, the delta group K12 (stack 4,012) and the
join delta group K14 (stacks 4,163 and 4,064), the sharded scan K2 and the
sharded join scan K11 at 3 x 3,333,334, the float32 scan K18 and the
snapshot copy K10 (chunks of 8,192); the selective scan K17 and its
backward at the training path's (1, 4,096, 8,192, 16), the backward also
at d_state 8, with its registers:
the blocked attention's forward at whisper's bidirectional (2, 4,096,
8, 8, 64) and gemma2's prefill (4, 4,096, 16, 8, 256, causal, window
4,096, softcap 50) shapes and its backward (both launches) at whisper's:
`ms` (bare launches), `device_ms` (the device's own time of 20 bare
launches under `torch.profiler`, a launch, by the tree's own
`device_time`) and `wrapper_ms` of each, and for K7 and K15 also
`wrapper_device_ms`, the device time of 20 wrapper calls, a call,
measured here the same way for both trees; where the run built the
tree's library, ptxas' registers and spill bytes of its scan kernels
(`ptxas`).

The delta plane's folds, each against what it folds in a tree without it
(the sum of the parts, under `parts`): the correction lane alone, K13, at a
stack of 4,031 rows, Q 1 (`values_lane`); the stacked join group at 4 x
2,500,000 rows with stacks of 4,163 and 4,064 rows
(`sharded_join_group`: one launch, or K11 and two K13s); K15 and its join
form with the correction slice over the same stacks (`mesh_group`, also
at Q 3, `mesh_group_q3`, and `mesh_join_group`: one launch a device, or
K15 and one or two K13s), with
`base_device_ms`, the same launch without the slice, where the tree folds;
and for each `wrapper_device_ms` through the tree's public wrappers.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys


def _device_ms(fn, reps: int = 20) -> float | None:
    """The CUDA kernels' (and copies') own time a call of `fn` under
    `torch.profiler`; None where it records no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if str(e.device_type).endswith("CUDA"))
    return us / 1e3 / reps if us else None


def _mesh_wrapper(dev, n_isl, width, k, join, gen, cs):
    """The tree's mesh-scan wrapper call at `n_isl` islands of `width` rows
    on `dev`."""
    from repro_torch.kernels import dict_ops
    f, a, j, fv, jv, ad, rc = cs.scan_inputs(gen, n_isl * width, k, k, k,
                                             dev, invalid=0.0)
    fi, ai, ji, fvi, jvi = cs.mesh_islands((f, a, j, fv, jv),
                                           [width] * n_isl)
    span = 3 * k // 10
    bounds = [(k // 2, k // 2 + span)]
    extra = (ji, jvi, [rc] * n_isl) if join else ()
    args = (fi, ai, fvi, [ad] * n_isl, bounds) + extra

    def wrapper():
        dict_ops.scan_exact_mesh(*args)
    return wrapper


K, KJ, W, STACKS = 25_000, 25_000, 2_500_000, (4163, 4064)


def _folds(cs, dev, gen) -> dict:
    """The delta plane's folds in this tree, or the parts they fold."""
    import torch
    from repro_torch.kernels import dict_ops, hash_probe
    folds = "scan_exact_join_group_sharded" in cs.KERNELS
    keys = ("ms", "device_ms", "wrapper_ms")

    def pick(m):
        return {k: m.get(k) for k in keys + ("base_device_ms",)
                if m.get(k) is not None}

    def summed(parts):
        return dict({k: sum(p[k] for p in parts.values()) for k in keys},
                    parts=parts)
    out = {}
    lane = cs.measure_values(gen, dev, (4031, 1), 6)
    out["values_lane"] = dict(pick(lane), shape=[4031, 1])
    lanes = {nr: cs.measure_values(gen, dev, (nr, 1), 6) for nr in STACKS}

    f, a, j, fv, jv, ad, rc = cs.scan_inputs(gen, 4 * W, K, K, KJ, dev,
                                             invalid=0.0)
    ca = cs.corr_stack(gen, dev, 6, STACKS[0], 0, 1 << 24, extremes=False)
    cj = cs.corr_stack(gen, dev, 6, STACKS[1], 0, 1 << 24, extremes=False)
    bounds, vb = [(K // 2, K // 2 + 3 * K // 10)], cs.delta_vbounds(1)

    # the stacked join group
    shape = (4, W, K, KJ, 1) + STACKS
    stacked = [t.reshape(4, W) for t in (f, a, j, fv, jv)]
    if folds:
        m = pick(cs.measure_group(gen, dev, shape, "join_sharded"))

        def wrapper():
            hash_probe.scan_filter_agg_join_group_sharded(
                stacked[0], stacked[1], stacked[2], stacked[3], stacked[4],
                ad, rc, bounds, ca, cj, vb)
    else:
        m = summed({"K11": pick(cs.measure_scan_sharded(gen, dev, shape[:5],
                                                        True)),
                    "K13_a": pick(lanes[STACKS[0]]),
                    "K13_j": pick(lanes[STACKS[1]])})

        def wrapper():
            hash_probe.scan_filter_agg_join_sharded(
                stacked[0], stacked[1], stacked[2], stacked[3], stacked[4],
                ad, rc, bounds)
            dict_ops.scan_values_delta(ca, vb)
            dict_ops.scan_values_delta(cj, vb)
    out["sharded_join_group"] = dict(m, shape=list(shape),
                                     wrapper_device_ms=_device_ms(wrapper))

    # the mesh scans with the correction (a group of three predicates as
    # well: eight a pass)
    fi, ai, ji, fvi, jvi = cs.mesh_islands((f, a, j, fv, jv), [W] * 4)
    for join, nq in ((False, 1), (False, 3), (True, 1)):
        name = ("mesh_join_group" if join else "mesh_group") + (
            f"_q{nq}" if nq > 1 else "")
        stacks = STACKS if join else STACKS[:1]
        shape = (4, W, K) + ((KJ,) if join else ()) + (nq,)
        extra = (ji, jvi, [rc] * 4) if join else ()
        qb = [((q * K) // (nq + 1), (q * K) // (nq + 1) + 3 * K // 10)
              for q in range(nq)]
        qvb = cs.delta_vbounds(nq)
        args = (fi, ai, fvi, [ad] * 4, qb) + extra
        if folds:
            m = pick(cs.measure_scan_mesh(gen, dev, shape + stacks, join))

            def wrapper():
                dict_ops.scan_exact_mesh(*args, corr_a=ca,
                                         corr_j=cj if join else None,
                                         vbounds=qvb)
        else:
            parts = {"K15": pick(cs.measure_scan_mesh(gen, dev, shape, join))}
            for nr in stacks:
                parts[f"K13_{nr}"] = pick(
                    lanes[nr] if nq == 1
                    else cs.measure_values(gen, dev, (nr, nq), 6))
            m = summed(parts)

            def wrapper():
                dict_ops.scan_exact_mesh(*args)
                dict_ops.scan_values_delta(ca, qvb)
                if join:
                    dict_ops.scan_values_delta(cj, qvb)
        out[name] = dict(m, shape=list(shape + stacks),
                         wrapper_device_ms=_device_ms(wrapper))
    del f, a, j, fv, jv, stacked, fi, ai, ji, fvi, jvi
    torch.cuda.empty_cache()
    return out


# the blocked attention's shapes: (B, Sq, Skv, H, Hkv, dh, causal, window,
# softcap)
FLASH_WHISPER = (2, 4096, 4096, 8, 8, 64, 0, 0, 0)
FLASH_GEMMA2 = (4, 4096, 4096, 16, 8, 256, 1, 4096, 50)


def _flash(cs, dev, gen) -> dict:
    """The blocked attention's forward at whisper's and gemma2's shapes and
    its backward at whisper's, through the tree's own measurements."""
    import torch
    out = {}
    for name, measure, shape in (
            ("flash_fwd_whisper", cs.measure_flash, FLASH_WHISPER),
            ("flash_fwd_gemma2", cs.measure_flash, FLASH_GEMMA2),
            ("flash_bwd_whisper", cs.measure_flash_bwd, FLASH_WHISPER)):
        m = measure(gen, dev, shape)
        out[name] = dict({key: m.get(key) for key in (
            "ms", "device_ms", "wrapper_ms", "max_abs_err")},
            shape=list(shape))
        torch.cuda.empty_cache()
    return out


def _one(root: str, only: str | None = None) -> dict:
    sys.argv = ["chip_compare"]
    sys.path[:0] = [root, root + "/src"]
    import torch
    import chip_smoke as cs

    def time_ms(fn, reps):
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / reps

    cs.time_ms = time_ms
    cs.phase_build()
    from repro_torch.kernels.bitonic_sort import apply_pipeline_batch
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    keys = ("ms", "device_ms", "wrapper_ms")
    out = {"tree": root}
    if only == "flash":
        out.update(_flash(cs, dev, gen))
        return out

    shape = (8, 32768, 256)
    m = cs.measure_apply(gen, dev, shape)
    old, val = cs.apply_stacks(gen, dev, 8, 24576, 32768, 192, 256)
    out["apply"] = dict(
        {k: m[k] for k in keys}, shape=list(shape),
        wrapper_device_ms=_device_ms(lambda: apply_pipeline_batch(old, val)))

    out.update(_folds(cs, dev, gen))
    for join in (False, True):
        name = "mesh_join" if join else "mesh"
        shape = (4, 2_500_000, 25_000) + ((25_000,) if join else ()) + (1,)
        if "scan_exact_join_group_sharded" in cs.KERNELS:
            # a mesh launch's shape records its stacks' rows (0: none)
            shape += (0, 0) if join else (0,)
        m = cs.measure_scan_mesh(gen, dev, shape, join)
        wrapper = _mesh_wrapper(dev, 4, 2_500_000, 25_000, join, gen, cs)
        out[name] = dict({k: m[k] for k in keys}, shape=list(shape),
                         wrapper_device_ms=_device_ms(wrapper))

    n, k, kj = 10_000_000, 25_000, 25_000
    third = -(-n // 3)
    for name, measure, shape in (
            ("scan", lambda s: cs.measure_scan(gen, dev, s, False),
             (n, k, 1)),
            ("join_scan", lambda s: cs.measure_scan(gen, dev, s, True),
             (n, k, kj, 1)),
            ("sharded_scan",
             lambda s: cs.measure_scan_sharded(gen, dev, s, False),
             (3, third, k, 1)),
            ("sharded_join_scan",
             lambda s: cs.measure_scan_sharded(gen, dev, s, True),
             (3, third, k, kj, 1)),
            ("group", lambda s: cs.measure_group(gen, dev, s, "flat"),
             (n, k, 1, 4012)),
            ("join_group", lambda s: cs.measure_group(gen, dev, s, "join"),
             (n, k, kj, 1, 4163, 4064)),
            ("scan_float", lambda s: cs.measure_float_scan(gen, dev, s),
             (n, k)),
            ("snapshot_copy", lambda s: cs.measure_snapshot(gen, dev, s),
             (n, 8192))):
        m = measure(shape)
        out[name] = dict({key: m.get(key) for key in keys},
                         shape=list(shape))
        torch.cuda.empty_cache()
    # K17 and its backward at the training path's shape (one sequence), the
    # backward also at d_state 8
    for name, measure, shape in (
            ("selective_scan", cs.measure_ssm, (1, 4096, 8192, 16)),
            ("selective_scan_bwd", cs.measure_ssm_bwd, (1, 4096, 8192, 16)),
            ("selective_scan_bwd_n8", cs.measure_ssm_bwd,
             (1, 4096, 8192, 8))):
        m = measure(gen, dev, shape)
        out[name] = dict({key: m.get(key) for key in keys},
                         shape=list(shape))
        torch.cuda.empty_cache()
    out["selective_scan_bwd"]["registers"] = cs.ssm_registers(backward=True)
    out.update(_flash(cs, dev, gen))
    # ptxas' registers and spill bytes of the scans' kernels (the selective
    # scan's and its backward's among them), where this process built the
    # tree's library
    out["ptxas"] = {re.sub(r"^_ZN\w*?_cu_\w{8}\d+", "", e):
                    [r, cs.SPILLS.get(e, 0)]
                    for e, r in cs.REGISTERS.items() if "scan" in e}
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    only = None
    if len(argv) >= 2 and argv[-2] == "--only":
        only, argv = argv[-1], argv[:-2]
    if len(argv) == 2 and argv[0] == "--one":
        print(json.dumps(_one(argv[1], only)), flush=True)
        return 0
    if len(argv) != 2 or only not in (None, "flash"):
        print(__doc__, file=sys.stderr)
        return 2
    a, b = argv
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip(),
          flush=True)
    for root in (a, b, b, a):
        run = subprocess.run([sys.executable, __file__, "--one", root]
                             + (["--only", only] if only else []),
                             capture_output=True, text=True)
        lines = [l for l in run.stdout.splitlines() if l.startswith("{")]
        if run.returncode or not lines:
            print(run.stdout[-2000:], run.stderr[-4000:], file=sys.stderr)
            return 1
        print(lines[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
