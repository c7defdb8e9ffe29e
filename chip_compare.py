#!/usr/bin/env python3
"""Times the fused ship-batch apply (K7), the mesh scans (K15) and the
scans and copies whose wrappers launch through `build.launch` (K1, K10,
K18) of two checkouts in turns on one card, so that a change is compared
with its parent under the same clocks and host.

    git archive <parent> | tar -x -C build/parent
    python3 chip_compare.py build/parent .      # needs one Hopper card

Runs each tree in its own process, in the order A, B, B, A, each through
that tree's own `chip_smoke.py` measurement functions (its wrappers, its
kernels, built from its sources into its own `build/`), with one timing
rule for both: 10 warm-up calls, then CUDA events around the timed calls.
Prints the card's name and power limit, then one JSON line per run: K7 at
the main path's ship batch (8 rows, 32,768 + 256), K15 and its join form
at four islands of 2,500,000 rows on the one card (k 25,000, Q 1), K1 at
10,000,000 rows, K10 at 10,000,000 rows in chunks of 8,192 and K18 at
10,000,000 rows: `ms` (bare launches) and `wrapper_ms` of each, and for
K7 and K15 also `device_ms` and `wrapper_device_ms`, the device's own time
of 20 bare launches and of 20 wrapper calls under `torch.profiler`, a
call, measured here the same way for both trees.
"""

from __future__ import annotations

import inspect
import json
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


def _mesh_bare(dev, n_isl, width, k, join, gen, cs):
    """The tree's bare mesh-scan launches and wrapper call at four islands
    of `width` rows on `dev`: the island-table API (islands, groups,
    bounds per device, partials per device) or the parent's per-island one
    (islands, bounds per island, partials per island)."""
    import torch
    from repro_torch.kernels import dict_ops
    f, a, j, fv, jv, ad, rc = cs.scan_inputs(gen, n_isl * width, k, k, k,
                                             dev, invalid=0.0)
    fi, ai, ji, fvi, jvi = cs.mesh_islands((f, a, j, fv, jv),
                                           [width] * n_isl)
    span = 3 * k // 10
    bounds = [(k // 2, k // 2 + span)]
    islands = [(fi[s], ai[s], fvi[s].view(torch.uint8), ad) + (
        (ji[s], jvi[s].view(torch.uint8), rc) if join else ())
        for s in range(n_isl)]
    barr = torch.tensor(bounds, dtype=torch.int32, device=dev)
    lanes = 3 if join else 2
    launch = dict_ops.launch_scan_exact_mesh
    if len(inspect.signature(launch).parameters) == 4:
        groups = dict_ops.mesh_launch_groups([dev] * n_isl, [width] * n_isl)
        outs = {dev: torch.zeros((lanes, 1), dtype=torch.int64, device=dev)}

        def bare():
            launch(islands, groups, {dev: barr}, outs)
    else:
        outs = [torch.zeros((lanes, 1), dtype=torch.int64, device=dev)
                for _ in range(n_isl)]

        def bare():
            launch(islands, [barr] * n_isl, outs)
    extra = (ji, jvi, [rc] * n_isl) if join else ()
    args = (fi, ai, fvi, [ad] * n_isl, bounds) + extra

    def wrapper():
        dict_ops.scan_exact_mesh(*args)
    return bare, wrapper


def _one(root: str) -> dict:
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
    if hasattr(cs, "device_time"):      # not timed twice: this script's own
        cs.device_time = lambda fn, reps=20: {}
    cs.phase_build()
    from repro_torch.kernels.bitonic_sort import (apply_pipeline_batch,
                                                  launch_bitonic_apply)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    keys = ("ms", "wrapper_ms")
    out = {"tree": root}

    shape = (8, 32768, 256)
    m = cs.measure_apply(gen, dev, shape)
    old, val = cs.apply_stacks(gen, dev, 8, 24576, 32768, 192, 256)
    svals, merged = apply_pipeline_batch(old, val)
    out["apply"] = dict(
        {k: m[k] for k in keys}, shape=list(shape),
        device_ms=_device_ms(lambda: launch_bitonic_apply(old, val, svals,
                                                          merged)),
        wrapper_device_ms=_device_ms(lambda: apply_pipeline_batch(old, val)))

    for join in (False, True):
        name = "mesh_join" if join else "mesh"
        shape = (4, 2_500_000, 25_000) + ((25_000,) if join else ()) + (1,)
        m = cs.measure_scan_mesh(gen, dev, shape, join)
        bare, wrapper = _mesh_bare(dev, 4, 2_500_000, 25_000, join, gen, cs)
        out[name] = dict({k: m[k] for k in keys}, shape=list(shape),
                         device_ms=_device_ms(bare),
                         wrapper_device_ms=_device_ms(wrapper))

    m = cs.measure_scan(gen, dev, (10_000_000, 25_000, 1), False)
    out["scan"] = {k: m[k] for k in keys}
    m = cs.measure_snapshot(gen, dev, (10_000_000, 8192))
    out["snapshot_copy"] = {k: m[k] for k in keys}
    m = cs.measure_float_scan(gen, dev, (10_000_000, 25_000))
    out["scan_float"] = {k: m[k] for k in keys}
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) == 2 and argv[0] == "--one":
        print(json.dumps(_one(argv[1])), flush=True)
        return 0
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    a, b = argv
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip(),
          flush=True)
    for root in (a, b, b, a):
        run = subprocess.run([sys.executable, __file__, "--one", root],
                             capture_output=True, text=True)
        lines = [l for l in run.stdout.splitlines() if l.startswith("{")]
        if run.returncode or not lines:
            print(run.stdout[-2000:], run.stderr[-4000:], file=sys.stderr)
            return 1
        print(lines[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
