#!/usr/bin/env python3
"""Times the kernels that recent changes redesigned, and the scans beside
them as controls, of two checkouts in turns on one card, so that a change
is compared with its parent under the same clocks and host.

    git archive <parent> | tar -x -C build/parent
    python3 chip_compare.py build/parent .      # needs one Hopper card

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
snapshot copy K10 (chunks of 8,192): `ms` (bare launches), `device_ms`
(the device's own time of 20 bare launches under `torch.profiler`, a
launch, by the tree's own `device_time`) and `wrapper_ms` of each, and for
K7 and K15 also `wrapper_device_ms`, the device time of 20 wrapper calls,
a call, measured here the same way for both trees; where the run built the
tree's library, ptxas' registers and spill bytes of its scan kernels
(`ptxas`).
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
    cs.phase_build()
    from repro_torch.kernels.bitonic_sort import apply_pipeline_batch
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    keys = ("ms", "device_ms", "wrapper_ms")
    out = {"tree": root}

    shape = (8, 32768, 256)
    m = cs.measure_apply(gen, dev, shape)
    old, val = cs.apply_stacks(gen, dev, 8, 24576, 32768, 192, 256)
    out["apply"] = dict(
        {k: m[k] for k in keys}, shape=list(shape),
        wrapper_device_ms=_device_ms(lambda: apply_pipeline_batch(old, val)))

    for join in (False, True):
        name = "mesh_join" if join else "mesh"
        shape = (4, 2_500_000, 25_000) + ((25_000,) if join else ()) + (1,)
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
    # ptxas' registers and spill bytes of the scans' kernels, where this
    # process built the tree's library
    out["ptxas"] = {re.sub(r"^_ZN\w*?_cu_\w{8}\d+", "", e):
                    [r, cs.SPILLS.get(e, 0)]
                    for e, r in cs.REGISTERS.items() if "scan" in e}
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
