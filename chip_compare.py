#!/usr/bin/env python3
"""Times flash-decode (K16) and the bucket probe (K8) of two checkouts in
turns on one card, so that a change is compared with its parent under the
same clocks and host.

    git archive <parent> | tar -x -C build/parent
    python3 chip_compare.py build/parent .      # needs one Hopper card

Runs each tree in its own process, in the order A, B, B, A, each through
that tree's own `chip_smoke.py` measurement functions (its wrappers, its
kernels, built from its sources into its own `build/`), with one timing
rule for both: 10 warm-up calls, then CUDA events around the timed calls.
Prints the card's name and power limit, then one JSON line per run:
K16 at the serving path's shape (B 4, S 4096, H 16, Hkv 8, d 256, length
287) and at `decode_32k` (length 32768), kimi-k2's d 112 where the tree
takes it, and K8 at 32 queries in a 64 x 4 table; `ms` (bare launches),
`wrapper_ms` and `library_ms` (SDPA, `torch.searchsorted`) of each.
"""

from __future__ import annotations

import json
import subprocess
import sys


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
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    keys = ("ms", "wrapper_ms", "library_ms")
    out = {"tree": root}
    for name, shape in (("path", (4, 4096, 16, 8, 256, 287)),
                        ("decode_32k", (4, 32768, 16, 8, 256, 32768)),
                        ("decode_32k_d112", (4, 32768, 64, 8, 112, 32768))):
        try:
            m = cs.measure_decode(gen, dev, shape)
        except ValueError as err:             # a head_dim the tree refuses
            out[name] = {"refused": str(err)}
            continue
        out[name] = {k: m[k] for k in keys}
    m = cs.measure_probe(gen, dev, (1, 32, 64, 4))
    out["probe"] = {k: m[k] for k in keys}
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
