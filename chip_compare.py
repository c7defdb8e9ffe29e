#!/usr/bin/env python3
"""Times the selective scan (K17), the merge unit (K5), flash-decode (K16)
and the bucket probe (K8) of two checkouts in turns on one card, so that a
change is compared with its parent under the same clocks and host.

    git archive <parent> | tar -x -C build/parent
    python3 chip_compare.py build/parent .      # needs one Hopper card

Runs each tree in its own process, in the order A, B, B, A, each through
that tree's own `chip_smoke.py` measurement functions (its wrappers, its
kernels, built from its sources into its own `build/`), with one timing
rule for both: 10 warm-up calls, then CUDA events around the timed calls.
Prints the card's name and power limit, then one JSON line per run:
K17 at falcon-mamba-7b's prefill (B 4, T 2048, D 8192, N 16), with its
source compiled alone: ptxas' registers and spill bytes of each instance
and the SASS opcode counts of the d_state 16 ones (`cuobjdump`); K5 as a
ship batch calls it, `merge_sorted_runs` over four runs of 256 int64 keys
on the card, with its launches a call and `torch.sort(cat, stable=True)`
beside it; K16 at
the serving path's shape (B 4, S 4096, H 16, Hkv 8, d 256, length 287)
and at `decode_32k` (length 32768), kimi-k2's d 112 where the tree takes
it, and K8 at 32 queries in a 64 x 4 table; `ms` (bare launches),
`wrapper_ms` and `library_ms` of each.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys


def _scan_report(root: str) -> dict:
    """The tree's `selective_scan.cu` compiled alone to a cubin: ptxas'
    registers and spill bytes of each instance, and for the d_state 16
    instances with 16-byte staging the SASS opcode counts (`cuobjdump`):
    all instructions, MUFU (one an exponential) and the FP32 multiplies,
    fused multiply-adds and adds."""
    import os
    import pathlib
    import tempfile
    from repro_torch.kernels import build
    nvcc = build._nvcc()
    src = pathlib.Path(root) / "src/repro_torch/kernels/csrc/selective_scan.cu"
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        cubin = os.path.join(tmp, "scan.cubin")
        log = subprocess.run(
            [nvcc, *build.NVCC_FLAGS, "-Xptxas", "-v", "-cubin", "-o", cubin,
             str(src)], check=True, capture_output=True, text=True)
        entry = None
        for line in (log.stdout + log.stderr).splitlines():
            m = re.search(r"Compiling entry function '.*?selective_scan_"
                          r"kernelI(\w+?)EEv", line)
            if m:
                entry = m.group(1)
            elif entry and "spill stores" in line:
                out.setdefault(entry, {})["spill_bytes"] = sum(
                    int(w) for w in re.findall(r"(\d+) bytes spill", line))
            elif entry and "Used" in line:
                out.setdefault(entry, {})["registers"] = int(
                    line.split("Used ")[1].split()[0])
        sass = subprocess.run(
            [os.path.join(os.path.dirname(nvcc), "cuobjdump"), "-sass",
             cubin], check=True, capture_output=True, text=True).stdout
    for body in sass.split("Function : ")[1:]:
        m = re.match(r"\S*selective_scan_kernelI(\w+?)EEv", body)
        if not m or not m.group(1).startswith("Li16E") or \
                m.group(1).endswith("Lb0"):
            continue
        ops = re.findall(
            r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9]+)", body)
        out.setdefault(m.group(1), {}).update(
            sass=len(ops), mufu=ops.count("MUFU"),
            fp32=sum(ops.count(o) for o in ("FMUL", "FFMA", "FADD")))
    return out


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
    from repro_torch.kernels.common import (kernel_launch_counts,
                                            reset_kernel_launch_counts)
    from repro_torch.kernels.merge_runs import merge_sorted_runs
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    keys = ("ms", "wrapper_ms", "library_ms")
    out = {"tree": root}
    m = cs.measure_ssm(gen, dev, (4, 2048, 8192, 16))
    out["selective_scan"] = dict(
        {k: m.get(k) for k in ("ms", "wrapper_ms", "max_abs_err")},
        instances=_scan_report(root))
    runs = [torch.sort(torch.randint(0, 2**40, (256,), generator=gen,
                                     device=dev)).values for _ in range(4)]
    cat = torch.cat(runs)
    reset_kernel_launch_counts()
    merge_sorted_runs(runs)
    launches = kernel_launch_counts().get("merge_runs", 0)
    out["merge_ship"] = dict(
        launches_a_call=launches,
        wrapper_ms=time_ms(lambda: merge_sorted_runs(runs), 200),
        library_ms=time_ms(lambda: torch.sort(cat, stable=True), 200))
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
