"""The training cell's control and faults, run outside the benchmark's own
runs.

The control is the reference put in the program's place in the nearest
precision below the configuration's bfloat16: float8 (e4m3, a scale a
tensor) for every matrix product's operands. Its readings are the same
gaps the cell's check computes (`mamba_lm.compare`), between the control's
first steps and the float32 reference's, on the same weights and batches.

    python3 -m bench.tests.control --seeds 11,12,13

from the root of a checkout, on a card, prints one JSON line a seed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import types

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def control_gaps(seed: int, config: dict, traffic: dict, device,
                 fault: str = "fp8") -> dict:
    """The gaps of the control (``fp8``) or of a fault planted in the
    reference put in the program's place (``half_batch``: each step's
    loss and gradient the mean over the batch's first half alone) against
    the float32 reference."""
    from bench.drivers.lm_train import reference_batches
    from bench.reference import mamba_lm
    job = config["job"]
    n = int(job["reference_steps"])
    cell = types.SimpleNamespace(seed=seed, config=config, traffic=traffic)
    batches = reference_batches(cell, n)
    want = mamba_lm.train(seed, config, job, batches, device, "float32")
    if fault == "fp8":
        got = mamba_lm.train(seed, config, job, batches, device, "fp8")
    elif fault == "half_batch":
        half = [(t[:len(t) // 2], l[:len(l) // 2]) for t, l in batches]
        got = mamba_lm.train(seed, config, dict(job, micro_batches=1), half,
                             device, "float32")
    else:
        raise ValueError(fault)
    return mamba_lm.compare(got, want)


def main() -> int:
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, ROOT)
    import torch
    from bench import harness
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--workload", default="fm7b-train")
    ap.add_argument("--fault", default="fp8", choices=("fp8", "half_batch"))
    args = ap.parse_args()
    bench = harness.load_benchmark()
    _, config, traffic = harness.load_cell(bench, args.workload)
    for s in args.seeds.split(","):
        gaps = control_gaps(int(s), config, traffic, torch.device("cuda", 0),
                            args.fault)
        print(json.dumps({"seed": int(s), "fault": args.fault, **gaps}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
