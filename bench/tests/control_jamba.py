"""The Jamba training cell's control and faults, run outside the benchmark's
own runs, at the cell's own size.

The control is the reference put in the program's place in the nearest
precision below the configuration's bfloat16: float8 (e4m3, a scale a
tensor) for every matrix product's operands, attention's and the tied
head's too (``--fault fp8``). ``--fault half_batch`` puts the reference on
the first half of each step's tokens alone in the program's place (the
cell's batch is one sequence). Their readings are the gaps the cell's
check computes (`jamba_lm.compare`) against the float32 reference on the
same weights and batches, judged by the cell's own checks of them
(`jamba_train.gap_checks`: ``failed`` names those past their limits).
``--fault dropped_write_back`` runs the cell itself with AdamW's new
weights never written back into the parameters, and prints its checks.

    python3 -m bench.tests.control_jamba --seeds 11,12,13 [--fault ...]

from the root of a checkout, on a card, prints one JSON line a seed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import types

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
WORKLOAD = "jamba2-3b-train-32k"


def half_batches(batches: list) -> list:
    """Each (tokens, labels) cut to the first half of its positions."""
    return [(t[:, :t.shape[1] // 2], l[:, :l.shape[1] // 2])
            for t, l in batches]


def control_gaps(seed: int, config: dict, traffic: dict, device,
                 fault: str = "fp8") -> dict:
    """The gaps of the control (``fp8``) or of the half-batch fault
    against the float32 reference."""
    from bench.drivers.lm_train import reference_batches
    from bench.reference import jamba_lm
    job = config["job"]
    n = int(job["reference_steps"])
    cell = types.SimpleNamespace(seed=seed, config=config, traffic=traffic)
    batches = reference_batches(cell, n)
    if fault == "fp8":
        got = jamba_lm.train(seed, config, job, batches, device, "fp8",
                             keep_grads=True)
    elif fault == "half_batch":
        got = jamba_lm.train(seed, config, job, half_batches(batches),
                             device, keep_grads=True)
    else:
        raise ValueError(fault)
    want = jamba_lm.train(seed, config, job, batches, device,
                          against=got.pop("grads"))
    return jamba_lm.compare(got, want)


def main() -> int:
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, ROOT)
    import torch
    from bench import harness
    from bench.drivers.jamba_train import gap_checks
    from bench.tests.control_whisper import dropped_write_back
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--fault", default="fp8",
                    choices=("fp8", "half_batch", "dropped_write_back"))
    ap.add_argument("--seconds", type=float, default=10.0,
                    help="the window of a dropped_write_back run")
    args = ap.parse_args()
    bench = harness.load_benchmark()
    _, config, traffic = harness.load_cell(bench, WORKLOAD)
    for s in args.seeds.split(","):
        t0 = time.perf_counter()
        if args.fault == "dropped_write_back":
            run = harness.run_cell(WORKLOAD, int(s), args.seconds, False,
                                   t0, hooks={"train_step":
                                              dropped_write_back})
            checks = run.checks
            got = {c.name: c.value for c in checks}
        else:
            got = control_gaps(int(s), config, traffic,
                               torch.device("cuda", 0), args.fault)
            checks = gap_checks(got, config["job"]["limits"])
        got["failed"] = [c.name for c in checks if not c.ok]
        print(json.dumps({"seed": int(s), "fault": args.fault, **got,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
