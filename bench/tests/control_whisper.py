"""The whisper training cell's control and faults, run outside the
benchmark's own runs, at the cell's own size.

The control is the reference put in the program's place in the nearest
precision below the configuration's bfloat16: float8 (e4m3, a scale a
tensor) for every matrix product's operands, attention's too
(``--fault fp8``). ``--fault half_batch`` puts the reference on each
batch's first half alone in the program's place. Their readings are the
gaps the cell's check computes (`whisper_lm.compare`) against the float32
reference on the same weights, frames and batches. ``--fault
dropped_write_back`` runs the cell itself with AdamW's new weights never
written back into the parameters, and prints its checks.

    python3 -m bench.tests.control_whisper --seeds 11,12,13 [--fault ...]

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
WORKLOAD = "whisper-train"


def control_gaps(seed: int, config: dict, traffic: dict, device,
                 fault: str = "fp8") -> dict:
    """The gaps of the control (``fp8``) or of the half-batch fault
    against the float32 reference."""
    from bench.drivers.lm_train import reference_batches
    from bench.reference import whisper_lm
    job = config["job"]
    n = int(job["reference_steps"])
    cell = types.SimpleNamespace(seed=seed, config=config, traffic=traffic)
    batches = reference_batches(cell, n)
    frames = traffic["frames"]
    if fault == "fp8":
        got = whisper_lm.train(seed, config, job, batches, frames, device,
                               "fp8", keep_grads=True)
    elif fault == "half_batch":
        half = [(t[:len(t) // 2], l[:len(l) // 2]) for t, l in batches]
        got = whisper_lm.train(seed, config, dict(job, micro_batches=1),
                               half, frames, device, keep_grads=True)
    else:
        raise ValueError(fault)
    want = whisper_lm.train(seed, config, job, batches, frames, device,
                            against=got.pop("grads"))
    return whisper_lm.compare(got, want)


def dropped_write_back(step_fn):
    """AdamW's new weights never written back into the parameters: the
    masters move, the weights the forward reads stay as they were."""
    import torch

    def step(model, opt_state, s, batch):
        with torch.no_grad():
            held = [p.detach().clone() for p in model.parameters()]
        model, opt_state, out = step_fn(model, opt_state, s, batch)
        with torch.no_grad():
            for p, h in zip(model.parameters(), held):
                p.copy_(h)
        return model, opt_state, out
    return step


def main() -> int:
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, ROOT)
    import torch
    from bench import harness
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
        if args.fault == "dropped_write_back":
            run = harness.run_cell(WORKLOAD, int(s), args.seconds, False,
                                   time.perf_counter(),
                                   hooks={"train_step": dropped_write_back})
            got = {c.name: c.value for c in run.checks}
        else:
            got = control_gaps(int(s), config, traffic,
                               torch.device("cuda", 0), args.fault)
        print(json.dumps({"seed": int(s), "fault": args.fault, **got}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
