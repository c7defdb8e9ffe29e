"""mfu.train: model flops of training steps / (their seconds x 989 TFLOP/s,
the H100's dense bf16 peak), in %, over the traced run's steps after its
profiled stretch, which run as an untraced run's do (no profiler, no
synchronizes). The flops are the benchmark's own count from the
configuration (`yardstick.mamba_train_flops`): 6 a matmul parameter a
token, the selective scan's and the convolution's own work; a remat's
recompute is not counted. The card's power limit is in the result's
device fields."""

from bench import yardstick


def read(run):
    steps, seconds = run.counts.get("clean_steps"), run.counts.get("clean_s")
    cfg = run.cell.config if run.cell else None
    if not steps or not seconds or cfg is None:
        return None
    flops = steps * yardstick.mamba_train_flops(
        cfg, run.counts["tokens_per_step"])
    return 100.0 * flops / (seconds * yardstick.BF16_FLOPS_PER_S)
