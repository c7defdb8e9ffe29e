"""mfu.jamba: model flops of Jamba's training steps / (their seconds x 989
TFLOP/s, the H100's dense bf16 peak), in %, over the traced run's steps
after its profiled stretch, which run as an untraced run's do (no
profiler, no synchronizes). The flops are the benchmark's own count from
the configuration and the traffic (`jamba_yardstick.train_flops`): 6 a
matmul parameter a token (every layer's projections and MLP, and the
head, which is the tied embedding, once) and 12 dh a (query, key) pair in
the causal band and query head of the attention layers; a remat's
recompute is not counted. The card's power limit is in the result's
device fields."""

from bench import jamba_yardstick, yardstick


def read(run):
    steps, seconds = run.counts.get("clean_steps"), run.counts.get("clean_s")
    cell = run.cell
    if not steps or not seconds or cell is None:
        return None
    flops = steps * jamba_yardstick.train_flops(cell.config, cell.traffic)
    return 100.0 * flops / (seconds * yardstick.BF16_FLOPS_PER_S)
