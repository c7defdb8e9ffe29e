"""mfu.whisper: model flops of whisper's training steps / (their seconds x
989 TFLOP/s, the H100's dense bf16 peak), in %, over the traced run's
steps after its profiled stretch, which run as an untraced run's do (no
profiler, no synchronizes). The flops are the benchmark's own count from
the configuration and the traffic (`whisper_yardstick.train_flops`): 6 a
matmul parameter a position (mel frames for the first convolution,
encoder positions for the second, the encoder's layers and the cross K/V,
tokens for the rest of the decoder and the tied head) and 12 dh a
(query, key) pair and head of the three attentions; a remat's recompute
is not counted. The card's power limit is in the result's device
fields."""

from bench import whisper_yardstick, yardstick


def read(run):
    steps, seconds = run.counts.get("clean_steps"), run.counts.get("clean_s")
    cell = run.cell
    if not steps or not seconds or cell is None:
        return None
    flops = steps * whisper_yardstick.train_flops(cell.config, cell.traffic)
    return 100.0 * flops / (seconds * yardstick.BF16_FLOPS_PER_S)
