"""optimizer_ms.train: the median over the traced stretch's steps of the
stream time of AdamW's update, between the two CUDA events of the
program's `train.optimizer` span, in ms; None without a card."""

from bench import program_trace


def read(run):
    return program_trace.device_ms_median(run, "train.optimizer")
