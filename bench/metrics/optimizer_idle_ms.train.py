"""optimizer_idle_ms.train: device idle time a step while the host was
inside the train step's `train.optimizer` span (AdamW's update), in ms,
over the traced stretch (`bench/program_trace.py`)."""

from bench import program_trace


def read(run):
    return program_trace.idle_ms_per_step(run, "train.optimizer")
