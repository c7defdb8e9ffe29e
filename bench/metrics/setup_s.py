"""setup_s: process start to the window's first timed operation (host clock)."""


def read(run):
    return run.setup_s
