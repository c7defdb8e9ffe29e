"""pipeline_ms.train: median wall time a step of the token pipeline's
`propagate` plus `get_batch`, between synchronizes, in the traced run."""


def read(run):
    return run.spans.median_ms("pipeline")
