"""flush_ms.ana: median wall time of `HTAPSession.flush_updates()`, called
by the harness just before `query_batch` in the traced run, between
synchronizes."""


def read(run):
    return run.spans.median_ms("flush_updates")
