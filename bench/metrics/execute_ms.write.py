"""execute_ms.write: median wall time of a round's `HTAPSession.execute`
(the txn island and the ship batches and applies it runs inline), between
synchronizes, in the traced run."""


def read(run):
    return run.spans.median_ms("execute")
