"""txn_rate: transactions committed in the window / the window's seconds."""


def read(run):
    n = run.counts.get("txns")
    return n / run.window_s if n else None
