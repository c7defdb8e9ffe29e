"""query_rate: queries answered in the window / the window's seconds."""


def read(run):
    n = run.counts.get("queries")
    return n / run.window_s if n else None
