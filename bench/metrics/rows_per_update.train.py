"""rows_per_update.train: the token pipeline's write amplification over
the traced stretch: the rows apply stage 3 rewrites
(`apply.rows_rewritten`) plus the rows the snapshot copies
(`snapshot.rows_copied`), over the updates applied (`apply.updates`), from
the program's counters (`bench/program_trace.py`)."""

from bench import program_trace


def read(run):
    c = program_trace.counts(program_trace.stretch(run))
    if not c.get("apply.updates"):
        return None
    return (c.get("apply.rows_rewritten", 0)
            + c.get("snapshot.rows_copied", 0)) / c["apply.updates"]
