"""query_p95_ms: the 95th percentile (linear interpolation), over every
query answered in the window, of the time from the `query_batch` call that
holds the query to the return of its answers."""

import numpy as np


def read(run):
    lat = run.latencies_s.get("query")
    return float(np.percentile(lat, 95)) * 1e3 if lat else None
