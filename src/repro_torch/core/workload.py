"""Workload chunking for the session-based HTAP API.

The batch runners (core/htap.py) split a pre-generated workload into
``n_rounds`` uniform rounds; an `HTAPSession` (core/session.py) accepts the
same chunks — or any other contiguous chunking — incrementally. Both paths
share the splitters here. The open-system arrival processes
(`mixed_traffic_schedule`, `arrival_batches`) come with the mixed-traffic
serving slice (ROADMAP.md queue 1).
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.schema import UpdateStream


def slice_stream(stream: UpdateStream, lo: int, hi: int) -> UpdateStream:
    """Contiguous sub-stream [lo, hi) — commit order is preserved."""
    s = slice(lo, hi)
    return UpdateStream(stream.thread_id[s], stream.commit_id[s],
                        stream.op[s], stream.row[s], stream.col[s],
                        stream.value[s])


def split_stream(stream: UpdateStream, n_rounds: int) -> list[UpdateStream]:
    """Split a commit-ordered stream into ``n_rounds`` contiguous chunks.

    Chunk sizes differ by at most one entry; when ``n_rounds`` exceeds the
    stream length some chunks are empty (a round with no transactions is
    legal — the runners still open its round on the timeline).
    """
    if n_rounds < 1:
        raise ValueError(f"n_rounds must be >= 1, got {n_rounds}")
    bounds = np.linspace(0, len(stream), n_rounds + 1).astype(int)
    return [slice_stream(stream, bounds[r], bounds[r + 1])
            for r in range(n_rounds)]


def split_queries(queries: list, n_rounds: int) -> list[list]:
    """Split a query list into ``n_rounds`` contiguous chunks (see
    `split_stream`; empty chunks appear when n_rounds > len(queries))."""
    if n_rounds < 1:
        raise ValueError(f"n_rounds must be >= 1, got {n_rounds}")
    bounds = np.linspace(0, len(queries), n_rounds + 1).astype(int)
    return [queries[bounds[r]:bounds[r + 1]] for r in range(n_rounds)]
