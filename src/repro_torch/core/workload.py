"""Workload chunking for the session-based HTAP API.

The batch runners (core/htap.py) split a pre-generated workload into
``n_rounds`` uniform rounds; an `HTAPSession` (core/session.py) accepts the
same chunks — or any other contiguous chunking — incrementally. Both paths
share the splitters here.

The arrival-process half models an *open* system: multiple synthetic
clients issue analytical queries at seeded stochastic rates while the
transactional stream commits at a fixed rate, producing one deterministic
interleaved schedule. That schedule is what the batch API could never
express — queries land at arbitrary positions inside the update stream,
not at uniform round boundaries — and `htap.run_mixed_traffic` serves it
through the session surface.
"""

from __future__ import annotations

import dataclasses

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


# ---------------------------------------------------------------------------
# Mixed-traffic arrival process (the open-system serve scenario)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class QueryArrival:
    """One client's analytical query arriving mid-stream.

    ``position`` is the number of transactional commits that have executed
    when the query arrives — the visibility point the session must honor.
    """

    time: float      # arrival time (seconds on the synthetic clock)
    client: int      # which synthetic query client issued it
    position: int    # txn-stream position: commits executed before arrival
    query: object    # engine.Query


def mixed_traffic_schedule(rng: np.random.Generator,
                           queries_per_client: list[list],
                           n_txn: int,
                           txn_rate: float,
                           query_rates: list[float]) -> list[QueryArrival]:
    """Seeded multi-client arrival schedule over a transactional stream.

    The txn stream commits uniformly at ``txn_rate`` commits/s, fixing a
    horizon of ``n_txn / txn_rate`` seconds. Client ``c`` issues its queries
    (in list order) with exponential inter-arrival times at rate
    ``query_rates[c]``; arrivals past the horizon are dropped (the run is
    over). The merged schedule is sorted by arrival time with (time,
    client) ties broken deterministically, so a fixed seed yields a fixed
    interleaving.
    """
    if len(queries_per_client) != len(query_rates):
        raise ValueError(
            f"{len(queries_per_client)} query clients but "
            f"{len(query_rates)} arrival rates")
    if txn_rate <= 0:
        raise ValueError(f"txn_rate must be > 0, got {txn_rate}")
    horizon = n_txn / txn_rate
    arrivals: list[QueryArrival] = []
    for client, (qs, rate) in enumerate(zip(queries_per_client, query_rates)):
        if rate <= 0:
            raise ValueError(f"client {client}: query rate must be > 0, "
                             f"got {rate}")
        # one exponential draw per query, in client order, from the shared
        # generator: the schedule is a pure function of (rng seed, inputs)
        gaps = rng.exponential(1.0 / rate, size=len(qs))
        t = 0.0
        for q, gap in zip(qs, gaps):
            t += float(gap)
            if t > horizon:
                break
            position = min(n_txn, int(t * txn_rate))
            arrivals.append(QueryArrival(time=t, client=client,
                                         position=position, query=q))
    arrivals.sort(key=lambda a: (a.time, a.client))
    return arrivals


def arrival_batches(arrivals: list[QueryArrival]
                    ) -> list[tuple[int, list[QueryArrival]]]:
    """Group a sorted schedule by txn-stream position.

    Returns ``[(position, [arrivals at that position])...]`` in position
    order — the unit the serve driver executes: advance the txn stream to
    ``position``, then answer that batch's queries against the data
    visible there.
    """
    batches: list[tuple[int, list[QueryArrival]]] = []
    for a in arrivals:
        if batches and batches[-1][0] == a.position:
            batches[-1][1].append(a)
        else:
            batches.append((a.position, [a]))
    return batches
