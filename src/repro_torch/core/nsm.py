"""NSM (row-store) transactional replica and per-thread update logs (§4, §5.1).

The transactional island executes queries against the row store and appends
each committed write to its thread's *ordered update log*. Log entries carry
(commit_id, type, data, record key) exactly as in the paper. Shipping is
triggered when the total number of pending updates reaches the final-log
capacity (1024 entries, §5.1/§5.2).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.schema import UpdateStream, VALUE_BYTES, LOG_ENTRY_BYTES
from repro_torch.core.hwmodel import CostLog

# Structured dtype for update-log entries (paper §5.1's four fields).
UPDATE_DTYPE = np.dtype([
    ("commit_id", np.int64),
    ("op", np.int8),        # 1=modify, 2=insert, 3=delete
    ("value", np.int32),    # updated data
    ("row", np.int64),      # record key: (row, col)
    ("col", np.int32),
])


def make_entries(commit_id, op, value, row, col) -> np.ndarray:
    out = np.empty(len(commit_id), dtype=UPDATE_DTYPE)
    out["commit_id"] = commit_id
    out["op"] = op
    out["value"] = value
    out["row"] = row
    out["col"] = col
    return out


@dataclasses.dataclass
class UpdateLog:
    """One transactional thread's ordered update log."""

    thread_id: int
    entries: list[np.ndarray] = dataclasses.field(default_factory=list)

    def append(self, batch: np.ndarray) -> None:
        if len(batch):
            self.entries.append(batch)

    def drain(self) -> np.ndarray:
        if not self.entries:
            return np.empty(0, dtype=UPDATE_DTYPE)
        out = np.concatenate(self.entries)
        self.entries.clear()
        return out

    def drain_until(self, cutoff_commit_id: int) -> np.ndarray:
        """Drain entries with commit_id <= cutoff (a prefix: the log is
        commit-ordered); the remainder stays pending."""
        batch = self.drain()
        keep = batch["commit_id"] <= cutoff_commit_id
        self.append(batch[~keep])
        return batch[keep]

    @property
    def pending(self) -> int:
        return sum(len(e) for e in self.entries)


class RowStore:
    """The transactional island's NSM replica.

    Rows are stored contiguously (row-major), the layout that gives
    update-intensive queries locality (§3.1-(2)). Execution is vectorized
    over pre-generated query streams; per-query costs are priced into the
    CostLog with the paper's observed characteristics (short, cache-friendly,
    latency-sensitive).
    """

    # Modeled per-query CPU cost of a short transactional query (B-tree probe
    # + tuple touch + logging), calibrated so an isolated txn-only run on the
    # HMC CPU island lands in the DBx1000-class millions-of-txn/s regime.
    CYCLES_PER_TXN = 600.0
    # Fraction of touched row bytes that miss the cache and cross the channel.
    MISS_FRACTION = 0.35

    def __init__(self, table: np.ndarray, n_threads: int = 4):
        self.data = np.array(table, dtype=np.int32, copy=True)
        self.n_threads = n_threads
        self.logs = [UpdateLog(t) for t in range(n_threads)]

    @property
    def n_rows(self) -> int:
        return int(self.data.shape[0])

    @property
    def n_cols(self) -> int:
        return int(self.data.shape[1])

    @property
    def pending_updates(self) -> int:
        return sum(log.pending for log in self.logs)

    def execute(self, stream: UpdateStream, cost: CostLog | None = None) -> None:
        """Apply a stream of transactional queries to the row store.

        Writes are applied in commit order and appended to per-thread logs.
        Reads only contribute cost. Vectorized: later writes to the same
        cell win (matches sequential application because commit_id is the
        stream order).
        """
        w = stream.writes_mask()
        rows, cols, vals = stream.row[w], stream.col[w], stream.value[w]
        # numpy assigns duplicate indices in order -> last write wins, as in
        # sequential commit order.
        self.data[rows, cols] = vals
        for t in range(self.n_threads):
            m = w & (stream.thread_id == t)
            self.logs[t].append(
                make_entries(stream.commit_id[m], stream.op[m], stream.value[m],
                             stream.row[m], stream.col[m])
            )
        if cost is not None:
            n = len(stream)
            row_bytes = self.n_cols * VALUE_BYTES
            touched = n * row_bytes
            cost.add(
                phase="txn", island="txn", resource="cpu",
                cycles=n * self.CYCLES_PER_TXN,
                bytes_offchip=touched * self.MISS_FRACTION
                + int(w.sum()) * LOG_ENTRY_BYTES,
            )

    def drain_logs(self, limit: int | None = None) -> list[np.ndarray]:
        """Hand the per-thread logs (each internally commit-ordered) to shipping.

        ``limit`` caps the batch at the final log's capacity (§5.1): the
        globally-oldest ``limit`` updates by commit id are drained (so the
        merged final log never exceeds its hardware size) and the rest stay
        pending for the next ship. Application order — global commit order —
        is unchanged, so batching granularity never alters query answers;
        it only moves the commit-to-visibility freshness the timeline
        model measures.
        """
        if limit is None or self.pending_updates <= limit:
            return [log.drain() for log in self.logs]
        cids = np.concatenate([e["commit_id"] for log in self.logs
                               for e in log.entries])
        cutoff = int(np.partition(cids, limit - 1)[limit - 1])
        return [log.drain_until(cutoff) for log in self.logs]
