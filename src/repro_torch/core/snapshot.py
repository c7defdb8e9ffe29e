"""Full-copy snapshotting baseline (§3.1): SI-SS.

Software snapshotting (Šidlauskas et al. [70] style): before a batch of
analytical queries runs, if the data is dirty, memcpy the (queried part of
the) table into a snapshot; analytics run on the copy while transactions
continue on the live data. The memcpy crosses the CPU<->memory channel
twice and burns CPU cycles on the transactional island — the source of the
43.4%-74.6% txn-throughput drops in Fig. 1-right.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.hwmodel import CostLog

MEMCPY_CYCLES_PER_BYTE = 0.25  # vectorized CPU memcpy


class SnapshotStore:
    """Single-instance NSM store with on-demand full snapshots."""

    def __init__(self, base_table: np.ndarray):
        self.data = np.array(base_table, dtype=np.int32, copy=True)
        self.snapshot: np.ndarray | None = None
        self.dirty = True
        self.snapshots_taken = 0

    def mark_dirty(self) -> None:
        self.dirty = True

    def take_snapshot_if_needed(self, cost: CostLog | None = None) -> np.ndarray:
        """Create a snapshot only when dirty data exists (§8)."""
        if self.dirty or self.snapshot is None:
            self.snapshot = self.data.copy()
            self.dirty = False
            self.snapshots_taken += 1
            if cost is not None:
                nbytes = self.data.nbytes
                cost.add(phase="snapshot", island="txn", resource="cpu",
                         cycles=nbytes * MEMCPY_CYCLES_PER_BYTE,
                         bytes_offchip=2 * nbytes)
        return self.snapshot
