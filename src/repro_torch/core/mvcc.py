"""MVCC baseline (§3.1): per-tuple version chains with timestamps.

Functional semantics are exact and fully vectorized: the version store is
the commit-ordered write stream itself; a read at snapshot-timestamp ts
returns, per cell, the newest version with commit_id <= ts (else the base
value). The *cost* of a read reproduces the paper's bottleneck — newest-
first chain traversal: an analytical query arriving at ts pays
(1 + #versions newer than ts on that cell) random accesses per touched
tuple, which grows as transactions accumulate (Fig. 1-left).
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.hwmodel import CostLog
from repro_torch.core.nsm import RowStore
from repro_torch.core.schema import UpdateStream, VALUE_BYTES

VERSION_ENTRY_BYTES = 24  # ts + value + next-pointer
CPU_CYCLES_PER_HOP = 12.0   # pointer chase + timestamp compare (cache-missing)
CPU_CYCLES_PER_BASE = 3.0   # in-line version check on the tuple itself


class MVCCStore:
    """Single-instance store with per-cell version chains."""

    def __init__(self, base_table: np.ndarray):
        self.base = np.array(base_table, dtype=np.int32, copy=True)
        n_rows, n_cols = base_table.shape
        # Version log (columnar): commit-ordered writes.
        self.v_ts = np.empty(0, dtype=np.int64)
        self.v_row = np.empty(0, dtype=np.int64)
        self.v_col = np.empty(0, dtype=np.int32)
        self.v_val = np.empty(0, dtype=np.int32)

    @property
    def n_versions(self) -> int:
        return len(self.v_ts)

    def execute(self, stream: UpdateStream, cost: CostLog | None = None) -> None:
        """Append versions for every write (never blocks readers)."""
        w = stream.writes_mask()
        self.v_ts = np.concatenate([self.v_ts, stream.commit_id[w]])
        self.v_row = np.concatenate([self.v_row, stream.row[w]])
        self.v_col = np.concatenate([self.v_col, stream.col[w]])
        self.v_val = np.concatenate([self.v_val, stream.value[w]])
        if cost is not None:
            n = len(stream)
            cost.add(phase="txn", island="txn", resource="cpu",
                     cycles=n * RowStore.CYCLES_PER_TXN * 1.1,  # + version alloc
                     bytes_offchip=n * self.base.shape[1] * VALUE_BYTES
                     * RowStore.MISS_FRACTION
                     + int(w.sum()) * VERSION_ENTRY_BYTES)

    def read_column_at(self, col: int, ts: int,
                       cost: CostLog | None = None,
                       count_hops: bool = True) -> np.ndarray:
        """Snapshot read of a full column at timestamp ts (analytical scan)."""
        sel = self.v_col == col
        rows, tss, vals = self.v_row[sel], self.v_ts[sel], self.v_val[sel]
        out = self.base[:, col].copy()
        vis = tss <= ts
        if vis.any():
            r, t, v = rows[vis], tss[vis], vals[vis]
            order = np.lexsort((t, r))           # by row, then ts ascending
            r, v = r[order], v[order]
            last = np.flatnonzero(np.r_[r[1:] != r[:-1], True])  # newest per row
            out[r[last]] = v[last]
        if cost is not None:
            n_rows = self.base.shape[0]
            # Newest-first traversal: hops past every version newer than ts.
            # count_hops=False is the zero-cost-MVCC normalization baseline
            # (base column access still paid).
            newer = tss > ts
            hops = float(newer.sum()) if count_hops else 0.0
            cost.add(phase="ana", island="ana", resource="cpu",
                     cycles=n_rows * CPU_CYCLES_PER_BASE
                     + hops * CPU_CYCLES_PER_HOP,
                     bytes_offchip=n_rows * 0.3 * 8.0          # tuple header
                     + hops * VERSION_ENTRY_BYTES)             # chain entries
        return out
