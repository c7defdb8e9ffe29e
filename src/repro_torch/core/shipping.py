"""Update shipping (§5.1): gather, merge, locate, ship.

Three stages, exactly as the paper:
  1. scan the per-thread update logs and merge into a single *final log*
     ordered by commit id (merge unit: FIFO queues + comparator tree;
     kernel analog: kernels/merge_runs),
  2. find each update's target column partition via a hash index on the
     (column, row) key,
  3. ship per-column buffers to the analytical replica (copy unit).

The logs are host records (the transactional island is the host); on the
accelerator backend the commit ids cross to the device for the merge and
the merged order comes back. The fixed-function units' throughputs are
priced into the CostLog. `on_pim=True` prices stages on the in-memory units
with vault-local traffic (Polynesia); `on_pim=False` prices them on the CPU
with off-chip traffic (the MI baseline, §3.2).
"""

from __future__ import annotations

import numpy as np

from repro_torch import tracing
from repro_torch.core.backend import get_backend, merge_update_logs_host
from repro_torch.core.hwmodel import CostLog
from repro_torch.core.schema import LOG_ENTRY_BYTES

# §5.1/§5.2: shipping triggers when pending updates reach the final-log
# capacity; the update-application sorter is sized to match (1024 values).
FINAL_LOG_CAPACITY = 1024

# Average probes per hash lookup (chain traversal). The paper sizes the hash
# table to the column partition so chains stay short.
AVG_PROBES = 1.3
# CPU cycles per merge comparison / per hash probe when run in software.
CPU_CYCLES_PER_CMP = 8.0
CPU_CYCLES_PER_PROBE = 24.0


def merge_logs(logs: list[np.ndarray]) -> np.ndarray:
    """Stage 1: k-way merge of commit-ordered per-thread logs.

    Each input log is already sorted by commit_id (a thread's commits are
    monotone); the merge produces the global total order. This is the
    functional reference (a stable sort of the concatenation); the hardware
    unit (and the CUDA kernel) exploit sortedness.
    """
    return merge_update_logs_host(logs)


def locate_columns(final_log: np.ndarray, n_cols: int) -> np.ndarray:
    """Stage 2: hash-index lookup of each update's target column partition.

    The paper hashes the (column,row) key with a modulo function. The
    functional result is simply the column id (partition map is
    column-granular under Strategy 3); the cost is in the probing.
    """
    return final_log["col"] % max(n_cols, 1)


def ship_updates(
    per_thread_logs: list[np.ndarray],
    n_cols: int,
    cost: CostLog | None = None,
    on_pim: bool = True,
    backend=None,
    price: bool = True,
) -> dict[int, np.ndarray]:
    """Run all three shipping stages; returns {col_id: commit-ordered entries}.

    Stage 1's k-way merge runs on the selected execution backend (the
    HopperBackend dispatches to kernels/merge_runs); stages 2-3 are
    host-side grouping either way.

    ``price=False`` suppresses the CostEvents (the Ideal baselines' free
    propagation) but still annotates the batch's timeline metadata.
    """
    with tracing.span("ship.merge"):
        merged = get_backend(backend).merge_update_logs(per_thread_logs)
    n = len(merged)
    buffers: dict[int, np.ndarray] = {}
    with tracing.span("ship.locate"):
        targets = locate_columns(merged, n_cols)
        if n:
            # group by column, keep commit order
            order = np.argsort(targets, kind="stable")
            sorted_log = merged[order]
            sorted_tgt = targets[order]
            splits = np.searchsorted(sorted_tgt, np.arange(n_cols))
            for c in range(n_cols):
                lo = splits[c]
                hi = splits[c + 1] if c + 1 < n_cols else n
                if hi > lo:
                    buffers[int(c)] = sorted_log[lo:hi]

    if cost is not None and n:
        # timeline metadata (hwmodel.TimelineTag): the batch size and its
        # commit-id span - `merged` is commit-ordered, so the span is its
        # first/last entry
        cost.annotate(n_updates=int(n),
                      cid_lo=int(merged["commit_id"][0]),
                      cid_hi=int(merged["commit_id"][-1]))
    if cost is not None and n and price:
        log_bytes = n * LOG_ENTRY_BYTES
        if on_pim:
            # Merge unit streams entries from DRAM through FIFO queues.
            cost.add(phase="ship", island="ana", resource="merge",
                     items=n, bytes_local=2 * log_bytes)
            # Hash unit: front-end + probes (vault-local pointer chasing).
            cost.add(phase="ship", island="ana", resource="hash",
                     items=n * AVG_PROBES, bytes_local=n * AVG_PROBES * 16)
            # Copy unit ships buffers vault-to-vault within the group.
            cost.add(phase="ship", island="ana", resource="copy",
                     bytes_remote=log_bytes)
            # The txn island still pays to expose its logs once over the channel.
            cost.add(phase="ship", island="txn", resource="cpu",
                     cycles=0.0, bytes_offchip=log_bytes)
        else:
            # CPU software shipping: everything crosses the shared channel
            # and burns CPU cycles on the txn island (§3.2's 14.8-21.2% hit).
            cost.add(phase="ship", island="txn", resource="cpu",
                     cycles=n * np.log2(max(len(per_thread_logs), 2)) * CPU_CYCLES_PER_CMP
                     + n * AVG_PROBES * CPU_CYCLES_PER_PROBE,
                     bytes_offchip=3 * log_bytes + n * AVG_PROBES * 16)
    return buffers
