"""HTAP-fed training data pipeline: the paper's system as the ML substrate.

The transactional island (host threads) ingests token sequences as row
inserts with ordered update logs; update propagation ships and applies
them into the analytical replica (a dictionary-encoded token column on
the device); each training step begins an analytical "query": it pins a
consistent snapshot (§6) and reads its batch from the freshest committed
data. Freshness = train on data ingested moments ago; isolation = ingest
never stalls the step; consistency = a step never sees a half-applied
update batch.

On the ``hopper`` backend the path runs the port's kernels: the ship's
k-way merge of the thread logs (``merge_runs``), the apply's one-column
dictionary stage (``bitonic_apply``) and the snapshot of the dirty column
at a pinned read (``snapshot_copy``). The batch is gathered through the
dictionary on the device and returned there: no host round trip.

Determinism for fault tolerance: batch contents are a pure function of
(step, store length at snapshot), so a restarted run replays identically.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.core.application import apply_updates
from repro_torch.core.backend import get_backend
from repro_torch.core.consistency import ConsistencyManager
from repro_torch.core.dsm import DSMReplica, encode_column
from repro_torch.core.nsm import RowStore, make_entries
from repro_torch.core.shipping import ship_updates
from repro_torch.kernels.common import resolve_device


class HTAPTokenPipeline:
    """Streaming token store with HTAP freshness/consistency semantics.
    ``backend`` None means ``"hopper"``; ``device`` None means the GPU
    (the token column lives there)."""

    TOKEN_COL = 0

    def __init__(self, vocab_size: int, seq_len: int, batch: int,
                 seed: int = 0, initial_tokens: int = 1 << 16,
                 n_threads: int = 4, backend=None, device=None):
        self.vocab = vocab_size
        self.seq_len = seq_len
        self.batch = batch
        self.device = resolve_device(device)
        self.backend = get_backend(backend, device=self.device)
        self.rng = np.random.default_rng(seed)
        self._commit = 0
        init = self.rng.integers(0, vocab_size, size=(initial_tokens, 1))
        self.row_store = RowStore(init.astype(np.int32), n_threads=n_threads)
        self.replica = DSMReplica(columns={
            self.TOKEN_COL: encode_column(init[:, 0], self.device)})
        self.cons = ConsistencyManager(self.replica, on_pim=True,
                                       backend=self.backend)
        self.ingested = initial_tokens

    # -- transactional island: streaming ingest ---------------------------
    def ingest(self, tokens: np.ndarray) -> None:
        """Append a chunk of tokens (row inserts + update-log entries)."""
        with tracing.span("pipeline.ingest"):
            tokens = np.asarray(tokens, dtype=np.int32).reshape(-1)
            n = len(tokens)
            rows = np.arange(self.ingested, self.ingested + n, dtype=np.int64)
            commit = np.arange(self._commit, self._commit + n, dtype=np.int64)
            self._commit += n
            entries = make_entries(commit, np.full(n, 2, np.int8), tokens,
                                   rows, np.full(n, self.TOKEN_COL, np.int32))
            # round-robin the entries over ingest threads (per-thread logs)
            n_threads = self.row_store.n_threads
            for t in range(n_threads):
                self.row_store.logs[t].append(entries[t::n_threads])
            self.ingested += n

    # -- update propagation (§5) -------------------------------------------
    def propagate(self) -> int:
        """Ship + apply pending updates; returns #updates applied."""
        pending = self.row_store.pending_updates
        if not pending:
            return 0
        with tracing.span("pipeline.propagate", device=self.device):
            logs = self.row_store.drain_logs()
            buffers = ship_updates(logs, n_cols=1, on_pim=True,
                                   backend=self.backend)
            for col_id, entries in buffers.items():
                new = apply_updates(self.replica.columns[col_id], entries,
                                    on_pim=True, backend=self.backend)
                self.cons.on_update(col_id, new)
        return pending

    # -- analytical island: the training step's batch read ------------------
    def get_batch(self, step: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Consistent snapshot read -> (tokens, labels), int32 (B, S) on
        the pipeline's device. The window's codes go through the
        dictionary on the device (the same values as decoding the whole
        column and slicing it)."""
        with tracing.span("pipeline.get_batch", step):
            h = self.cons.begin_query([self.TOKEN_COL])
            try:
                col = self.cons.read(h, self.TOKEN_COL)
                need = self.batch * (self.seq_len + 1)
                n = col.n_rows
                if n < need:
                    raise ValueError(f"store too small: {n} < {need}")
                with tracing.span("pipeline.gather", step):
                    # deterministic offset schedule over the committed prefix
                    start = (step * need) % max(n - need, 1)
                    codes = col.codes[start:start + need].long()
                    window = col.dictionary[codes].reshape(self.batch,
                                                           self.seq_len + 1)
                    toks = window[:, :-1].to(torch.int32).contiguous()
                    labels = window[:, 1:].to(torch.int32).contiguous()
            finally:
                self.cons.end_query(h)
        return toks, labels

    def freshness_lag(self) -> int:
        """Tokens ingested but not yet visible to readers (data freshness)."""
        head = self.replica.columns[self.TOKEN_COL]
        return self.ingested - head.n_rows


class SyntheticPipeline:
    """RNG batches with the same interface (for pure-perf runs): numpy's
    generator seeded with (seed, step), as the reference's, on `device`
    (None: the GPU)."""

    def __init__(self, vocab_size: int, seq_len: int, batch: int,
                 seed: int = 0, device=None):
        self.vocab = vocab_size
        self.seq_len = seq_len
        self.batch = batch
        self.seed = seed
        self.device = resolve_device(device)

    def get_batch(self, step: int):
        rng = np.random.default_rng((self.seed, step))
        toks = rng.integers(0, self.vocab,
                            size=(self.batch, self.seq_len + 1)).astype(np.int32)
        toks = torch.from_numpy(toks).to(self.device)
        return toks[:, :-1].contiguous(), toks[:, 1:].contiguous()
