"""Table schemas and synthetic workload generation (paper §8 methodology).

The paper's microbenchmark workload: each transactional query randomly reads
or writes a few randomly-chosen tuples of a randomly-chosen table; each
analytical query runs select/join over randomly-chosen tables/columns.
Columns have a small number of distinct values (<=32 for most columns,
per Krueger et al. [43], which Strategy 3's dictionary replication relies on).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

# Bytes per raw (unencoded) value in both replicas. The paper's engines store
# fixed-width integer attributes; we use 4-byte ints throughout.
VALUE_BYTES = 4
# Bytes per update-log entry: commit_id(8) + type(1) + data(4) + key(8) -> padded.
LOG_ENTRY_BYTES = 24


@dataclasses.dataclass(frozen=True)
class TableSchema:
    """A relational table schema with per-column distinct-value cardinality."""

    name: str
    n_cols: int
    distinct_values: tuple[int, ...]  # per-column cardinality of the value domain

    def __post_init__(self):
        assert len(self.distinct_values) == self.n_cols


def make_schema(name: str, n_cols: int, distinct: int | Sequence[int] = 32) -> TableSchema:
    if isinstance(distinct, int):
        distinct = (distinct,) * n_cols
    return TableSchema(name=name, n_cols=n_cols, distinct_values=tuple(distinct))


def gen_table(rng: np.random.Generator, schema: TableSchema, n_rows: int) -> np.ndarray:
    """Generate an (n_rows, n_cols) int32 table.

    Column j draws from a pool of `distinct_values[j]` values spread over a
    wide domain so that dictionary encoding is non-trivial (codes != values).
    """
    cols = []
    for j in range(schema.n_cols):
        k = schema.distinct_values[j]
        pool = rng.choice(np.arange(0, 1 << 24, dtype=np.int32), size=k, replace=False)
        cols.append(pool[rng.integers(0, k, size=n_rows)])
    return np.stack(cols, axis=1).astype(np.int32)


@dataclasses.dataclass
class UpdateStream:
    """A pre-generated stream of transactional queries.

    op: 0 = read, 1 = modify (cell), 2 = insert (row), 3 = delete (row)
    Each query carries the touched row, column (for modifies) and new value.
    commit ids are assigned globally (total order across threads, paper §5.1).
    """

    thread_id: np.ndarray  # (n,) int32
    commit_id: np.ndarray  # (n,) int64, globally ordered
    op: np.ndarray         # (n,) int8
    row: np.ndarray        # (n,) int64
    col: np.ndarray        # (n,) int32
    value: np.ndarray      # (n,) int32

    def __len__(self) -> int:
        return int(self.commit_id.shape[0])

    def writes_mask(self) -> np.ndarray:
        return self.op != 0


def gen_update_stream(
    rng: np.random.Generator,
    schema: TableSchema,
    n_rows: int,
    n_queries: int,
    n_threads: int = 4,
    write_ratio: float = 0.5,
    zipf_skew: float = 0.0,
) -> UpdateStream:
    """Generate the paper's transactional microbenchmark (§8).

    `write_ratio` is the fraction of queries that modify data (the paper
    sweeps 50%/80%/100% "write intensity"). `zipf_skew > 0` makes row
    access skewed (used by the scheduler benchmark for load imbalance).
    """
    thread_id = rng.integers(0, n_threads, size=n_queries).astype(np.int32)
    commit_id = np.arange(n_queries, dtype=np.int64)  # global total order
    is_write = rng.random(n_queries) < write_ratio
    op = np.where(is_write, np.int8(1), np.int8(0))
    if zipf_skew > 0.0:
        # Bounded zipf over rows.
        ranks = np.arange(1, n_rows + 1, dtype=np.float64) ** (-zipf_skew)
        p = ranks / ranks.sum()
        row = rng.choice(n_rows, size=n_queries, p=p).astype(np.int64)
    else:
        row = rng.integers(0, n_rows, size=n_queries).astype(np.int64)
    col = rng.integers(0, schema.n_cols, size=n_queries).astype(np.int32)
    # New values come from each column's pool-shaped domain; reuse a shared pool.
    value = rng.integers(0, 1 << 24, size=n_queries).astype(np.int32)
    return UpdateStream(thread_id, commit_id, op, row, col, value)
