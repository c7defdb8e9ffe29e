"""The HTAP microbenchmark's plain reference, in plain PyTorch.

It keeps its own copy of the table, made again from the seed, applies
each round's writes in commit order (the last write to a cell wins), and
answers a query over the table as it stands:

    sum(a over the rows with lo <= f <= hi)
      + (self-join) sum over those rows of the number of rows whose join
        value equals theirs.

The columns live on the device because host numpy over 200M rows would
take minutes; nothing here is dictionary-encoded and nothing comes from
the program.
"""

from __future__ import annotations

import numpy as np
import torch

from bench.generators import Round, make_columns


class Table:
    def __init__(self, seed: int, config: dict, device):
        self.device = torch.device(device)
        self.cols = make_columns(seed, config["rows"], config["cols"],
                                 config["distinct"], config["domain"],
                                 self.device)
        self._counts: dict[int, tuple[torch.Tensor, torch.Tensor]] = {}

    def apply(self, rnd: Round) -> None:
        """The round's writes, in commit order: per column, the last write
        to each row."""
        w = rnd.writes
        if not w.any():
            return
        if not np.isin(rnd.op, (0, 1)).all():
            raise ValueError("the reference models reads and cell writes only")
        for c in np.unique(rnd.col[w]):
            m = w & (rnd.col == c)
            rows, vals = rnd.row[m], rnd.value[m]
            # the last occurrence of each row wins (commit order)
            _, first_rev = np.unique(rows[::-1], return_index=True)
            keep = len(rows) - 1 - first_rev
            idx = torch.from_numpy(rows[keep]).to(self.device)
            self.cols[int(c)][idx] = torch.from_numpy(vals[keep]).to(
                self.device)
            self._counts.pop(int(c), None)

    def _value_counts(self, c: int):
        if c not in self._counts:
            self._counts[c] = torch.unique(self.cols[c], sorted=True,
                                           return_counts=True)
        return self._counts[c]

    def answer(self, q) -> int:
        f, lo, hi, a, j = q
        fv = self.cols[f]
        mask = (fv >= lo) & (fv <= hi)
        total = int((self.cols[a] * mask).sum(dtype=torch.int64))
        if j >= 0:
            values, counts = self._value_counts(j)
            jv = self.cols[j]
            weight = counts[torch.searchsorted(values, jv)]
            total += int((weight * mask).sum(dtype=torch.int64))
        return total

    def answers(self, queries) -> list[int]:
        return [self.answer(q) for q in queries]

    def cells_differing(self, got: dict) -> int:
        """Cells where `got` (column -> int32 values of every row, or None
        for a column missing or of another length) differs."""
        bad = 0
        for c, want in enumerate(self.cols):
            g = got.get(c)
            if g is None or g.shape != want.shape:
                bad += int(want.numel())
                continue
            bad += int((g.to(want.device) != want).sum())
        return bad
