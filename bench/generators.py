"""Inputs made from the seed: the HTAP table and its rounds of traffic.

The program receives only what these make; the reference makes the same
again from the same seed. The table is drawn on the device in a few large
calls; the rounds are drawn on the host as the window goes, one numpy
generator a round, so round r of a seed is the same whatever ran before it.

The shapes follow the paper's HTAP microbenchmark (§8) as the upstream's
generator documents it: int32 columns of `distinct` values each, drawn
from [0, domain); transactions that each read or write one cell of a
uniformly chosen row and column, from one of `threads` threads, a write
storing a value drawn from [0, domain); queries
``SELECT sum(a) WHERE lo <= f <= hi`` of the given selectivity over
uniformly chosen columns, a share of them with a self-join on a third.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def make_columns(seed: int, rows: int, cols: int, distinct: int, domain: int,
                 device) -> list[torch.Tensor]:
    """The table's columns, int32 on `device`: column j takes `distinct`
    values drawn without replacement from [0, domain), and each row one of
    them uniformly."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    out = []
    for _ in range(cols):
        pool = torch.randperm(domain, generator=gen, device=dev)[:distinct]
        pick = torch.randint(0, distinct, (rows,), generator=gen, device=dev)
        out.append(pool.to(torch.int32)[pick])
        del pick
    return out


@dataclasses.dataclass
class Round:
    """One round's traffic: transactions in commit order (numpy arrays of
    equal length; op 0 reads, 1 writes ``value`` into (row, col)) and
    queries as (filter col, lo, hi, agg col, join col or -1)."""

    index: int
    thread: np.ndarray
    commit: np.ndarray
    op: np.ndarray
    row: np.ndarray
    col: np.ndarray
    value: np.ndarray
    queries: list

    @property
    def writes(self) -> np.ndarray:
        return self.op != 0


class Rounds:
    """Round r of a closed loop of rounds, drawn from (seed, r)."""

    def __init__(self, seed: int, rows: int, cols: int, domain: int,
                 traffic: dict):
        self.seed = int(seed)
        self.rows, self.cols, self.domain = rows, cols, domain
        self.txns = int(traffic["txns_per_round"])
        self.write_ratio = float(traffic["write_ratio"])
        self.threads = int(traffic["threads"])
        self.n_queries = int(traffic["queries_per_round"])
        self.selectivity = float(traffic["selectivity"])
        self.join_fraction = float(traffic["join_fraction"])

    def round(self, r: int) -> Round:
        rng = np.random.default_rng([self.seed, int(r)])
        n = self.txns
        thread = rng.integers(0, self.threads, size=n).astype(np.int32)
        op = (rng.random(n) < self.write_ratio).astype(np.int8)
        row = rng.integers(0, self.rows, size=n).astype(np.int64)
        col = rng.integers(0, self.cols, size=n).astype(np.int32)
        value = rng.integers(0, self.domain, size=n).astype(np.int32)
        commit = np.arange(r * n, (r + 1) * n, dtype=np.int64)
        q = self.n_queries
        f = rng.integers(0, self.cols, size=q)
        a = rng.integers(0, self.cols, size=q)
        span = int(self.domain * self.selectivity)
        lo = rng.integers(0, int(self.domain * (1 - self.selectivity)), size=q)
        joins = rng.random(q) < self.join_fraction
        j = rng.integers(0, self.cols, size=q)
        queries = [(int(f[i]), int(lo[i]), int(lo[i]) + span, int(a[i]),
                    int(j[i]) if joins[i] else -1) for i in range(q)]
        return Round(r, thread, commit, op, row, col, value, queries)


def token_chunk(seed: int, step: int, n: int, vocab: int) -> np.ndarray:
    """The `n` tokens ingested before training step `step`, int32."""
    rng = np.random.default_rng([int(seed), 1, int(step)])
    return rng.integers(0, vocab, size=n).astype(np.int32)


# -- a Mamba-1 language model's weights ---------------------------------------

def _seed_of(seed: int, *path: int) -> int:
    return int(np.random.SeedSequence([int(seed), *path]).generate_state(
        1, np.uint64)[0] >> np.uint64(1))


def _normal(seed: int, path: tuple, sizes, device) -> list[torch.Tensor]:
    """One draw of N(0, 1) float32 on `device` for several leaves, split."""
    gen = torch.Generator(device=device)
    gen.manual_seed(_seed_of(seed, 7, *path))
    flat = torch.randn(sum(int(np.prod(s)) for s in sizes), generator=gen,
                       device=device, dtype=torch.float32)
    out, at = [], 0
    for s in sizes:
        n = int(np.prod(s))
        out.append(flat[at:at + n].view(*s))
        at += n
    return out


def mamba_layer_weights(seed: int, cfg: dict, layer: int, dtype, device
                        ) -> dict:
    """Layer `layer`'s leaves, drawn in one call from (seed, layer): the
    matrices N(0, 1 / fan_in) (the convolution's taps 1 / d_conv), cast to
    `dtype`; the biases 0; A's log the S4D-real init log(1 .. N) and the
    skip 1, both float32; the norms' scales 1."""
    d, di = cfg["hidden_size"], cfg["intermediate_size"]
    r, n, k = cfg["time_step_rank"], cfg["state_size"], cfg["conv_kernel"]
    dev = torch.device(device)
    sizes = [(d, 2 * di), (k, di), (di, r + 2 * n), (r, di), (di, d)]
    fans = [d, k, di, r, di]
    w = [(x * f ** -0.5).to(dtype)
         for x, f in zip(_normal(seed, (layer,), sizes, dev), fans)]
    one = torch.ones((d,), dtype=dtype, device=dev)
    return {
        "ln1": {"scale": one.clone()}, "ln2": {"scale": one.clone()},
        "mamba": {
            "in_proj": {"w": w[0]}, "conv_w": w[1],
            "conv_b": torch.zeros((di,), dtype=dtype, device=dev),
            "x_proj": {"w": w[2]},
            "dt_proj": {"w": w[3],
                        "b": torch.zeros((di,), dtype=dtype, device=dev)},
            "out_proj": {"w": w[4]},
            "a_log": torch.log(torch.arange(1, n + 1, dtype=torch.float32,
                                            device=dev)).repeat(di, 1),
            "d_skip": torch.ones((di,), dtype=torch.float32, device=dev)}}


def mamba_outer_weights(seed: int, cfg: dict, dtype, device) -> dict:
    """The embedding N(0, 1), the head N(0, 1 / d), the final norm's scale
    1; each matrix in one call."""
    d, v = cfg["hidden_size"], cfg["vocab_size"]
    L = cfg["num_hidden_layers"]
    dev = torch.device(device)
    (table,) = _normal(seed, (L,), [(v, d)], dev)
    (head,) = _normal(seed, (L + 1,), [(d, v)], dev)
    return {"embed": {"table": table.to(dtype)},
            "head": {"w": (head * d ** -0.5).to(dtype)},
            "ln_f": {"scale": torch.ones((d,), dtype=dtype, device=dev)}}


def flatten(tree: dict, prefix: str = "") -> dict:
    """Nested dicts of leaves -> {"a.b.c": leaf}."""
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten(v, name + "."))
        else:
            out[name] = v
    return out


def pipeline_initial_tokens(seed: int, n: int, vocab: int) -> np.ndarray:
    """The token column a `HTAPTokenPipeline(seed=seed)` starts from, as the
    pipeline documents its draw: numpy's generator seeded with `seed`,
    integers in [0, vocab) of shape (n, 1)."""
    return np.random.default_rng(int(seed)).integers(
        0, vocab, size=(n, 1))[:, 0].astype(np.int32)


def batch_window(column: np.ndarray, n_rows: int, step: int, batch: int,
                 seq: int) -> np.ndarray:
    """The (batch, seq + 1) window a step reads when the column holds
    `column[:n_rows]`: the pipeline's documented schedule, ``start = (step
    x need) mod max(n_rows - need, 1)``."""
    need = batch * (seq + 1)
    start = (step * need) % max(n_rows - need, 1)
    return column[start:start + need].reshape(batch, seq + 1)
