"""Batch runners over the session API (§4, §9.1).

The systems of Fig. 6 that this port covers, plus the two normalization
baselines - each is a `SystemSpec` preset (core/session.py):

  MI+SW      multiple instance, Polynesia's software optimizations, CPU only
  MI+SW+HB   MI+SW with a hypothetical 8x off-chip bandwidth (256 GB/s)
  PIM-Only   MI+SW run entirely on general-purpose PIM cores
  Polynesia  islands + PIM accelerators + placement + scheduler (full system)
  Ideal-Txn  transactions alone (no analytics, zero-cost propagation)
  Ana-Only   analytics alone on the multicore CPU

`run(system, table, stream, queries)` splits the pre-generated workload
into uniform rounds (core/workload.py) and drives an incremental
`HTAPSession`. Each run executes the workload *functionally* (every system
computes real query answers) while emitting cost events priced by the
analytic hardware model (hwmodel.py) under the ``"phase"`` timing model:
whole-run phase buckets per island (hwmodel.HardwareModel.time). The
single-instance systems (SI-SS, SI-MVCC), the ``"timeline"`` timing model
and mixed-traffic serving are not ported yet (ROADMAP.md queue 1).
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.hwmodel import CostLog, HardwareModel, HardwareParams
from repro_torch.core.session import (ALL_PRESETS, BASELINE_PRESETS,  # noqa: F401
                                      HTAPSession, PIM_TXN_CYCLE_FACTOR,
                                      PRESETS, SystemSpec, resolve_spec)
from repro_torch.core.workload import split_queries, split_stream


@dataclasses.dataclass
class RunResult:
    name: str
    n_txn: int
    n_ana: int
    txn_seconds: float
    ana_seconds: float
    energy_joules: float
    results: list[int]            # analytical query answers (for equality tests)
    stats: dict = dataclasses.field(default_factory=dict)
    # Commit-to-visibility lag; only measurable under the timeline timing
    # model (None under the phase model).
    freshness_seconds: dict | None = None

    @property
    def txn_throughput(self) -> float:
        return self.n_txn / self.txn_seconds if self.txn_seconds > 0 else float("inf")

    @property
    def ana_throughput(self) -> float:
        return self.n_ana / self.ana_seconds if self.ana_seconds > 0 else float("inf")


def _price(name: str, cost: CostLog, hw: HardwareParams, timing: str,
           n_txn: int, n_ana: int, results: list, stats: dict | None = None,
           concurrent_islands: bool = True) -> RunResult:
    """Price the cost log under the phase timing model -> RunResult:
    per-island phase-bucket sums."""
    if timing != "phase":
        raise NotImplementedError(
            f"timing={timing!r} is not ported yet - ROADMAP.md queue 1, "
            "item 10 (timeline timing + async propagation)")
    model = HardwareModel(hw)
    stats = dict(stats or {})
    t = model.time(cost, concurrent_islands=concurrent_islands)
    # the concurrent fixed-function bucket (ship/apply/snapshot on the
    # analytical island)
    stats["accel_seconds"] = t["accel"]
    return RunResult(name, n_txn, n_ana, t["txn"], t["ana"],
                     model.energy(cost), results, stats=stats)


def run_spec(spec: SystemSpec, table, stream=None, queries=None,
             n_rounds: int = 8, device=None, devices=None) -> RunResult:
    """Run a pre-generated workload through ``spec``'s system.

    Splits the stream/queries into ``n_rounds`` uniform rounds and drives
    an `HTAPSession` on `device` (None = the GPU), its mesh islands on
    `devices` (see `HTAPSession`). The normalization
    baselines ignore the side they don't model (Ideal-Txn takes the whole
    stream in one round; Ana-Only answers each query individually over the
    initial table).
    """
    session = HTAPSession(spec, table, device=device, devices=devices)
    if spec.kind == "ideal_txn":
        session.execute(stream)
        return session.finish()
    if spec.kind == "ana_only":
        for q in list(queries or []):
            session.query(q)
        return session.finish()
    queries = list(queries or [])
    for r, (txn_chunk, q_chunk) in enumerate(
            zip(split_stream(stream, n_rounds),
                split_queries(queries, n_rounds))):
        if r:
            session.advance_round()
        session.execute(txn_chunk)
        session.query_batch(q_chunk)
    return session.finish()


def run(system: str | SystemSpec, table, stream=None, queries=None,
        n_rounds: int = 8, device=None, devices=None,
        **overrides) -> RunResult:
    """Run a preset (by name) or an explicit spec over a batch workload.

    ``overrides`` refine the preset, e.g. ``run("Polynesia", t, s, q,
    backend="torch", n_shards=4)`` (four analytical islands on one device)
    or ``run("Polynesia", t, s, q, backend="hopper@4/mesh",
    devices=["cuda:0", "cuda:1", "cuda:2", "cuda:3"])`` (one per card).
    """
    return run_spec(resolve_spec(system, **overrides), table, stream,
                    queries, n_rounds=n_rounds, device=device,
                    devices=devices)
