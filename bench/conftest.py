"""Each benchmark test runs in a process without JAX or the JAX package,
as a benchmark run does, and with one torch thread, as the repository's
own tests set it: several pytest workers on one machine then do not
oversubscribe its cores, and a tiny training step fits the windows the
tests give it. Where the benchmark's tests share a process with tests that
load JAX (one pytest run over the repository's tests and the benchmark's,
whose workers import every test module), the loaded modules of those
names are hidden from `sys.modules` for the test; both are put back after
it."""

import sys

import pytest
import torch

from bench.harness import FORBIDDEN


@pytest.fixture(autouse=True)
def _as_the_benchmark_runs(monkeypatch):
    for name in [m for m in sys.modules if m.split(".")[0] in FORBIDDEN]:
        monkeypatch.delitem(sys.modules, name)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)
