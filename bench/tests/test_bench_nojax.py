"""No run loads JAX or the JAX package, compared by whole top-level
names, and the references load nothing of the program."""

from __future__ import annotations

import json
import os
import subprocess
import sys

from bench import harness

ROOT = str(harness.ROOT)

RUN = """
import sys, json
sys.path.insert(0, {src!r}); sys.path.insert(0, {root!r})
from bench.tests import tiny
from bench import harness
for cell in ("fm7b-train", "micro-ana"):
    run = tiny.run(cell, seconds=0.3)
    harness.result_line(tiny.benchmark(), run, False)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

REFERENCE = """
import sys, json
sys.path.insert(0, {root!r})
import bench.reference.htap, bench.reference.mamba_lm, bench.generators
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _modules(code: str) -> set[str]:
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code.format(
        src=os.path.join(ROOT, "src"), root=ROOT)], check=True,
        capture_output=True, text=True, env=env, timeout=600, cwd=ROOT)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    top = _modules(RUN)
    assert "repro_torch" in top          # the program did run
    assert not top & set(harness.FORBIDDEN), top & set(harness.FORBIDDEN)


def test_the_references_load_nothing_of_the_program():
    top = _modules(REFERENCE)
    assert "repro_torch" not in top
    assert not top & set(harness.FORBIDDEN)


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_like", sys)
    assert "repro" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.kernels", sys)
    assert harness.forbidden_modules() == ["repro"]
