"""AdamW's fused update (`repro_torch.kernels.adamw`) on the CPU: the
wrapper's GPU branch rehearsed with ``on_gpu`` patched to True and the bare
launch patched to run the plain version on its table's leaves, through the
optimizer's own ``update``, against the plain path step for step over 5
steps, bit for bit: the grouping into launches (one instance a launch, at
most MAX_LEAVES leaves), every leaf once and in order, the launch count
and the ``optim.fused_params`` count. Then the launch's table, the
constant shared with the source, and the wrapper's refusals. The kernel
itself is held against the plain version on the card in
``tests/test_torch_gpu.py``.
"""

import pathlib
import re

import numpy as np
import pytest
import torch

from repro_torch import tracing
from repro_torch.kernels import common
from repro_torch.kernels.adamw import ops
from repro_torch.optim import adamw

torch.set_num_threads(1)

BF, F32 = torch.bfloat16, torch.float32
SOURCE = (pathlib.Path(ops.__file__).resolve().parent.parent / "csrc"
          / "adamw.cu")

# (leaf shapes and parameter types, master weights)
MIXES = {
    "bf16_masters": ([((6, 5), BF), ((16,), BF), ((3, 4, 8), BF)], True),
    "f32_masters": ([((6, 5), F32), ((9,), F32)], True),
    "f32_plain": ([((6, 5), F32), ((9,), F32), ((2, 8), F32)], False),
    "ragged": ([((1,), BF), ((7,), BF), ((13,), BF), ((2049,), BF),
                ((3, 3), F32)], True),
    "empty_leaf": ([((5,), BF), ((0,), BF), ((4, 2), BF)], True),
    "empty_instance": ([((0,), F32), ((5,), BF), ((0, 3), F32)], True),
    "interleaved": ([((4, 4), BF), ((8, 2), F32), ((3,), BF), ((5,), F32),
                     ((7,), BF)], True),
    "over_one_table": ([((3,), BF)] * (ops.MAX_LEAVES + 5)
                       + [((2, 2), F32)] * 3, True),
}


def _tree(rng, shapes):
    params = {f"l{i}": torch.from_numpy(rng.normal(size=s).astype(np.float32))
              .to(dt) for i, (s, dt) in enumerate(shapes)}
    grads = [{k: torch.from_numpy((rng.normal(size=p.shape) * 0.1)
                                  .astype(np.float32)).to(p.dtype)
              for k, p in params.items()} for _ in range(5)]
    return params, grads


def _expected_groups(params, masters):
    """Per instance (parameter type, master or not) in the order of its
    first leaf, its leaves' indices in order, MAX_LEAVES a launch, launches
    with no element left out."""
    by: dict = {}
    for i, p in enumerate(params.values()):
        by.setdefault((p.dtype, masters), []).append(i)
    out = []
    for idx in by.values():
        for s in range(0, len(idx), ops.MAX_LEAVES):
            part = idx[s:s + ops.MAX_LEAVES]
            if sum(list(params.values())[i].numel() for i in part):
                out.append(part)
    return out


@pytest.mark.parametrize("mix", sorted(MIXES))
def test_gpu_branch_equals_the_plain_update_step_for_step(mix, monkeypatch):
    shapes, masters = MIXES[mix]
    params, grads = _tree(np.random.default_rng(7), shapes)
    plain = {k: p.clone() for k, p in params.items()}
    init, update = adamw(lr=3e-2, weight_decay=0.1, master_weights=masters)
    state, plain_state = init(params), init(plain)
    tables = []

    def fake_launch(leaves, bc1, bc2, lr, b1, b2, eps, weight_decay):
        assert 1 <= len(leaves) <= ops.MAX_LEAVES
        assert len({(p.dtype, w is None) for p, *_, w in leaves}) == 1
        assert bc1.shape == () and bc1.dtype == F32
        tables.append([next(i for i, q in enumerate(params.values())
                            if q is leaf[0]) for leaf in leaves])
        ops.adamw_update_ref(leaves, bc1, bc2, lr, b1, b2, eps, weight_decay)

    for step, g in enumerate(grads):
        tables.clear()
        common.reset_kernel_launch_counts()
        tracing.clear()
        with monkeypatch.context() as mp, tracing.recording():
            mp.setattr(ops, "on_gpu", lambda *t: True)
            mp.setattr(ops, "launch_adamw", fake_launch)
            update(params, g, state, step)
        update(plain, {k: v.clone() for k, v in g.items()}, plain_state, step)
        for k in params:
            assert params[k].dtype == plain[k].dtype
            assert torch.equal(params[k], plain[k]), k
            for part in state:
                assert torch.equal(state[part][k], plain_state[part][k])
        groups = _expected_groups(params, masters)
        assert tables == groups
        flat = [i for t in tables for i in t]
        assert len(flat) == len(set(flat))
        assert set(flat) >= {i for i, p in enumerate(params.values())
                             if p.numel()}
        assert common.kernel_launch_counts().get("adamw", 0) == len(groups)
        fused = sum(r.counts.get("optim.fused_params", 0)
                    for r in tracing.records())
        assert fused == sum(p.numel() for p in params.values())
    tracing.clear()
    common.reset_kernel_launch_counts()


def test_leaf_table_holds_the_pointers_and_counts():
    p = torch.ones((3, 5), dtype=BF)
    g, m, v, w = (torch.ones((3, 5), dtype=BF), torch.zeros((3, 5)),
                  torch.zeros((3, 5)), torch.ones((3, 5)))
    tab = ops.leaf_table([(p, g, m, v, w), (w, m, v, g, None)])
    assert list(tab) == [p.data_ptr(), g.data_ptr(), m.data_ptr(),
                         v.data_ptr(), w.data_ptr(), 15,
                         w.data_ptr(), m.data_ptr(), v.data_ptr(),
                         g.data_ptr(), 0, 15]


def test_max_leaves_matches_the_source_and_fits_4_kb():
    src = SOURCE.read_text()
    assert int(re.search(r"constexpr int MAX_LEAVES = (\d+);", src)
               .group(1)) == ops.MAX_LEAVES
    # 48 bytes a leaf, the leaf count and the hyper-parameters beside it
    assert ops.MAX_LEAVES * 48 + 8 + 7 * 4 + 4 + 2 * 8 <= 4096


@pytest.mark.parametrize("case", ["float16", "grad_type", "shape",
                                  "non_contiguous", "state_type"])
def test_gpu_branch_refuses_what_the_kernel_does_not_take(case, monkeypatch):
    p = torch.ones((4, 6), dtype=BF)
    g, m, v, w = (torch.ones((4, 6), dtype=BF), torch.zeros((4, 6)),
                  torch.zeros((4, 6)), torch.ones((4, 6)))
    if case == "float16":
        p, g = p.half(), g.half()
    elif case == "grad_type":
        g = g.float()
    elif case == "shape":
        m = torch.zeros((6, 4))
    elif case == "non_contiguous":
        g = torch.ones((6, 4), dtype=BF).t()
    else:
        v = v.double()
    monkeypatch.setattr(ops, "on_gpu", lambda *t: True)
    monkeypatch.setattr(ops, "launch_adamw", lambda *a: pytest.fail(
        "launched a leaf the kernel does not take"))
    bc = torch.ones((), dtype=F32)
    with pytest.raises((TypeError, ValueError)):
        ops.adamw_update([(p, g, m, v, w)], bc, bc, lr=1e-3, b1=0.9,
                         b2=0.95, eps=1e-8, weight_decay=0.0)
