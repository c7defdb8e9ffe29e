"""The port's checkpoint manager (`repro_torch/checkpoint`) against the JAX
package's: atomic commit, async save, GC, bf16 leaves, and the on-disk
layout read across packages in both directions.

Mirrors tests/test_checkpoint.py's tree-level tests on torch trees on the
CPU, and its `test_restart_resumes_bit_identical` on the port's LM trainer
(a crash after step 4, resumed from the step-4 checkpoint: the same
parameters as the uninterrupted run, bit for bit). Values are compared
exactly; bf16 leaves bit for bit.
"""

import os

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import (CheckpointManager, latest_step,
                                    load_arrays, restore_checkpoint,
                                    save_checkpoint)

torch.set_num_threads(1)


def _like(tree):
    """The port's `jax.eval_shape`: the tree's leaves as meta tensors."""
    return {k: _like(v) if isinstance(v, dict)
            else torch.empty(v.shape, dtype=v.dtype, device="meta")
            for k, v in tree.items()}


def test_roundtrip(tmp_path):
    tree = {"a": torch.arange(6).reshape(2, 3),
            "b": {"c": torch.ones((4,), dtype=torch.bfloat16)}}
    save_checkpoint(str(tmp_path), 7, tree)
    assert latest_step(str(tmp_path)) == 7
    out = restore_checkpoint(str(tmp_path), 7, _like(tree), device="cpu")
    assert torch.equal(out["a"], torch.arange(6).reshape(2, 3))
    assert out["b"]["c"].dtype == torch.bfloat16
    assert torch.equal(out["b"]["c"], tree["b"]["c"])


def test_async_save_and_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, save_every=1,
                            async_save=True)
    tree = {"x": torch.zeros((8,))}
    for s in range(5):
        mgr.maybe_save(s, tree)
    mgr.wait()
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(tmp_path)
                   if d.startswith("step_"))
    assert len(steps) <= 3  # keep=2 (+ possibly one in flight)
    assert latest_step(str(tmp_path)) == 4


def test_uncommitted_checkpoint_is_ignored(tmp_path):
    tree = {"x": torch.zeros((4,))}
    save_checkpoint(str(tmp_path), 1, tree)
    # simulate crash-during-save of step 2: dir exists, LATEST not updated
    os.makedirs(tmp_path / "step_2.tmp")
    assert latest_step(str(tmp_path)) == 1


def test_crash_during_save_keeps_older_committed_step(tmp_path):
    """A crash mid-save of step 5 can leave a complete-looking step dir
    behind with LATEST still pointing at the older commit (the LATEST
    rename is the commit point, not the step dir). Restore must take the
    committed step 3, and a re-save of step 5 must recover cleanly."""
    save_checkpoint(str(tmp_path), 3, {"x": torch.arange(4)})
    save_checkpoint(str(tmp_path), 5, {"x": torch.arange(4) + 99})
    with open(tmp_path / "LATEST", "w") as f:
        f.write("3")
    assert latest_step(str(tmp_path)) == 3
    out = restore_checkpoint(str(tmp_path), 3, {"x": torch.arange(4)},
                             device="cpu")
    assert torch.equal(out["x"], torch.arange(4))
    save_checkpoint(str(tmp_path), 5, {"x": torch.arange(4) + 7})
    assert latest_step(str(tmp_path)) == 5


def test_load_arrays_bf16_roundtrip(tmp_path):
    """`load_arrays` recovers bf16 leaves bit-exactly through the ::bf16
    uint16 bit-store (as torch.bfloat16 tensors) and keeps the flattened
    slash-joined keys."""
    vals = torch.tensor([1.5, -2.25, 3.0, 0.0078125], dtype=torch.bfloat16)
    save_checkpoint(str(tmp_path), 2, {"a": {"b": vals},
                                       "n": np.arange(3)})
    out = load_arrays(str(tmp_path), 2)
    assert set(out) == {"a/b", "n"}
    assert out["a/b"].dtype == torch.bfloat16
    assert torch.equal(out["a/b"].view(torch.int16), vals.view(torch.int16))
    np.testing.assert_array_equal(out["n"], np.arange(3))


def test_manager_close_joins_async_writer(tmp_path):
    """close() (and the context manager) join the in-flight async writer,
    so the last save is committed by the time the manager is released."""
    with CheckpointManager(str(tmp_path), save_every=1,
                           async_save=True) as mgr:
        mgr.maybe_save(1, {"x": torch.ones((256, 256))})
        mgr.maybe_save(2, {"x": torch.zeros((256, 256))})
    assert mgr._pending is None
    assert latest_step(str(tmp_path)) == 2
    mgr.close()  # idempotent, reusable after


def test_async_save_snapshots_before_the_writer_runs(tmp_path):
    """A CPU tensor's numpy view shares its storage: the save must copy
    every leaf before the writer thread starts, so an in-place update made
    after save_checkpoint returns never reaches the file."""
    x = torch.zeros(1 << 16)
    a = np.zeros(1 << 16, np.int32)
    t = save_checkpoint(str(tmp_path), 1, {"x": x, "a": a}, wait=False)
    x += 1
    a += 1
    t.join()
    out = load_arrays(str(tmp_path), 1)
    assert not out["x"].any() and not out["a"].any()


def test_manager_resume_places_on_the_device(tmp_path):
    mgr = CheckpointManager(str(tmp_path), save_every=2, async_save=False)
    tree = {"w": [torch.arange(3, dtype=torch.int32), (torch.ones(2),)]}
    assert not mgr.maybe_save(1, tree)
    assert mgr.maybe_save(2, tree)
    like = {"w": [np.zeros(3, np.int64), (torch.zeros(2),)]}
    step, out = mgr.resume(like, device="cpu")
    assert step == 2
    assert out["w"][0].dtype == torch.int64          # the target's dtype
    assert torch.equal(out["w"][0], torch.arange(3))
    assert isinstance(out["w"][1], tuple)
    assert torch.equal(out["w"][1][0], torch.ones(2))
    with pytest.raises(ValueError, match="shape"):
        restore_checkpoint(str(tmp_path), 2, {"w": [np.zeros(4), (1,)]},
                           device="cpu")


# ---------------------------------------------------------------------------
# across packages: one layout, read both ways
# ---------------------------------------------------------------------------

def _tree_np(rng):
    """A nested tree of host arrays of several dtypes, keys out of order."""
    return {"z": rng.integers(-2**31, 2**31 - 1, (3, 5)).astype(np.int32),
            "a": {"f": rng.standard_normal(7).astype(np.float32),
                  "m": rng.random(4) < 0.5,
                  "l": [rng.integers(0, 2**40, 6).astype(np.int64),
                        rng.integers(0, 255, 2).astype(np.uint8)]}}


def _flat(tree, prefix=""):
    """(key, leaf) in the JAX flattening order, for comparisons."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _flat(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in _flat(v, f"{prefix}{i}/")]
    return [(prefix[:-1], tree)]


def test_reference_checkpoint_loads_in_the_port(tmp_path):
    import jax.numpy as jnp

    from repro.checkpoint import save_checkpoint as ref_save
    rng = np.random.default_rng(0)
    tree = _tree_np(rng)
    bf = rng.standard_normal(9).astype(np.float32)
    ref_tree = dict(tree, h=jnp.asarray(bf, jnp.bfloat16))
    ref_save(str(tmp_path), 4, ref_tree)
    assert latest_step(str(tmp_path)) == 4
    got = load_arrays(str(tmp_path), 4)
    want = dict(_flat(ref_tree))
    assert set(got) == set(want)
    for k, v in want.items():
        if k == "h":
            assert got[k].dtype == torch.bfloat16
            assert np.array_equal(got[k].view(torch.int16).numpy(),
                                  np.asarray(v).view(np.int16))
        else:
            assert got[k].dtype == v.dtype
            np.testing.assert_array_equal(got[k], v)
    # and structured: restore_checkpoint onto the tree's shapes and dtypes
    like = dict(tree, h=torch.empty(9, dtype=torch.bfloat16, device="meta"))
    out = restore_checkpoint(str(tmp_path), 4, like, device="cpu")
    for (k, a), (_, b) in zip(_flat(out), _flat(ref_tree)):
        if k == "h":
            assert torch.equal(a, torch.from_numpy(
                np.array(b.astype(jnp.float32))).to(torch.bfloat16))
        else:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_port_checkpoint_loads_in_the_reference(tmp_path):
    import json

    import jax
    import jax.numpy as jnp

    from repro.checkpoint import latest_step as ref_latest
    from repro.checkpoint import load_arrays as ref_load
    from repro.checkpoint import restore_checkpoint as ref_restore
    rng = np.random.default_rng(1)
    tree = _tree_np(rng)
    bf = torch.tensor([1.5, -2.25, 3.0, 0.0078125, -0.0], dtype=torch.bfloat16)
    port_tree = dict(tree, t=torch.from_numpy(tree["z"] * 3), h=bf)
    save_checkpoint(str(tmp_path), 9, port_tree)
    assert ref_latest(str(tmp_path)) == 9
    got = ref_load(str(tmp_path), 9)
    want = dict(_flat(port_tree))
    assert set(got) == set(want)
    for k, v in want.items():
        if k == "h":
            assert got[k].dtype == jnp.bfloat16
            np.testing.assert_array_equal(got[k].view(np.int16),
                                          v.view(torch.int16).numpy())
        else:
            v = v.numpy() if isinstance(v, torch.Tensor) else v
            assert got[k].dtype == v.dtype
            np.testing.assert_array_equal(got[k], v)
    with open(tmp_path / "step_9" / "manifest.json") as f:
        manifest = json.load(f)
    assert manifest["step"] == 9 and "h::bf16" in manifest["arrays"]
    assert manifest["arrays"]["h::bf16"] == {"shape": [5], "dtype": "uint16"}
    out = ref_restore(str(tmp_path), 9, jax.eval_shape(
        lambda: jax.tree.map(jnp.asarray, dict(
            tree, t=tree["z"] * 3,
            h=jnp.asarray(bf.float().numpy(), jnp.bfloat16)))))
    assert out["h"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(out["t"]), tree["z"] * 3)


# ---------------------------------------------------------------------------
# the trainer: checkpoint / restart
# ---------------------------------------------------------------------------

def _run_steps(ckpt_dir, n_steps, resume, save_every=2):
    """Tiny deterministic train loop with checkpoint/restart: qwen2.5's
    smoke config, AdamW at lr 1e-3, `SyntheticPipeline` batches."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import SyntheticPipeline
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.lm import init_lm
    from repro_torch.optim import get_optimizer
    cfg = get_smoke_config("qwen2.5-14b")
    model = init_lm(cfg, generator=torch.Generator().manual_seed(0),
                    device="cpu")
    opt = get_optimizer("adamw", lr=1e-3)
    params = dict(model.named_parameters())
    opt_state = opt[0](params)
    step_fn = make_train_step(cfg, opt)
    pipe = SyntheticPipeline(cfg.vocab_size, seq_len=8, batch=2,
                             device="cpu")
    mgr = CheckpointManager(ckpt_dir, save_every=save_every,
                            async_save=False)
    start = 0
    if resume:
        got = mgr.resume({"params": _like(params), "opt": _like(opt_state)},
                         device="cpu")
        if got[0] is not None:
            start = got[0] + 1
            with torch.no_grad():
                for k, p in params.items():
                    p.copy_(got[1]["params"][k])
            opt_state = got[1]["opt"]
    for step in range(start, n_steps):
        toks, labels = pipe.get_batch(step)
        model, opt_state, metrics = step_fn(
            model, opt_state, step, {"tokens": toks, "labels": labels})
        assert torch.isfinite(metrics["loss"])
        mgr.maybe_save(step, {"params": dict(model.named_parameters()),
                              "opt": opt_state})
    mgr.wait()
    return model


def test_restart_resumes_bit_identical(tmp_path):
    """Crash at step 4, restart, finish -> identical to uninterrupted run."""
    uninterrupted = _run_steps(str(tmp_path / "a"), 6, resume=False)
    _run_steps(str(tmp_path / "b"), 4, resume=False)      # "crashes" after 4
    assert latest_step(str(tmp_path / "b")) == 2
    resumed = _run_steps(str(tmp_path / "b"), 6, resume=True)
    for (k, a), (_, b) in zip(uninterrupted.named_parameters(),
                              resumed.named_parameters()):
        assert torch.equal(a, b), k
    fresh = _run_steps(str(tmp_path / "c"), 0, resume=False)
    assert not all(torch.equal(a, b) for a, b in zip(
        fresh.parameters(), uninterrupted.parameters()))
