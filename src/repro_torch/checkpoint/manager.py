"""Checkpointing: atomic, resumable, optionally async - the fault-tolerance
substrate (checkpoint/restart; elastic restore onto another island set).

Layout:  <dir>/step_<N>/
            manifest.json   (step, tree paths, shapes, dtypes)
            arrays.npz      (flattened path -> numpy array)
         <dir>/LATEST       (committed step marker - written last, atomic)

The layout, the flattened keys and the manifest are the JAX package's
(``repro.checkpoint``), so either package reads the other's checkpoints.
A tree is a nested dict, list or tuple of torch tensors or numpy arrays;
its keys are the dict keys (in sorted order) and list indices joined with
``/``. npz has no bfloat16: such a leaf is stored as its uint16 bits under
``<key>::bf16`` and read back as a ``torch.bfloat16`` tensor.

Restore never trusts an uncommitted step (crash-during-save safe). Arrays
are stored whole on the host and placed on the *target* device at restore,
which is what a restart onto another island set needs
(`core.elastic.restore_session` rides `load_arrays`).

The async writer copies every leaf to host memory of its own before the
thread starts (a CPU tensor's ``.numpy()`` shares its storage, so an
in-place update after `save_checkpoint` returns would otherwise leak into
the write), then serializes on the thread.
"""

from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch

from repro_torch.kernels.common import resolve_device

BF16_SUFFIX = "::bf16"


def _leaves_with_path(tree, path=()):
    """(path, leaf) pairs in the JAX package's flattening order: dict keys
    sorted, list and tuple items in order; None and empty containers hold
    no leaf."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_path(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves_with_path(v, path + (i,))
    else:
        yield path, tree


def _unflatten(tree, leaves):
    """`tree`'s structure with its leaves replaced, in flattening order,
    from the iterator `leaves`."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        out = {k: _unflatten(tree[k], leaves) for k in sorted(tree)}
        return {k: out[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(v, leaves) for v in tree)
    return next(leaves)


def _key(path) -> str:
    return "/".join(str(p) for p in path)


def _host_copy(leaf) -> tuple[np.ndarray, bool]:
    """A leaf as host numpy of its own (never sharing the caller's memory),
    and whether it holds bfloat16 bits (as uint16)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        owned = t.device.type != "cpu"        # .cpu() copied it already
        t = t.cpu()
        bf16 = t.dtype == torch.bfloat16
        arr = (t.view(torch.int16).numpy().view(np.uint16) if bf16
               else t.numpy())
        return (arr if owned else arr.copy()), bf16
    arr = np.array(leaf, copy=True)
    if arr.dtype.name == "bfloat16":          # an ml_dtypes array
        return arr.view(np.uint16), True
    return arr, False


def _flatten(tree) -> dict[str, np.ndarray]:
    out = {}
    for path, leaf in _leaves_with_path(tree):
        arr, bf16 = _host_copy(leaf)
        out[_key(path) + (BF16_SUFFIX if bf16 else "")] = arr
    return out


def save_checkpoint(ckpt_dir: str, step: int, tree, wait: bool = True):
    """Snapshot to host, then (optionally async) serialize + commit.
    Returns the writer thread when ``wait=False``, else None."""
    flat = _flatten(tree)  # host snapshot happens NOW (consistent view)
    step_dir = os.path.join(ckpt_dir, f"step_{step}")

    def _write():
        tmp = step_dir + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "arrays.npz"), **flat)
        manifest = {
            "step": step,
            "arrays": {k: {"shape": list(v.shape), "dtype": str(v.dtype)}
                       for k, v in flat.items()},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(step_dir):
            shutil.rmtree(step_dir)
        os.rename(tmp, step_dir)                      # atomic commit point 1
        with open(os.path.join(ckpt_dir, "LATEST.tmp"), "w") as f:
            f.write(str(step))
        os.replace(os.path.join(ckpt_dir, "LATEST.tmp"),
                   os.path.join(ckpt_dir, "LATEST"))  # atomic commit point 2

    os.makedirs(ckpt_dir, exist_ok=True)
    if wait:
        _write()
        return None
    t = threading.Thread(target=_write, daemon=True)
    t.start()
    return t


def latest_step(ckpt_dir: str) -> int | None:
    marker = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(marker):
        return None
    with open(marker) as f:
        step = int(f.read().strip())
    if os.path.exists(os.path.join(ckpt_dir, f"step_{step}", "arrays.npz")):
        return step
    return None


def _bf16(bits: np.ndarray) -> torch.Tensor:
    """uint16 bit patterns -> the bfloat16 tensor they encode (CPU)."""
    return torch.from_numpy(np.ascontiguousarray(bits).view(np.int16)
                            ).view(torch.bfloat16)


def load_arrays(ckpt_dir: str, step: int) -> dict:
    """Load a committed step's raw arrays as ``{flat key: array}``.

    The structure-free dual of `restore_checkpoint` for callers that carry
    their own schema (the elastic session restore,
    `core.elastic.restore_session`): keys are the flattened tree paths;
    every array is host numpy except a ``::bf16``-stored one, which comes
    back under its key without the suffix as a ``torch.bfloat16`` tensor on
    the CPU (numpy has no bfloat16 of its own).
    """
    data = np.load(os.path.join(ckpt_dir, f"step_{step}", "arrays.npz"))
    out = {}
    for key in data.files:
        arr = data[key]
        if key.endswith(BF16_SUFFIX):
            out[key[:-len(BF16_SUFFIX)]] = _bf16(arr)
        else:
            out[key] = arr
    return out


def _torch_dtype(dtype) -> torch.dtype:
    """A leaf's dtype (torch, numpy, or ml_dtypes' bfloat16) as torch's."""
    if isinstance(dtype, torch.dtype):
        return dtype
    dtype = np.dtype(dtype)
    if dtype.name == "bfloat16":
        return torch.bfloat16
    return torch.from_numpy(np.empty(0, dtype)).dtype


def restore_checkpoint(ckpt_dir: str, step: int, like, device=None):
    """Restore into the structure of `like` (a tree whose leaves have
    ``shape`` and ``dtype``: tensors, ``device="meta"`` tensors, numpy
    arrays): a tree of tensors of the leaves' dtypes on `device` (None
    means the GPU and raises without one)."""
    dev = resolve_device(device)
    data = np.load(os.path.join(ckpt_dir, f"step_{step}", "arrays.npz"))
    leaves = []
    for path, leaf in _leaves_with_path(like):
        key = _key(path)
        if key + BF16_SUFFIX in data:
            t = _bf16(data[key + BF16_SUFFIX])
        else:
            t = torch.from_numpy(data[key])
        if tuple(t.shape) != tuple(leaf.shape):
            raise ValueError(f"checkpoint array {key!r} has shape "
                             f"{tuple(t.shape)}, the restore target "
                             f"{tuple(leaf.shape)}")
        leaves.append(t.to(device=dev, dtype=_torch_dtype(leaf.dtype)))
    return _unflatten(like, iter(leaves))


class CheckpointManager:
    """Keeps the last `keep` checkpoints; supports async save + resume."""

    def __init__(self, ckpt_dir: str, keep: int = 3, save_every: int = 50,
                 async_save: bool = True):
        self.dir = ckpt_dir
        self.keep = keep
        self.save_every = save_every
        self.async_save = async_save
        self._pending: threading.Thread | None = None

    def maybe_save(self, step: int, tree) -> bool:
        if step % self.save_every:
            return False
        self.wait()
        self._pending = save_checkpoint(self.dir, step, tree,
                                        wait=not self.async_save)
        self._gc()
        return True

    def wait(self):
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def close(self):
        """Join the in-flight async writer; the manager is reusable after.

        Call at the end of training or a session so the process never exits
        with a half-written (uncommitted) step still on the writer thread.
        """
        self.wait()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def _gc(self):
        steps = sorted(
            int(d.split("_")[1]) for d in os.listdir(self.dir)
            if d.startswith("step_") and not d.endswith(".tmp"))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    def resume(self, like, device=None):
        self.wait()
        step = latest_step(self.dir)
        if step is None:
            return None, None
        return step, restore_checkpoint(self.dir, step, like, device)
