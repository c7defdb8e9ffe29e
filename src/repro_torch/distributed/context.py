"""Process-global island devices of the HTAP mesh plane.

The mesh placement (``core.backend.MeshBackend``) lays analytical island
*s* on device *s* of a tuple of ``torch.device``s. `HTAPSession` installs
its backend's tuple here when it opens and restores the previous one when
it closes, so every backend resolved in between without an explicit list
(ad-hoc ``get_backend("hopper@N/mesh")`` calls) lands on the same devices:
one process, one island-to-device mapping.

``island_mesh(n)`` resolves the devices: an explicit ``devices`` list
wins; else the installed tuple when it has ``n`` islands; else the first
``n`` GPUs. Fewer GPUs is an actionable error. An explicit list may repeat
a device: ``["cuda:0"] * 4`` runs four islands, each with its own shard
tensors and launches, on one card, and ``["cpu"] * 4`` runs them through
the kernels' plain versions - the counterpart of the JAX package's
emulated host devices (``--xla_force_host_platform_device_count``).

The JAX package's partitioning hook for its neural layers
(``set_partitioning``, ``constrain``) belongs to the LM's sharded
training, which is not ported (ROADMAP.md queue 1, item 14).
"""

from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.kernels.common import resolve_device

_ISLAND_DEVICES: tuple[torch.device, ...] | None = None  # HTAPSession's


def _resolve_all(devices: Sequence) -> tuple[torch.device, ...]:
    devs = tuple(resolve_device(d) for d in devices)
    if not devs:
        raise ValueError("an island device list needs at least one device")
    return devs


def install_island_mesh(devices: Sequence) -> None:
    """Install `devices` (one per island) as the process's island devices
    (HTAPSession does this)."""
    global _ISLAND_DEVICES
    _ISLAND_DEVICES = _resolve_all(devices)


def current_island_mesh() -> tuple[torch.device, ...] | None:
    """The installed island devices, or None."""
    return _ISLAND_DEVICES


def clear_island_mesh() -> None:
    global _ISLAND_DEVICES
    _ISLAND_DEVICES = None


def island_mesh(n_islands: int, devices: Sequence | None = None
                ) -> tuple[torch.device, ...]:
    """The devices of `n_islands` analytical islands, island s first.

    ``devices`` given: exactly those (``n_islands`` of them; repeats
    allowed). Else the installed tuple when it has ``n_islands`` entries,
    else ``cuda:0 .. cuda:n-1``, which needs that many GPUs.
    """
    n_islands = int(n_islands)
    if n_islands < 1:
        raise ValueError(f"n_islands must be >= 1, got {n_islands}")
    if devices is not None:
        devs = _resolve_all(devices)
        if len(devs) != n_islands:
            raise ValueError(f"{len(devs)} island devices given for "
                             f"{n_islands} islands")
        return devs
    if _ISLAND_DEVICES is not None and len(_ISLAND_DEVICES) == n_islands:
        return _ISLAND_DEVICES
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < n_islands:
        raise RuntimeError(
            f"mesh placement needs {n_islands} devices (one per analytical "
            f"island) but this process sees {have} GPU(s); run on a machine "
            f"with {n_islands} GPUs, or pass the island devices explicitly - "
            f"a list may repeat a device, e.g. devices=['cuda:0'] * "
            f"{n_islands} for {n_islands} islands on one card, or "
            f"devices=['cpu'] * {n_islands} to run the plain versions - or "
            f"use the stacked placement (e.g. 'hopper@{n_islands}')")
    return tuple(torch.device("cuda", i) for i in range(n_islands))
