"""Placement of the HTAP mesh plane: one island's shard per device.

Polynesia's analytical plane is N *physically separate* islands (§4,
Fig. 5). On the mesh placement (``core.backend.MeshBackend``) island *s* is
device *s* of the island device list (``context.island_mesh``), and every
tensor the scan plane touches is of one of two kinds:

* **island-owned** - a pinned column's rows of one island (codes, valid):
  a flat ``(width_s,)`` tensor resident on that island's device and
  nowhere else (`place_shard_arrays`);
* **replicated** - the order-preserving dictionary and the join's
  build-side histogram: one copy on every island device, made once per
  view (``dsm.MeshView``), as the paper replicates the dictionary. The
  query bounds are a few bytes per call and go to each device with it.

The JAX package states these rules as PartitionSpecs for ``device_put``
and ``shard_map`` (``island_spec``, ``replicated_spec``,
``island_sharding``, ``replicated_sharding``). PyTorch has no sharded
tensor here and no ``shard_map``: a tensor lives on one device, so the
rules are the per-island tensors themselves and those four functions have
no counterpart.
"""

from __future__ import annotations

from typing import Sequence

import torch

# The one axis of the HTAP plane: island s == device s of the device list.
ISLAND_AXIS = "island"


def place_shard_arrays(devices: Sequence[torch.device], codes, valid,
                       sizes: Sequence[int] | None = None):
    """Lay each island's shard on its own device: the mesh's residency
    primitive.

    `codes` / `valid` are the islands' rows, either a stacked
    ``(n_shards, width)`` tensor (row s cut to ``sizes[s]``, its padding
    dropped) or a sequence of flat per-island tensors. Returns
    ``(codes, valid)``, tuples of one flat ``(width_s,)`` tensor per
    island on ``devices[s]``. A tensor already on its island's device is
    kept, not copied (installed columns are never written in place, so it
    may alias). The dictionary is not placed here: it is the view's
    replicated copy (``dsm.MeshView.island_dicts``).
    """
    n = len(devices)
    if len(codes) != n or len(valid) != n:
        raise ValueError(f"{len(codes)} code and {len(valid)} validity "
                         f"shards for {n} island devices")
    if sizes is not None:
        codes = [codes[s][:sizes[s]] for s in range(n)]
        valid = [valid[s][:sizes[s]] for s in range(n)]
    return (tuple(c.to(d) for c, d in zip(codes, devices)),
            tuple(v.to(d) for v, d in zip(valid, devices)))
