"""Distribution layer of the HTAP mesh plane: how island shards are laid on
devices (`sharding`) and the process-global list of island devices
(`context`) that `HTAPSession` installs and `core.backend.MeshBackend`
resolves."""

from repro_torch.distributed.context import (clear_island_mesh,  # noqa: F401
                                             current_island_mesh,
                                             install_island_mesh,
                                             island_mesh)
from repro_torch.distributed.sharding import (ISLAND_AXIS,  # noqa: F401
                                              place_shard_arrays)
