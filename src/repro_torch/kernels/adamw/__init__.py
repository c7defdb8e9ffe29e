from repro_torch.kernels.adamw.ops import (  # noqa: F401
    MAX_LEAVES, adamw_update, adamw_update_ref, launch_adamw, launch_groups,
    leaf_table)
