from repro_torch.kernels.snapshot_copy.ops import (  # noqa: F401
    launch_snapshot_copy, snapshot_copy, snapshot_copy_ref)
