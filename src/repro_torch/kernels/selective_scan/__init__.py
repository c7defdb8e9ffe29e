from repro_torch.kernels.selective_scan.ops import (  # noqa: F401
    STATE_SIZES, launch_selective_scan, selective_scan, selective_scan_ref,
    selective_scan_step_ref)
