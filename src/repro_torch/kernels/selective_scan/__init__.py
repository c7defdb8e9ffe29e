from repro_torch.kernels.selective_scan.ops import (  # noqa: F401
    BWD_CHANNELS, BWD_LANES, BWD_TILE, STATE_SIZES,
    SelectiveScan, launch_selective_scan, launch_selective_scan_bwd,
    selective_scan, selective_scan_bwd, selective_scan_bwd_ref,
    selective_scan_ref, selective_scan_step_ref)
