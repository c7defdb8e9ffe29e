from repro_torch.kernels.selective_scan.ops import (  # noqa: F401
    BWD_CHANNELS, BWD_LANES, BWD_TILE, STATE_SIZES,
    SelectiveScan, SelectiveScanGated, launch_selective_scan,
    launch_selective_scan_bwd, launch_selective_scan_gated,
    launch_selective_scan_gated_bwd, selective_scan, selective_scan_bwd,
    selective_scan_bwd_ref, selective_scan_gated, selective_scan_gated_bwd,
    selective_scan_gated_bwd_ref, selective_scan_gated_f32,
    selective_scan_gated_ref, selective_scan_ref, selective_scan_step_ref)
