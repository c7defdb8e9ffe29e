from repro_torch.kernels.hash_probe.ops import (  # noqa: F401
    scan_filter_agg_join, scan_filter_agg_join_ref)
