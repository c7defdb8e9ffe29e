from repro_torch.kernels.dict_ops.ops import (  # noqa: F401
    apply_pipeline_batch, launch_scan_exact, scan_exact, scan_exact_ref,
    scan_filter_agg, scan_filter_agg_batch, scan_filter_agg_batch_ref,
    scan_filter_agg_sharded, scan_filter_agg_sharded_ref)
