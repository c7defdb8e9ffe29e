from repro_torch.kernels.dict_ops.ops import (  # noqa: F401
    apply_pipeline_batch, launch_scan_exact, launch_scan_float, scan_exact,
    launch_scan_exact_mesh, scan_exact_group, scan_exact_group_ref,
    scan_exact_mesh, scan_exact_mesh_ref, scan_exact_ref, scan_filter_agg,
    scan_filter_agg_batch, scan_filter_agg_batch_ref, scan_filter_agg_float,
    scan_filter_agg_float_ref, scan_filter_agg_group,
    scan_filter_agg_group_ref, scan_filter_agg_group_sharded,
    scan_filter_agg_mesh, scan_filter_agg_mesh_ref,
    scan_filter_agg_group_sharded_ref, scan_filter_agg_sharded,
    scan_filter_agg_sharded_ref, scan_values_agg, scan_values_agg_ref,
    scan_values_delta, scan_values_delta_ref, scan_values_exact,
    scan_values_exact_ref)
