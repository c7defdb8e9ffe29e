from repro_torch.kernels.hash_probe.ops import (  # noqa: F401
    EMPTY, EMPTY as EMPTY_KEY, HashTable, build_table, launch_hash_probe,
    probe, probe_ref, probe_sharded, scan_filter_agg_join,
    scan_filter_agg_join_group, scan_filter_agg_join_group_mesh,
    scan_filter_agg_join_group_mesh_ref, scan_filter_agg_join_group_ref,
    scan_filter_agg_join_group_sharded,
    scan_filter_agg_join_group_sharded_ref, scan_filter_agg_join_mesh,
    scan_filter_agg_join_mesh_ref, scan_filter_agg_join_ref,
    scan_filter_agg_join_sharded, scan_filter_agg_join_sharded_ref,
    tables_built)
