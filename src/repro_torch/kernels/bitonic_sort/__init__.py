from repro_torch.kernels.bitonic_sort.ops import (  # noqa: F401
    MAX_TILE, apply_pipeline_batch, apply_pipeline_batch_ref,
    launch_bitonic_apply, launch_merge_rows, launch_sort_rows,
    merge_rows_ref, sort_1024, sort_rows, sort_rows_ref)
