from repro_torch.kernels.merge_runs.ops import (  # noqa: F401
    MAX_RUNS, launch_merge_kway, launch_merge_runs, merge_pair_ref,
    merge_runs_ref, merge_sorted_pair, merge_sorted_pairs, merge_sorted_runs,
    run_offsets)
