from repro_torch.kernels.flash_attn.ops import (  # noqa: F401
    HEAD_DIMS, FlashAttention, check_blocks, flash_attention_bwd,
    flash_attention_bwd_ref, flash_attention_fwd, flash_attention_fwd_ref,
    launch_flash_attention, launch_flash_attention_bwd_dkdv,
    launch_flash_attention_bwd_dq)
