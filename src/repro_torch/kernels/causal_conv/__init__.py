from repro_torch.kernels.causal_conv.ops import (  # noqa: F401
    CHANNELS, DTYPES, TAPS, TILE, CausalConvSiLU, causal_conv_silu,
    causal_conv_silu_bwd, causal_conv_silu_bwd_ref, causal_conv_silu_ref,
    launch_causal_conv, launch_causal_conv_bwd)
