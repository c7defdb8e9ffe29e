from repro_torch.kernels.decode_attn.ops import (  # noqa: F401
    decode_attention, decode_attention_ref, launch_decode_attention)
