"""The LM substrate in plain PyTorch: parameter trees of ``Params`` modules
plus apply functions under the reference's names (``repro.nn``).

Each module is an ``init_*(generator, ...) -> Params`` plus a function that
applies it; a ``Params`` reads as the reference's nested dict
(``p["w"]``, ``"b" in p``). The hot loops go through the hand-written
kernels: decode attention (``kernels/decode_attn``) and the Mamba prefill
scan (``kernels/selective_scan``).
"""

from repro_torch.nn.layers import (Params, dense, embed, init_dense,  # noqa: F401
                                   init_embed, init_rmsnorm, rmsnorm)
