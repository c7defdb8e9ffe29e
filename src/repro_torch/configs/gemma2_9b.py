"""gemma2-9b [dense]: 42L d_model=3584 16H (GQA kv=8) d_ff=14336 v=256000 —
local(4096)/global alternating attention, logit softcaps [arXiv:2408.00118].

Half the layers are sliding-window: long_500k RUNS (local layers keep a
4096-slot rolling KV; global layers hold the full cache — decode is O(S)
per token; DESIGN.md §5).
"""

from repro_torch.models.config import BlockSpec, ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b",
    n_layers=42,
    d_model=3584,
    n_heads=16, n_kv_heads=8, head_dim=256,
    d_ff=14336,
    vocab_size=256000,
    blocks=(BlockSpec(mixer="attn_local", mlp="dense"),
            BlockSpec(mixer="attn", mlp="dense")),
    window=4096,
    attn_softcap=50.0, final_softcap=30.0,
    param_dtype="bfloat16", activ_dtype="bfloat16",
    loss_chunk=512, remat=True,
    sub_quadratic=True,
)

SMOKE = ModelConfig(
    name="gemma2-9b-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128,
    vocab_size=512,
    blocks=(BlockSpec(mixer="attn_local", mlp="dense"),
            BlockSpec(mixer="attn", mlp="dense")),
    window=8,
    attn_softcap=50.0, final_softcap=30.0,
    sub_quadratic=True,
)
