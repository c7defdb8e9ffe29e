"""qwen2.5-14b [dense]: 48L d_model=5120 40H (GQA kv=8) d_ff=13824 v=152064 —
GQA with QKV bias [hf:Qwen/Qwen2.5]."""

from repro_torch.models.config import BlockSpec, ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-14b",
    n_layers=48,
    d_model=5120,
    n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=13824,
    vocab_size=152064,
    blocks=(BlockSpec(mixer="attn", mlp="dense"),),
    qkv_bias=True,
    param_dtype="bfloat16", activ_dtype="bfloat16",
    loss_chunk=2048, remat=True,
)

SMOKE = ModelConfig(
    name="qwen2.5-14b-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128,
    vocab_size=512,
    blocks=(BlockSpec(mixer="attn", mlp="dense"),),
    qkv_bias=True,
)
