"""phi3-medium-14b [dense]: 40L d_model=5120 40H (GQA kv=10) d_ff=17920
vocab=100352 — RoPE SwiGLU GQA [arXiv:2404.14219].

kv=10 KV heads do not divide the model axis (16); the sharding rule pads
KV heads 10 -> 16 in the sharded layout (DESIGN.md §8).
"""

from repro_torch.models.config import BlockSpec, ModelConfig

CONFIG = ModelConfig(
    name="phi3-medium-14b",
    n_layers=40,
    d_model=5120,
    n_heads=40, n_kv_heads=10, head_dim=128,
    d_ff=17920,
    vocab_size=100352,
    blocks=(BlockSpec(mixer="attn", mlp="dense"),),
    param_dtype="bfloat16", activ_dtype="bfloat16",
    loss_chunk=2048, remat=True,
)

SMOKE = ModelConfig(
    name="phi3-medium-14b-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128,
    vocab_size=512,
    blocks=(BlockSpec(mixer="attn", mlp="dense"),),
)
