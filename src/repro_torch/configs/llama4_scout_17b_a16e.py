"""llama4-scout-17b-a16e [moe]: 48L d_model=5120 40H (GQA kv=8) d_ff=8192,
vocab=202048, MoE 16 experts top-1 + shared expert, early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E].

~108B total, ~17B active (shared + 1 routed expert per token).
"""

from repro_torch.models.config import BlockSpec, ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    n_layers=48,
    d_model=5120,
    n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    blocks=(BlockSpec(mixer="attn", mlp="moe"),),
    n_experts=16, top_k=1, n_shared_experts=1, capacity_factor=1.25,
    param_dtype="bfloat16", activ_dtype="bfloat16",
    loss_chunk=1024, remat=True,
)

SMOKE = ModelConfig(
    name="llama4-scout-17b-a16e-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=64,
    vocab_size=512,
    blocks=(BlockSpec(mixer="attn", mlp="moe"),),
    n_experts=4, top_k=1, n_shared_experts=1, capacity_factor=2.0,
)
