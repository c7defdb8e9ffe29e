"""kimi-k2-1t-a32b [moe]: 61L d_model=7168 64H (GQA kv=8) d_ff=2048/expert,
vocab=163840, MoE 384 experts top-8 + 1 shared — trillion-param MoE
[arXiv:2501.kimi2 paper table].

Expert weights dominate: 61 * 384 * 3 * 7168 * 2048 ~= 1.03T params,
~32B active. EP shards the expert axis over "model"; FSDP over "data" is
mandatory (see distributed/sharding.py); train uses Adafactor-class
optimizer states (configs pick this in launch/train.py) for the memory
budget — noted in EXPERIMENTS.md §Dry-run.
"""

from repro_torch.models.config import BlockSpec, ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    n_layers=61,
    d_model=7168,
    n_heads=64, n_kv_heads=8, head_dim=112,
    d_ff=2048,
    vocab_size=163840,
    blocks=(BlockSpec(mixer="attn", mlp="moe"),),
    n_experts=384, top_k=8, n_shared_experts=1, capacity_factor=1.25,
    param_dtype="bfloat16", activ_dtype="bfloat16",
    loss_chunk=1024, remat=True,
)

SMOKE = ModelConfig(
    name="kimi-k2-1t-a32b-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=32,
    vocab_size=512,
    blocks=(BlockSpec(mixer="attn", mlp="moe"),),
    n_experts=8, top_k=2, n_shared_experts=1, capacity_factor=2.0,
)
