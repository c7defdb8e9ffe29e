"""internvl2-26b [vlm]: 48L d_model=6144 48H (GQA kv=8) d_ff=16384 v=92553.

InternViT + InternLM2 [arXiv:2404.16821; hf]. Backbone only: the ViT
frontend is a stub — input_specs() provides precomputed patch embeddings
(B, 1024, d_model) prepended to the text tokens (DESIGN.md §5).
"""

from repro_torch.models.config import BlockSpec, ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    n_layers=48,
    d_model=6144,
    n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=16384,
    vocab_size=92553,
    blocks=(BlockSpec(mixer="attn", mlp="dense"),),
    frontend="patch", n_frontend_tokens=1024,
    param_dtype="bfloat16", activ_dtype="bfloat16",
    loss_chunk=2048, remat=True,
)

SMOKE = ModelConfig(
    name="internvl2-26b-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128,
    vocab_size=512,
    blocks=(BlockSpec(mixer="attn", mlp="dense"),),
    frontend="patch", n_frontend_tokens=8,
)
