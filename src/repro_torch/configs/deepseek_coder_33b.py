"""deepseek-coder-33b [dense]: 62L d_model=7168 56H (GQA kv=8) d_ff=19200
vocab=32256 — llama-arch [arXiv:2401.14196; hf]."""

from repro_torch.models.config import BlockSpec, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-coder-33b",
    n_layers=62,
    d_model=7168,
    n_heads=56, n_kv_heads=8, head_dim=128,
    d_ff=19200,
    vocab_size=32256,
    blocks=(BlockSpec(mixer="attn", mlp="dense"),),
    param_dtype="bfloat16", activ_dtype="bfloat16",
    loss_chunk=1024, remat=True,
)

SMOKE = ModelConfig(
    name="deepseek-coder-33b-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128,
    vocab_size=512,
    blocks=(BlockSpec(mixer="attn", mlp="dense"),),
)
