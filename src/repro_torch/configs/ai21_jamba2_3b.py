"""AI21-Jamba2-3B [hybrid]: 28L d_model=2560, Mamba-1 mixers (d_state 16,
d_conv 4, expand 2, dt_rank 160) with two attention layers of 20 query
heads of 128 over one KV head (MQA), a dense SwiGLU MLP of 8192 after
every mixer, vocab 65536, tied embedding
(huggingface.co/ai21labs/AI21-Jamba2-3B, config.json; arXiv:2403.19887).
Layer i is attention where i % 14 == 7 (``attn_layer_period`` 14,
``attn_layer_offset`` 7, transformers' ``layers_block_type``), Mamba
elsewhere. Jamba's own block (`JambaBlock`): RMS norms on the mixer's dt,
B and C, no RoPE, the tied head. About 3.03B parameters; bf16 weights.
"""

from repro_torch.models.config import BlockSpec, JambaBlock, JambaConfig


def _period(period: int = 14, offset: int = 7):
    return tuple(BlockSpec(mixer="attn" if i == offset else "mamba",
                           mlp="dense") for i in range(period))


CONFIG = JambaConfig(
    name="ai21-jamba2-3b",
    n_layers=28,
    d_model=2560,
    n_heads=20, n_kv_heads=1, head_dim=128,
    d_ff=8192,
    vocab_size=65536,
    blocks=_period(),
    d_state=16, d_conv=4, expand=2,
    jamba=JambaBlock(),
    param_dtype="bfloat16", activ_dtype="bfloat16",
    loss_chunk=2048, remat=True,
    sub_quadratic=True,
)

SMOKE = JambaConfig(
    name="ai21-jamba2-3b-smoke",
    n_layers=14,
    d_model=64,
    n_heads=4, n_kv_heads=1, head_dim=16,
    d_ff=128,
    vocab_size=512,
    blocks=_period(),
    d_state=4, d_conv=4, expand=2,
    jamba=JambaBlock(),
    sub_quadratic=True,
)
