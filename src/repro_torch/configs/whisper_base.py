"""whisper-base [audio]: enc-dec, 6L d_model=512 8H d_ff=2048 vocab=51865
[arXiv:2212.04356]. Conv frontend is a STUB: input_specs() provides
precomputed frame embeddings. Shape convention (DESIGN.md §5): train/prefill
use enc_len = dec_len = seq_len; decode uses a fixed 1500-frame encoder
context. Full-attention decoder: long_500k SKIPPED.
"""

from repro_torch.models.config import BlockSpec, ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    n_layers=6,                 # decoder layers
    n_enc_layers=6,
    d_model=512,
    n_heads=8, n_kv_heads=8, head_dim=64,
    d_ff=2048,
    vocab_size=51865,
    blocks=(BlockSpec(mixer="attn", mlp="dense"),),
    is_encoder_decoder=True,
    enc_context=1500,
    frontend="frames",
    param_dtype="bfloat16", activ_dtype="bfloat16",
    loss_chunk=512, remat=True,
)

SMOKE = ModelConfig(
    name="whisper-base-smoke",
    n_layers=2,
    n_enc_layers=2,
    d_model=64,
    n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128,
    vocab_size=512,
    blocks=(BlockSpec(mixer="attn", mlp="dense"),),
    is_encoder_decoder=True,
    enc_context=16,
    frontend="frames",
)
