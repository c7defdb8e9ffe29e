"""whisper-large-v3 [audio]: enc-dec, 32 + 32 layers d_model=1280 20H
d_ff=5120 vocab=51866, 128 mel bins, 1,500 encoder and 448 decoder
positions (huggingface.co/openai/whisper-large-v3, config.json;
arXiv:2212.04356). whisper's own block (`WhisperBlock`): the conv front end
on log-mel frames (B, 128, 3000), sinusoidal encoder and learned decoder
positions, LayerNorm with a bias, q/v/out biases, a GELU MLP, a tied head.
bf16 weights (the published checkpoint is float16). Training and prefill
only: decoding with this block is not implemented.
"""

from repro_torch.models.config import BlockSpec, WhisperBlock, WhisperConfig

CONFIG = WhisperConfig(
    name="whisper-large-v3",
    n_layers=32,                # decoder layers
    n_enc_layers=32,
    d_model=1280,
    n_heads=20, n_kv_heads=20, head_dim=64,
    d_ff=5120,
    vocab_size=51866,
    blocks=(BlockSpec(mixer="attn", mlp="dense"),),
    is_encoder_decoder=True,
    enc_context=1500,
    frontend="frames",
    whisper=WhisperBlock(n_mels=128, max_target_positions=448),
    param_dtype="bfloat16", activ_dtype="bfloat16",
    loss_chunk=448, remat=True,
)

SMOKE = WhisperConfig(
    name="whisper-large-v3-smoke",
    n_layers=2,
    n_enc_layers=2,
    d_model=64,
    n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=256,
    vocab_size=512,
    blocks=(BlockSpec(mixer="attn", mlp="dense"),),
    is_encoder_decoder=True,
    enc_context=24,
    frontend="frames",
    whisper=WhisperBlock(n_mels=8, max_target_positions=16),
)
