"""jamba-1.5-large-398b [hybrid]: 72L d_model=8192 64H (GQA kv=8)
d_ff=24576/expert, vocab=65536, MoE 16e top-2, Mamba+attn 1:7 interleave
[arXiv:2403.19887; hf].

Period of 8 layers: 1 attention + 7 Mamba; MoE every other layer.
~398B total. Hybrid: long_500k RUNS.
"""

from repro_torch.models.config import BlockSpec, ModelConfig


def _period():
    out = []
    for i in range(8):
        mixer = "attn" if i == 0 else "mamba"
        mlp = "moe" if i % 2 == 1 else "dense"
        out.append(BlockSpec(mixer=mixer, mlp=mlp))
    return tuple(out)


CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    n_layers=72,
    d_model=8192,
    n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=24576,
    vocab_size=65536,
    blocks=_period(),
    n_experts=16, top_k=2, capacity_factor=1.25,
    d_state=16, d_conv=4, expand=2,
    param_dtype="bfloat16", activ_dtype="bfloat16",
    loss_chunk=2048, remat=True,
    sub_quadratic=True,
)

SMOKE = ModelConfig(
    name="jamba-1.5-large-398b-smoke",
    n_layers=8,
    d_model=64,
    n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=64,
    vocab_size=512,
    blocks=_period(),
    n_experts=4, top_k=2, capacity_factor=2.0,
    d_state=4, d_conv=4, expand=2,
    sub_quadratic=True,
)
