"""falcon-mamba-7b [ssm]: 64L d_model=4096 attn-free, vocab=65024, state=16.

Mamba-1 architecture [arXiv:2410.05355]. Pure SSM: every layer is a Mamba
block (the block subsumes the MLP — d_ff=0). sub-quadratic: long_500k RUNS.
"""

from repro_torch.models.config import BlockSpec, ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    n_layers=64,
    d_model=4096,
    n_heads=1, n_kv_heads=1,       # unused (attn-free)
    d_ff=0,
    vocab_size=65024,
    blocks=(BlockSpec(mixer="mamba", mlp="none"),),
    d_state=16, d_conv=4, expand=2,
    param_dtype="bfloat16", activ_dtype="bfloat16",
    loss_chunk=2048, remat=True,
    sub_quadratic=True,
)

SMOKE = ModelConfig(
    name="falcon-mamba-7b-smoke",
    n_layers=2,
    d_model=64,
    n_heads=1, n_kv_heads=1,
    d_ff=0,
    vocab_size=512,
    blocks=(BlockSpec(mixer="mamba", mlp="none"),),
    d_state=4, d_conv=4, expand=2,
    sub_quadratic=True,
)
