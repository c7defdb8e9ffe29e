"""Model configuration shared by all assigned architectures."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    """One layer's recipe. mixer: attn | attn_local | mamba; mlp: dense | moe."""

    mixer: str = "attn"
    mlp: str = "dense"


@dataclasses.dataclass(frozen=True)
class WhisperBlock:
    """whisper's own encoder-decoder block (arXiv:2212.04356), for a
    `WhisperConfig`: a front end of two Conv1d + GELU over
    ``n_mels`` log-mel bins (the second of stride 2), fixed sinusoidal
    encoder positions, learned decoder positions (``max_target_positions``
    of them, no RoPE), pre-LayerNorm with a bias (eps 1e-5) before each
    sub-layer and at the ends of both stacks, q, v and out biases (none on
    k), a GELU MLP with biases, and a head tied to the token embedding."""

    n_mels: int = 128
    max_target_positions: int = 448


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    blocks: tuple[BlockSpec, ...] = (BlockSpec(),)
    head_dim: int = 0                  # 0 -> d_model // n_heads
    # attention
    qkv_bias: bool = False
    rope_theta: float = 1e4
    window: int = 4096                 # sliding window for attn_local
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    # moe
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    # ssm (mamba)
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    # enc-dec (whisper)
    is_encoder_decoder: bool = False
    n_enc_layers: int = 0
    enc_context: int = 1500            # decode-time encoder length (audio frames)
    # the encoder-decoder's block (a class attribute, not a field, so that
    # a config compares field for field with the reference's): None, the
    # reference's whisper-shaped stand-in (RMSNorm, SwiGLU, RoPE, a stub
    # front end, an untied head); `WhisperConfig` sets whisper's own
    whisper = None
    # modality frontend stub: None | "patch" (vlm) | "frames" (audio)
    frontend: str | None = None
    n_frontend_tokens: int = 1024
    # numerics / memory
    param_dtype: str = "float32"
    activ_dtype: str = "float32"
    loss_chunk: int = 0                # >0: chunked cross-entropy over seq
    remat: bool = False                # activation checkpointing per period
    # attention family flags (for long_500k applicability, DESIGN.md §5)
    sub_quadratic: bool = False

    # ---- derived ----------------------------------------------------------
    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def period(self) -> int:
        return len(self.blocks)

    @property
    def n_periods(self) -> int:
        assert self.n_layers % self.period == 0, (self.name, self.n_layers,
                                                  self.period)
        return self.n_layers // self.period

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def dt_rank(self) -> int:
        return max(1, self.d_model // 16)

    @property
    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def adtype(self) -> torch.dtype:
        return getattr(torch, self.activ_dtype)

    def param_count(self) -> int:
        """Total parameters (analytic); used for MODEL_FLOPS in the roofline."""
        d, dff, hd = self.d_model, self.d_ff, self.head_dim_
        if self.whisper is not None:
            inner, w = self.n_heads * hd, self.whisper
            attn = 4 * d * inner + 2 * inner + d     # q, v and out biases
            mlp = 2 * d * dff + dff + d
            return (self.vocab_size * d + w.max_target_positions * d
                    + 3 * w.n_mels * d + 3 * d * d + 2 * d
                    + (self.n_enc_layers or self.n_layers) * (attn + mlp
                                                              + 4 * d)
                    + self.n_layers * (2 * attn + mlp + 6 * d) + 4 * d)
        n = 2 * self.vocab_size * d  # embed + head (untied)
        for spec in self.blocks:
            reps = self.n_periods
            if spec.mixer in ("attn", "attn_local", "bidir"):
                n += reps * (d * self.n_heads * hd * 2
                             + 2 * d * self.n_kv_heads * hd)
            elif spec.mixer == "mamba":
                di = self.d_inner
                n += reps * (2 * d * di + self.d_conv * di
                             + di * (self.dt_rank + 2 * self.d_state)
                             + self.dt_rank * di + di * self.d_state + di
                             + di * d)
            if spec.mlp == "dense":
                n += reps * 3 * d * dff
            elif spec.mlp == "moe":
                n += reps * (3 * d * dff * self.n_experts + d * self.n_experts)
                if self.n_shared_experts:
                    n += reps * 3 * d * dff * self.n_shared_experts
            n += reps * 2 * d  # norms
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k + shared experts only)."""
        if not self.n_experts:
            return self.param_count()
        d, dff = self.d_model, self.d_ff
        total = self.param_count()
        moe_layers = sum(1 for s in self.blocks if s.mlp == "moe") * self.n_periods
        all_experts = moe_layers * 3 * d * dff * self.n_experts
        active = moe_layers * 3 * d * dff * self.top_k
        return total - all_experts + active


@dataclasses.dataclass(frozen=True)
class WhisperConfig(ModelConfig):
    """A `ModelConfig` with one more field, ``whisper``: the
    encoder-decoder runs whisper's own block (`WhisperBlock`; None: the
    reference's stand-in)."""

    whisper: WhisperBlock | None = WhisperBlock()
