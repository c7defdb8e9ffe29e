"""The benchmark's own counts for Jamba's training step: its weights and
its model flops. The blocked attention's least time is
`whisper_yardstick.flash_bound_s`'s, at the launch shapes the program's
counters report.

Nothing here reads the program: the counts are functions of the
configuration's sizes and of the traffic.
"""

from __future__ import annotations

from bench import jamba_inputs
from bench.whisper_yardstick import band_pairs


def layer_kinds(cfg: dict) -> tuple[int, int]:
    """(attention layers, Mamba layers) by the layer rule."""
    n = jamba_inputs.sizes(cfg)["layers"]
    attn = sum(jamba_inputs.is_attention(cfg, i) for i in range(n))
    return attn, n - attn


def matmul_params(cfg: dict) -> int:
    """Parameters that enter a matrix product at every position: each
    layer's projections and MLP, and the head, which is the tied embedding
    (counted once: the embedding's lookup is no product). The norms, the
    convolution's taps and biases, A and the skip enter none."""
    s = jamba_inputs.sizes(cfg)
    d, di, ff = s["d"], s["di"], s["ff"]
    hd, kvd = s["heads"] * s["dh"], s["kv_heads"] * s["dh"]
    attn, mamba = layer_kinds(cfg)
    mixer_attn = 2 * d * hd + 2 * d * kvd
    mixer_mamba = (2 * d * di + di * (s["r"] + 2 * s["n"]) + s["r"] * di
                   + di * d)
    return (attn * mixer_attn + mamba * mixer_mamba
            + s["layers"] * 3 * d * ff + s["vocab"] * d)


def weights(cfg: dict) -> int:
    """Every parameter of Jamba's block: the matrices, the tied
    embedding, the norms, the conv's taps and bias, dt's bias, A and the
    skip."""
    s = jamba_inputs.sizes(cfg)
    d, di = s["d"], s["di"]
    attn, mamba = layer_kinds(cfg)
    per_mamba = s["k"] * di + di + di + di * s["n"] + di \
        + s["r"] + 2 * s["n"]
    return matmul_params(cfg) + mamba * per_mamba + s["layers"] * 2 * d + d


def train_flops(cfg: dict, traffic: dict) -> float:
    """Model flops of one training step of ``traffic["batch"]`` sequences
    of ``seq_len`` tokens: 6 a matmul parameter a token (forward 2,
    backward 4), and attention's products, 12 dh a (query, key) pair in
    the causal band and a query head (QK^T and PV forward, 4 dh; their
    four gradient products, 8 dh). A remat's recompute is not model work
    and is not counted; nor are the scan's and the conv's own operations."""
    s = jamba_inputs.sizes(cfg)
    B, S = traffic["batch"], traffic["seq_len"]
    attn, _ = layer_kinds(cfg)
    return (6.0 * B * S * matmul_params(cfg)
            + 12.0 * s["dh"] * B * s["heads"] * attn
            * band_pairs(S, S, True))
