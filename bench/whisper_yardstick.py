"""The benchmark's own counts for whisper's training step: its weights, its
model flops, and the least time of the blocked attention's launches.

Nothing here reads the program: the counts are functions of the
configuration's sizes, of the traffic and of the launch shapes that the
program's counters report (``flash_attention`` and ``flash_attention_bwd``
at (B, Sq, Skv, H, Hkv, dh, causal, window, softcap); a backward call
counts as two launches, its dQ pass and its dK/dV pass).
"""

from __future__ import annotations

import numpy as np

from bench import whisper_inputs, yardstick


def band_pairs(Sq: int, Skv: int, causal: bool, window: int = 0) -> int:
    """The (query row, key) pairs in the causal / window band."""
    i = np.arange(Sq)
    hi = np.minimum(i, Skv - 1) if causal else np.full(Sq, Skv - 1)
    lo = np.maximum(0, i - window + 1) if window > 0 else np.zeros(Sq, int)
    return int(np.maximum(0, hi - lo + 1).sum())


def matmul_params(cfg: dict) -> dict:
    """Parameters that enter a matrix product, by the positions they run
    at: ``frames`` (the encoder's layers and the decoder's cross K and V
    projections, at the encoder's positions), ``tokens`` (the decoder's
    self-attention, cross q and out projections and MLP, and the head,
    which is the tied embedding), and the two convolutions (``conv1`` at
    the mel frames, ``conv2`` at the encoder's positions). The learned
    positions are added and enter no product."""
    s = whisper_inputs.sizes(cfg)
    d, ff = s["d"], s["ff"]
    enc_layer = 4 * d * d + 2 * d * ff
    dec_tokens = 6 * d * d + 2 * d * ff
    return {"frames": s["enc"] * enc_layer + s["dec"] * 2 * d * d,
            "tokens": s["dec"] * dec_tokens + s["vocab"] * d,
            "conv1": 3 * s["mels"] * d, "conv2": 3 * d * d}


def weights(cfg: dict) -> int:
    """Every parameter of whisper's block."""
    s = whisper_inputs.sizes(cfg)
    d, ff = s["d"], s["ff"]
    attn = 4 * d * d + 3 * d                   # q, v and out biases
    mlp = 2 * d * ff + ff + d
    ln = 2 * d
    return (s["vocab"] * d + s["positions"] * d
            + 3 * s["mels"] * d + d + 3 * d * d + d
            + s["enc"] * (attn + mlp + 2 * ln)
            + s["dec"] * (2 * attn + mlp + 3 * ln) + 2 * ln)


def train_flops(cfg: dict, traffic: dict) -> float:
    """Model flops of one training step of ``traffic["batch"]`` clips of
    ``frames`` mel frames and ``seq_len`` tokens: 6 a matmul parameter a
    position (forward 2, backward 4), and the attentions' products, 12 dh
    a (query, key) pair in the band and a head (QK^T and PV forward, 4
    dh; their four gradient products, 8 dh). A remat's recompute is not
    model work and is not counted."""
    s = whisper_inputs.sizes(cfg)
    B, F, S = traffic["batch"], traffic["frames"], traffic["seq_len"]
    T = (F - 1) // 2 + 1
    p = matmul_params(cfg)
    dense = 6.0 * B * (p["frames"] * T + p["tokens"] * S + p["conv1"] * F
                       + p["conv2"] * T)
    dh = s["d"] // s["heads"]
    pairs = (s["enc"] * band_pairs(T, T, False)
             + s["dec"] * (band_pairs(S, S, True) + band_pairs(S, T, False)))
    return dense + 12.0 * dh * B * s["heads"] * pairs


def flash_bound_s(shape, backward: bool, sms: int, sm_clock_hz: float
                  ) -> tuple[float, str]:
    """(the least time of one launch, which bound binds): the larger of the
    products at the tensor cores' bf16 rate (forward 4 dh flops a pair in
    the band and a head, QK^T and PV; a backward call 10 dh, QK^T again
    and four gradient products) and the exponentials on the SFUs at the
    card's highest SM clock (one a pair, forward or backward: the least
    work recomputes P once). A backward launch is half its call."""
    B, Sq, Skv, H, _, dh, causal, window, _ = map(int, shape)
    pairs = B * H * band_pairs(Sq, Skv, bool(causal), window)
    share = 0.5 if backward else 1.0
    by_mma = share * (10 if backward else 4) * dh * pairs \
        / yardstick.BF16_FLOPS_PER_S
    by_sfu = share * pairs / (yardstick.SFU_EXP_PER_CLOCK * sms * sm_clock_hz)
    return (by_sfu, "sfu") if by_sfu > by_mma else (by_mma, "products")
