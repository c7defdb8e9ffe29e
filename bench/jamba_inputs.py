"""Jamba's weights, made from the seed.

The program receives only what these make; the reference makes the same
again from the same seed. Every draw is N(0, 1) float32 on the device from
a generator seeded with (seed, path) (`generators._normal`), scaled, and
cast to the run's parameter type; the reference holds the cast values in
float32.

The tree is the program's (`repro_torch.models.lm.LM` with Jamba's block),
under the names its parameters take: ``embed.table`` (vocab, d), the head
tied to it; ``layers.<i>`` with ``ln1``, ``ln2`` (RMSNorm ``scale``), the
MLP ``mlp`` (``w_gate``, ``w_up``, ``w_down``, each ``{w}``) and either
``attn`` (``wq``, ``wk``, ``wv``, ``wo``, each ``{w}``) or ``mamba``
(``in_proj``, ``x_proj``, ``out_proj`` ``{w}``, ``dt_proj`` ``{w, b}``,
``conv_w``, ``conv_b``, ``a_log``, ``d_skip``, and the norms ``dt_norm``,
``b_norm``, ``c_norm``); ``ln_f``. Matrices are (d_in, d_out).
"""

from __future__ import annotations

import math

import torch

from bench.generators import _normal, flatten


def sizes(cfg: dict) -> dict:
    """The widths and the layer rule, by the configuration's published
    keys; refuses what the block cannot express (experts, a sliding
    window, a projection bias, no conv bias, an untied head, a dt rank
    other than d / 16, an inner width other than expand x d)."""
    d = cfg["hidden_size"]
    if (cfg["num_experts"] != 1 or cfg["sliding_window"] is not None
            or cfg["mamba_proj_bias"] or not cfg["mamba_conv_bias"]
            or not cfg["tie_word_embeddings"] or cfg["hidden_act"] != "silu"
            or cfg["mamba_dt_rank"] != max(1, d // 16)
            or d % cfg["num_attention_heads"]):
        raise ValueError("Jamba's block here takes one expert (a dense MLP), "
                         "no window, no projection bias, a conv bias, a "
                         "tied head, SiLU and dt_rank = hidden_size / 16")
    return dict(d=d, di=cfg["mamba_expand"] * d, ff=cfg["intermediate_size"],
                vocab=cfg["vocab_size"], layers=cfg["num_hidden_layers"],
                heads=cfg["num_attention_heads"],
                kv_heads=cfg["num_key_value_heads"],
                dh=d // cfg["num_attention_heads"],
                r=cfg["mamba_dt_rank"], n=cfg["mamba_d_state"],
                k=cfg["mamba_d_conv"], period=cfg["attn_layer_period"],
                offset=cfg["attn_layer_offset"], eps=cfg["rms_norm_eps"])


def is_attention(cfg: dict, layer: int) -> bool:
    """transformers' ``JambaConfig.layers_block_type``: attention where
    ``layer % attn_layer_period == attn_layer_offset``, Mamba elsewhere."""
    return layer % cfg["attn_layer_period"] == cfg["attn_layer_offset"]


DT_MIN, DT_MAX = 1e-3, 1e-1


def dt_bias(z):
    """Mamba-1's initial dt bias from N(0, 1) draws `z`: dt log-uniform in
    [DT_MIN, DT_MAX] (the uniform by the normal's CDF), and the bias
    softplus^-1(dt) = dt + log(1 - exp(-dt))."""
    u = 0.5 * (1 + torch.erf(z * 2 ** -0.5))
    dt = torch.exp(math.log(DT_MIN) + u * (math.log(DT_MAX)
                                            - math.log(DT_MIN)))
    return dt + torch.log(-torch.expm1(-dt))


def layer_weights(seed: int, cfg: dict, layer: int, dtype, device) -> dict:
    """Layer `layer`'s leaves, its matrices N(0, 1 / fan_in) (the
    convolution's taps 1 / d_conv) in one draw from (seed, layer), cast to
    `dtype`; dt's bias Mamba-1's (`dt_bias`: dt from 0.001 to 0.1), the
    other biases 0; A's log the S4D-real init log(1 .. N) and the skip 1,
    both float32; every norm's scale 1."""
    s, dev = sizes(cfg), torch.device(device)
    d, di, ff = s["d"], s["di"], s["ff"]
    mlp = [(d, ff), (d, ff), (ff, d)]
    if is_attention(cfg, layer):
        hd, kvd = s["heads"] * s["dh"], s["kv_heads"] * s["dh"]
        mix = [(d, hd), (d, kvd), (d, kvd), (hd, d)]
        fans = [d, d, d, hd]
    else:
        mix = [(d, 2 * di), (s["k"], di), (di, s["r"] + 2 * s["n"]),
               (s["r"], di), (di, d), (di,)]
        fans = [d, s["k"], di, s["r"], di, 1]
    w = [(x * f ** -0.5).to(dtype) if len(x.shape) == 2 else x for x, f in
         zip(_normal(seed, (8, layer), mix + mlp, dev), fans + [d, d, ff])]

    def ones(n):
        return {"scale": torch.ones((n,), dtype=dtype, device=dev)}
    out = {"ln1": ones(d), "ln2": ones(d)}
    if is_attention(cfg, layer):
        out["attn"] = {k: {"w": v} for k, v in zip(("wq", "wk", "wv", "wo"),
                                                   w[:4])}
    else:
        out["mamba"] = {
            "in_proj": {"w": w[0]}, "conv_w": w[1],
            "conv_b": torch.zeros((di,), dtype=dtype, device=dev),
            "x_proj": {"w": w[2]},
            "dt_proj": {"w": w[3], "b": dt_bias(w[5]).to(dtype)},
            "out_proj": {"w": w[4]},
            "a_log": torch.log(torch.arange(
                1, s["n"] + 1, dtype=torch.float32, device=dev)).repeat(di, 1),
            "d_skip": torch.ones((di,), dtype=torch.float32, device=dev),
            "dt_norm": ones(s["r"]), "b_norm": ones(s["n"]),
            "c_norm": ones(s["n"])}
    out["mlp"] = {k: {"w": v} for k, v in zip(("w_gate", "w_up", "w_down"),
                                              w[-3:])}
    return out


def outer_weights(seed: int, cfg: dict, dtype, device) -> dict:
    """The token embedding N(0, 1 / d) (the head is tied to it: the logits
    start at unit scale; 1 / sqrt(2,560) is about the published
    initializer's 0.02) and the final norm's scale 1."""
    s, dev = sizes(cfg), torch.device(device)
    (table,) = _normal(seed, (8, s["layers"]), [(s["vocab"], s["d"])], dev)
    return {"embed": {"table": (table * s["d"] ** -0.5).to(dtype)},
            "ln_f": {"scale": torch.ones((s["d"],), dtype=dtype,
                                         device=dev)}}


def all_weights(seed: int, cfg: dict, dtype, device) -> dict:
    """Every leaf, flat under the program's parameter names."""
    out = flatten(outer_weights(seed, cfg, dtype, device))
    for i in range(sizes(cfg)["layers"]):
        out.update(flatten(layer_weights(seed, cfg, i, dtype, device),
                           f"layers.{i}."))
    return out
