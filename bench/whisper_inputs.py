"""whisper's weights and log-mel frames, made from the seed.

The program receives only what these make; the reference makes the same
again from the same seed. Every draw is N(0, 1) float32 on the device from
a generator seeded with (seed, path) (`generators._normal`), scaled, and
cast to the configuration's parameter type; the reference holds the cast
values in float32.

The tree is the program's (`repro_torch.models.encdec.EncDec` with
whisper's block), under the names its parameters take: ``embed.table``
(vocab, d) and ``embed.pos`` (decoder positions, d), ``frontend.conv1`` /
``frontend.conv2`` (``w`` (d_out, d_in, 3), ``b``), ``enc.<i>`` and
``dec.<i>`` (``ln1``, ``attn``, ``ln2``, ``mlp``; the decoder's also
``lnx`` and ``xattn``; LayerNorms ``scale`` and ``bias``; attentions
``wq`` ``{w, b}``, ``wk`` ``{w}``, ``wv`` ``{w, b}``, ``wo`` ``{w, b}``,
matrices (d_in, d_out); the MLP ``fc1``, ``fc2`` ``{w, b}``), ``ln_enc``
and ``ln_f``.
"""

from __future__ import annotations

import torch

from bench.generators import _normal, flatten


def sizes(cfg: dict) -> dict:
    """The widths, by the configuration's published keys; refuses what the
    block cannot express (the two stacks at other head counts or MLP
    widths, an activation other than exact GELU)."""
    if (cfg["encoder_attention_heads"] != cfg["decoder_attention_heads"]
            or cfg["encoder_ffn_dim"] != cfg["decoder_ffn_dim"]
            or cfg["activation_function"] != "gelu"
            or cfg["d_model"] % cfg["encoder_attention_heads"]):
        raise ValueError("whisper's block here takes one head count, one MLP "
                         "width and exact GELU for both stacks")
    return dict(d=cfg["d_model"], heads=cfg["encoder_attention_heads"],
                ff=cfg["encoder_ffn_dim"], vocab=cfg["vocab_size"],
                mels=cfg["num_mel_bins"], enc=cfg["encoder_layers"],
                dec=cfg["decoder_layers"],
                positions=cfg["max_target_positions"])


def _attn(w: list, d: int, dtype, dev) -> dict:
    def zeros():
        return torch.zeros((d,), dtype=dtype, device=dev)
    return {"wq": {"w": w[0], "b": zeros()}, "wk": {"w": w[1]},
            "wv": {"w": w[2], "b": zeros()}, "wo": {"w": w[3], "b": zeros()}}


def _ln(d: int, dtype, dev) -> dict:
    return {"scale": torch.ones((d,), dtype=dtype, device=dev),
            "bias": torch.zeros((d,), dtype=dtype, device=dev)}


def layer_weights(seed: int, cfg: dict, stack: str, layer: int, dtype,
                  device) -> dict:
    """Layer `layer` of the ``"enc"`` or ``"dec"`` stack, its matrices
    N(0, 1 / fan_in) in one draw from (seed, stack, layer); biases 0,
    LayerNorms 1 and 0."""
    s, dev = sizes(cfg), torch.device(device)
    d, ff = s["d"], s["ff"]
    n_attn = 2 if stack == "dec" else 1
    shapes = [(d, d)] * (4 * n_attn) + [(d, ff), (ff, d)]
    fans = [d] * (4 * n_attn) + [d, ff]
    path = (1 if stack == "enc" else 2, layer)
    w = [(x * f ** -0.5).to(dtype)
         for x, f in zip(_normal(seed, path, shapes, dev), fans)]
    out = {"ln1": _ln(d, dtype, dev), "attn": _attn(w[:4], d, dtype, dev)}
    if stack == "dec":
        out["lnx"] = _ln(d, dtype, dev)
        out["xattn"] = _attn(w[4:8], d, dtype, dev)
    out["ln2"] = _ln(d, dtype, dev)
    out["mlp"] = {"fc1": {"w": w[-2], "b": torch.zeros((ff,), dtype=dtype,
                                                       device=dev)},
                  "fc2": {"w": w[-1], "b": torch.zeros((d,), dtype=dtype,
                                                       device=dev)}}
    return out


def outer_weights(seed: int, cfg: dict, dtype, device) -> dict:
    """The token embedding and the decoder's positions N(0, 1 / d) (the
    head is tied to the embedding: the logits start at unit scale), the
    convolutions N(0, 1 / (3 d_in)) with biases 0, and the two final
    LayerNorms; each matrix in one call."""
    s, dev = sizes(cfg), torch.device(device)
    d = s["d"]
    (table,) = _normal(seed, (0, 0), [(s["vocab"], d)], dev)
    (pos,) = _normal(seed, (0, 1), [(s["positions"], d)], dev)
    (c1,) = _normal(seed, (0, 2), [(d, s["mels"], 3)], dev)
    (c2,) = _normal(seed, (0, 3), [(d, d, 3)], dev)

    def zeros():
        return torch.zeros((d,), dtype=dtype, device=dev)
    return {"embed": {"table": (table * d ** -0.5).to(dtype),
                      "pos": (pos * d ** -0.5).to(dtype)},
            "frontend": {
                "conv1": {"w": (c1 * (3 * s["mels"]) ** -0.5).to(dtype),
                          "b": zeros()},
                "conv2": {"w": (c2 * (3 * d) ** -0.5).to(dtype),
                          "b": zeros()}},
            "ln_enc": _ln(d, dtype, dev), "ln_f": _ln(d, dtype, dev)}


def all_weights(seed: int, cfg: dict, dtype, device) -> dict:
    """Every leaf, flat under the program's parameter names."""
    s = sizes(cfg)
    out = flatten(outer_weights(seed, cfg, dtype, device))
    for stack in ("enc", "dec"):
        for i in range(s[stack]):
            out.update(flatten(layer_weights(seed, cfg, stack, i, dtype,
                                             device), f"{stack}.{i}."))
    return out


def mel(seed: int, step: int, batch: int, frames: int, cfg: dict,
        device) -> torch.Tensor:
    """Training step `step`'s log-mel input, (batch, num_mel_bins, frames)
    float32 N(0, 1) (whisper normalises its log-mel to about unit scale),
    one draw from (seed, step)."""
    (x,) = _normal(seed, (3, step), [(batch, cfg["num_mel_bins"], frames)],
                   torch.device(device))
    return x
