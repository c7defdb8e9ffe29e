"""whisper's training steps (arXiv:2212.04356, the published
whisper-large-v3 block), in plain PyTorch, float32.

The configuration's semantics. Encoder: log-mel frames (B, n_mels, 2 T)
through ``gelu(conv1(x))`` (kernel 3, padding 1) and ``gelu(conv2(x))``
(kernel 3, stride 2, padding 1) to (B, T, d), plus the fixed sinusoids
(sines then cosines of ``t / 10000^(i / (d / 2 - 1))``); per layer ``x +
attn(ln1(x))`` and ``x + fc2(gelu(fc1(ln2(x))))``; then ``ln_enc``
(whisper's ``ln_post``). Decoder: the token embedding plus the learned
positions; per layer a causal self-attention, a cross attention over the
encoder's output (each ``x + attn(ln(x))``) and the MLP; then ``ln_f`` and
the logits through the token embedding (a tied head). LayerNorm has a bias
and eps 1e-5; attention has q, v and out biases and none on k, softmax at
scale dh^-0.5 (whisper's dh^-0.25 on q and on k). The loss is the mean
next-token cross entropy. AdamW as the configuration states
(bias-corrected moments, decoupled weight decay on every leaf).

Departures from the published model, all shared with the program: the
weights are drawn from the seed (`bench.whisper_inputs`), not whisper's
trained ones, and held in float32 after a cast to the run's bfloat16 (the
published checkpoint is float16); the log-mel input is drawn from the seed
too; no dropout (whisper trains without it); no loss mask.

Written for the card's memory, not as the program does it: the
convolutions are sums of shifted matrix products; each layer is
recomputed in the backward (`torch.utils.checkpoint`); attention is
computed one block of `Q_BLOCK` query rows at a time, so the scores of a
whole (B, H, T, T) never live at once. Matrix products run with TF32 off.

``precision="fp8"`` is the control: every matrix product's two operands
(attention's too) are rounded to float8 e4m3 with a per-tensor scale (amax
/ 448) in the forward, the gradient passing straight through.

Nothing here imports or reads the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from bench import whisper_inputs
from bench.reference import mamba_lm
from bench.reference.mamba_lm import _Fp8

LN_EPS = 1e-5
Q_BLOCK = 512


def sinusoids(length: int, channels: int, device) -> torch.Tensor:
    inc = math.log(10000) / (channels // 2 - 1)
    inv = torch.exp(-inc * torch.arange(channels // 2, dtype=torch.float32,
                                        device=device))
    t = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    return torch.cat([torch.sin(t * inv), torch.cos(t * inv)], dim=1)


class Model:
    def __init__(self, cfg: dict, precision: str = "float32"):
        if precision not in ("float32", "fp8"):
            raise ValueError(precision)
        self.cfg = cfg
        self.s = whisper_inputs.sizes(cfg)
        self.fp8 = precision == "fp8"

    def mm(self, x, w):
        if self.fp8:
            x, w = _Fp8.apply(x), _Fp8.apply(w)
        return x @ w

    def dense(self, p, x):
        y = self.mm(x, p["w"])
        return y + p["b"] if "b" in p else y

    @staticmethod
    def ln(p, x):
        return F.layer_norm(x, (x.shape[-1],), p["scale"], p["bias"], LN_EPS)

    def conv(self, x, p, stride: int):
        """x (B, T, d_in) -> (B, T_out, d_out): kernel 3, padding 1; tap j
        of output t reads input stride * t + j - 1."""
        T = x.shape[1]
        xp = F.pad(x, (0, 0, 1, 1))
        n = (T - 1) // stride + 1
        out = p["b"]
        for j in range(3):
            tap = xp[:, j:j + stride * (n - 1) + 1:stride]
            out = out + self.mm(tap, p["w"][:, :, j].t())
        return out

    def attention(self, p, x, ctx, causal: bool):
        B, S, d = x.shape
        H = self.s["heads"]
        dh = d // H
        T = ctx.shape[1]
        q = self.dense(p["wq"], x).view(B, S, H, dh).transpose(1, 2)
        k = self.dense(p["wk"], ctx).view(B, T, H, dh).transpose(1, 2)
        v = self.dense(p["wv"], ctx).view(B, T, H, dh).transpose(1, 2)
        outs = []
        for q0 in range(0, S, Q_BLOCK):
            qb = q[:, :, q0:q0 + Q_BLOCK]
            s = self.mm(qb, k.transpose(2, 3)) * dh ** -0.5
            if causal:
                rows = q0 + torch.arange(qb.shape[2], device=x.device)
                cols = torch.arange(T, device=x.device)
                s = s.masked_fill(cols[None, :] > rows[:, None],
                                  float("-inf"))
            outs.append(self.mm(torch.softmax(s, -1), v))
        o = torch.cat(outs, 2).transpose(1, 2).reshape(B, S, d)
        return self.dense(p["wo"], o)

    def mlp(self, p, x):
        return self.dense(p["fc2"], F.gelu(self.dense(p["fc1"], x)))

    def enc_layer(self, x, p):
        h = self.ln(p["ln1"], x)
        x = x + self.attention(p["attn"], h, h, False)
        return x + self.mlp(p["mlp"], self.ln(p["ln2"], x))

    def dec_layer(self, x, ctx, p):
        h = self.ln(p["ln1"], x)
        x = x + self.attention(p["attn"], h, h, True)
        x = x + self.attention(p["xattn"], self.ln(p["lnx"], x), ctx, False)
        return x + self.mlp(p["mlp"], self.ln(p["ln2"], x))

    def encode(self, w: dict, mel):
        f = w["frontend"]
        x = F.gelu(self.conv(mel.transpose(1, 2), f["conv1"], 1))
        x = F.gelu(self.conv(x, f["conv2"], 2))
        x = x + sinusoids(x.shape[1], x.shape[2], x.device)
        for p in w["enc"]:
            x = checkpoint(self.enc_layer, x, p, use_reentrant=False)
        return self.ln(w["ln_enc"], x)

    def hidden(self, w: dict, mel, tokens):
        ctx = self.encode(w, mel)
        x = w["embed"]["table"][tokens.long()] + \
            w["embed"]["pos"][:tokens.shape[1]]
        for p in w["dec"]:
            x = checkpoint(self.dec_layer, x, ctx, p, use_reentrant=False)
        return self.ln(w["ln_f"], x)

    def logits(self, w: dict, mel, tokens):
        return self.mm(self.hidden(w, mel, tokens), w["embed"]["table"].t())

    def loss(self, w: dict, mel, tokens, labels):
        logits = self.logits(w, mel, tokens)
        return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               labels.reshape(-1).long())


def initial_weights(seed: int, cfg: dict, dtype, device) -> dict:
    """The weights both sides start from: the benchmark's draw from the
    seed in the run's parameter type, held here in float32, flat."""
    return {k: v.to(torch.float32) for k, v in
            whisper_inputs.all_weights(seed, cfg, dtype, device).items()}


def nest(flat: dict) -> dict:
    out = {}
    for k, v in flat.items():
        node = out
        parts = k.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = v
    for stack in ("enc", "dec"):
        out[stack] = [out[stack][str(i)] for i in range(len(out[stack]))]
    return out


def train(seed: int, cfg: dict, job: dict, batches: list, frames: int,
          device, precision: str = "float32", against: dict | None = None,
          keep_grads: bool = False) -> dict:
    """Follow len(batches) training steps from the seed's weights. Each
    batch is (tokens, labels) int32 (B, S); step i's log-mel input is
    `whisper_inputs.mel`'s (seed, i) draw of `frames` frames, rounded to
    the run's type as the program receives it. The batch splits into the
    job's micro-batches (the loss and gradient are their mean). Returns
    the steps' losses, the first step's gradient norm per leaf, and the
    norm of each leaf's change after the last step; with `against` (the
    first step's gradient per leaf of another run, float32 on the host)
    also each leaf's ``grad_errors``, ``|g - g_ref| / |g_ref|`` with this
    run's gradient as g_ref; with `keep_grads` also the first step's
    gradients (``grads``, float32 on the host)."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _train(seed, cfg, job, batches, frames, torch.device(device),
                      precision, against, keep_grads)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def _first_step(w: dict, against, keep_grads: bool) -> dict:
    """What the first step's gradient gives: each leaf's norm, and as
    `train` says its error against another run's and a host copy."""
    out = {"grad_norms": {k: float(v.grad.norm()) for k, v in w.items()}}
    if against is not None:
        out["grad_errors"] = {
            k: float((against[k].to(v.device) - v.grad).norm())
            / max(out["grad_norms"][k], 1e-30) for k, v in w.items()}
    if keep_grads:
        out["grads"] = {k: v.grad.to("cpu", copy=True) for k, v in w.items()}
    return out


def _train(seed, cfg, job, batches, frames, dev, precision, against,
           keep_grads):
    model = Model(cfg, precision)
    dtype = getattr(torch, job["dtype"])
    w = initial_weights(seed, cfg, dtype, dev)
    w0 = {k: v.clone() for k, v in w.items()}
    for v in w.values():
        v.requires_grad_(True)
    tree = nest(w)
    opt = job["optimizer"]
    b1, b2, eps = opt["b1"], opt["b2"], opt["eps"]
    lr, wd = opt["lr"], opt["weight_decay"]
    m = {k: torch.zeros_like(v) for k, v in w.items()}
    s = {k: torch.zeros_like(v) for k, v in w.items()}
    micro = job["micro_batches"]
    losses, first = [], None
    for step, (tokens, labels) in enumerate(batches):
        tokens = torch.as_tensor(np.asarray(tokens), device=dev)
        labels = torch.as_tensor(np.asarray(labels), device=dev)
        mel = whisper_inputs.mel(seed, step, tokens.shape[0], frames, cfg,
                                 dev).to(dtype).float()
        part = tokens.shape[0] // micro
        total = 0.0
        for i in range(micro):
            sl = slice(i * part, (i + 1) * part)
            loss = model.loss(tree, mel[sl], tokens[sl], labels[sl]) / micro
            loss.backward()
            total += float(loss.detach())
        del mel
        losses.append(total)
        with torch.no_grad():
            for v in w.values():
                if v.grad is None:        # a leaf the loss does not reach
                    v.grad = torch.zeros_like(v)
            if first is None:
                first = _first_step(w, against, keep_grads)
            t = step + 1
            for k, v in w.items():
                g = v.grad
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                s[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                u = (m[k] / (1 - b1 ** t)) / (
                    torch.sqrt(s[k] / (1 - b2 ** t)) + eps) + wd * v
                v.sub_(lr * u)
                v.grad = None
    with torch.no_grad():
        change = {k: float((w[k] - w0[k]).norm()) for k in w}
    return {"losses": losses, **first, "change_norms": change}


def compare(got: dict, want: dict) -> dict:
    """`mamba_lm.compare`'s gaps, and where `want` holds ``grad_errors``
    the median of them over the leaves that those gaps keep
    (``grad_error``: the first step's gradient against the reference's,
    element by element, ``|g - g_ref| / |g_ref|``, where the norm gaps see
    only lengths), with its worst leaf."""
    out = mamba_lm.compare(got, want)
    errs = want.get("grad_errors")
    if errs:
        keep = {k: e for k, e in errs.items() if k not in out["skipped"]}
        out["grad_error"] = float(np.median(list(keep.values())))
        out["grad_error_worst_leaf"] = max(keep, key=keep.get)
    return out
