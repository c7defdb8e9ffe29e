"""AI21-Jamba2-3B's training steps (arXiv:2403.19887; the published
``ai21labs/AI21-Jamba2-3B`` config and transformers' Jamba modules), in
plain PyTorch, float32.

The configuration's semantics. The token embedding; per layer ``x +
mixer(rmsnorm(x))`` and then ``x + mlp(rmsnorm(x))``; then ``rmsnorm`` and
the logits through the token embedding (a tied head); the mean next-token
cross entropy. Layer i's mixer is attention where ``i % attn_layer_period
== attn_layer_offset``, Mamba elsewhere (transformers'
``layers_block_type``). RMSNorm is ``x / sqrt(mean(x^2) + rms_norm_eps) *
scale``. The MLP is SwiGLU, ``w_down(silu(w_gate x) * w_up x)``; with one
expert every layer's MLP is this dense one. Attention: 20 query heads of
128 over one KV head (multi-query), causal, softmax at scale dh^-0.5, no
positional encoding and no bias. The Mamba mixer (``JambaMambaMixer``):
``(x_in, z) = in_proj(h)``, ``u = silu(causal depthwise conv(x_in) +
bias)``, ``(dt_r, B, C) = x_proj(u)``, each of the three through its own
RMS norm, ``dt = softplus(dt_proj(dt_r) + bias)``, ``A = -exp(a_log)`` and
the selective scan

    h_t = exp(dt_t A) h_{t-1} + dt_t u_t B_t,   y_t = C_t . h_t + D u_t,

then ``out_proj(y * silu(z))``. AdamW as the configuration states
(bias-corrected moments, decoupled weight decay on every leaf).

Departures from the published model, all shared with the program: the
weights are drawn from the seed (`bench.jamba_inputs`), not AI21's trained
ones, and held in float32 after a cast to the run's bfloat16; no document
mask (the batch is one packed sequence); no dropout. The program applies
each norm's scale in float32 before its cast to bfloat16, where
transformers casts first: in float32 the two are one.

Written for the card's memory and time at 32,768 tokens, not as the
program does it: every layer is recomputed in the backward
(`torch.utils.checkpoint`); the scan runs `SCAN_CHANNELS` channels at a
time, each block under its own checkpoint (one layer's states whole are
10.7 GB in float32), in chunks of `SCAN_CHUNK` steps: the recurrence from
a zero state inside every chunk at once, then the state carried into each
chunk by a prefix scan over the chunks (log2 of their number in steps),
then each output's share of that carried state, C_t . (exp(A sum of dt
since the chunk began) h_carry); attention is computed one block of
`Q_BLOCK` query rows at a time, each under a checkpoint, against the keys
up to the block's last row; the loss one block of `LOSS_ROWS` positions at
a time, likewise. AdamW's moments live in the host's memory (pinned on a
card) and visit the device a leaf at a time for the update, so that the
device holds the weights, their gradients and one layer's recompute. The
initial weights are drawn again from the seed where the change of each
leaf is read, not kept. Matrix products run with TF32 off.

``precision="fp8"`` is the control: every matrix product's two operands
(attention's and the head's too) are rounded to float8 e4m3 with a
per-tensor scale (amax / 448) in the forward, the gradient passing
straight through.

Nothing here imports or reads the program.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from bench import generators, jamba_inputs
from bench.reference import whisper_lm
from bench.reference.mamba_lm import _Fp8

SCAN_CHANNELS = 512
SCAN_CHUNK = 16
Q_BLOCK = 512
LOSS_ROWS = 2048


def _ckpt(fn, *args):
    return checkpoint(fn, *args, use_reentrant=False)


def scan_block(u, dt, A, Bm, Cm, D):
    """h_t = exp(dt_t A) h_{t-1} + dt_t u_t B_t from h_0 = 0, y_t = C_t .
    h_t + D u_t: u, dt (B, T, Dc), A (Dc, N), Bm, Cm (B, T, N), D (Dc,) ->
    y (B, T, Dc). In chunks of `SCAN_CHUNK` steps: each chunk's states from
    a zero state (a loop over the chunk's steps, all chunks at once); the
    state each chunk starts from by an inclusive prefix scan over the
    chunks of the pairs (decay over the chunk, its end state from zero),
    shifted by one; and each step's output plus C_t . (exp(A cumsum(dt))
    h_carry), the carried state decayed to the step."""
    Bsz, T, Dc = u.shape
    N = A.shape[1]
    L = SCAN_CHUNK if T % SCAN_CHUNK == 0 else T
    nc = T // L
    dtv = dt.view(Bsz, nc, L, Dc)
    xv = (dt * u).view(Bsz, nc, L, Dc)
    bv = Bm.view(Bsz, nc, L, N)
    cv = Cm.view(Bsz, nc, L, N)
    h = u.new_zeros((Bsz, nc, Dc, N))
    ys = []
    for step in range(L):
        h = (torch.exp(dtv[:, :, step, :, None] * A) * h
             + xv[:, :, step, :, None] * bv[:, :, step, None, :])
        ys.append((h * cv[:, :, step, None, :]).sum(-1))
    y = torch.stack(ys, 2)                               # (B, nc, L, Dc)
    # (a, b): a chunk's decay and its end state from zero; composed in
    # order, (a2, b2) after (a1, b1) is (a2 a1, a2 b1 + b2)
    a, b = torch.exp(dtv.sum(2)[..., None] * A), h       # (B, nc, Dc, N)
    shift = 1
    while shift < nc:
        b = b + a * F.pad(b[:, :-shift], (0, 0, 0, 0, shift, 0))
        a = a * F.pad(a[:, :-shift], (0, 0, 0, 0, shift, 0), value=1.0)
        shift *= 2
    carry = F.pad(b[:, :-1], (0, 0, 0, 0, 1, 0))        # state at chunk start
    decay = torch.exp(dtv.cumsum(2)[..., None] * A)      # (B, nc, L, Dc, N)
    y = y + (decay * carry[:, :, None] * cv[:, :, :, None, :]).sum(-1)
    return y.reshape(Bsz, T, Dc) + u * D


class Model:
    def __init__(self, cfg: dict, precision: str = "float32"):
        if precision not in ("float32", "fp8"):
            raise ValueError(precision)
        self.cfg = cfg
        self.s = jamba_inputs.sizes(cfg)
        self.fp8 = precision == "fp8"

    def mm(self, x, w):
        if self.fp8:
            x, w = _Fp8.apply(x), _Fp8.apply(w)
        return x @ w

    def rmsnorm(self, x, scale):
        return x * torch.rsqrt(x.square().mean(-1, keepdim=True)
                               + self.s["eps"]) * scale

    @staticmethod
    def scan(u, dt, A, Bm, Cm, D):
        """The selective scan, `SCAN_CHANNELS` channels at a time."""
        outs = []
        for c0 in range(0, u.shape[-1], SCAN_CHANNELS):
            sl = slice(c0, c0 + SCAN_CHANNELS)
            outs.append(_ckpt(scan_block, u[..., sl].contiguous(),
                              dt[..., sl].contiguous(), A[sl], Bm, Cm, D[sl]))
        return torch.cat(outs, -1)

    def mamba(self, m, h):
        s = self.s
        di, r, n = s["di"], s["r"], s["n"]
        xz = self.mm(h, m["in_proj"]["w"])
        xin, z = xz[..., :di], xz[..., di:]
        K, T = m["conv_w"].shape[0], h.shape[1]
        xp = F.pad(xin, (0, 0, K - 1, 0))
        conv = sum(xp[:, i:i + T] * m["conv_w"][i] for i in range(K))
        u = F.silu(conv + m["conv_b"])
        proj = self.mm(u, m["x_proj"]["w"])
        dt_r = self.rmsnorm(proj[..., :r], m["dt_norm"]["scale"])
        bm = self.rmsnorm(proj[..., r:r + n], m["b_norm"]["scale"])
        cm = self.rmsnorm(proj[..., r + n:], m["c_norm"]["scale"])
        dt = F.softplus(self.mm(dt_r, m["dt_proj"]["w"]) + m["dt_proj"]["b"])
        y = self.scan(u, dt, -torch.exp(m["a_log"]), bm, cm, m["d_skip"])
        return self.mm(y * F.silu(z), m["out_proj"]["w"])

    def _attend(self, qb, k, v, q0: int):
        """Query rows q0 .. q0 + len of every head against the keys up to
        the last of them: qb (B, Hkv, G, n, dh), k and v (B, Hkv, 1, S,
        dh)."""
        n, dh = qb.shape[-2], qb.shape[-1]
        T = q0 + n
        s = self.mm(qb, k[..., :T, :].transpose(-1, -2)) * dh ** -0.5
        rows = q0 + torch.arange(n, device=qb.device)
        cols = torch.arange(T, device=qb.device)
        s = s.masked_fill(cols[None, :] > rows[:, None], float("-inf"))
        return self.mm(torch.softmax(s, -1), v[..., :T, :])

    def attention(self, p, h):
        s = self.s
        B, S, _ = h.shape
        H, Hkv, dh = s["heads"], s["kv_heads"], s["dh"]
        q = self.mm(h, p["wq"]["w"]).view(B, S, Hkv, H // Hkv, dh)
        q = q.permute(0, 2, 3, 1, 4)                        # (B,Hkv,G,S,dh)
        k, v = (self.mm(h, p[n]["w"]).view(B, S, Hkv, dh).transpose(1, 2)
                [:, :, None] for n in ("wk", "wv"))       # (B,Hkv,1,S,dh)
        o = torch.cat([_ckpt(self._attend, q[..., q0:q0 + Q_BLOCK, :], k, v,
                             q0) for q0 in range(0, S, Q_BLOCK)], -2)
        o = o.permute(0, 3, 1, 2, 4).reshape(B, S, H * dh)
        return self.mm(o, p["wo"]["w"])

    def mlp(self, p, h):
        return self.mm(F.silu(self.mm(h, p["w_gate"]["w"]))
                       * self.mm(h, p["w_up"]["w"]), p["w_down"]["w"])

    def layer(self, x, p, attention: bool):
        h = self.rmsnorm(x, p["ln1"]["scale"])
        x = x + (self.attention(p["attn"], h) if attention
                 else self.mamba(p["mamba"], h))
        return x + self.mlp(p["mlp"], self.rmsnorm(x, p["ln2"]["scale"]))

    def hidden(self, w: dict, tokens):
        x = w["embed"]["table"][tokens.long()]
        for i, p in enumerate(w["layers"]):
            x = _ckpt(self.layer, x, p, jamba_inputs.is_attention(self.cfg, i))
        return self.rmsnorm(x, w["ln_f"]["scale"])

    def logits(self, w: dict, tokens):
        return self.mm(self.hidden(w, tokens), w["embed"]["table"].t())

    def _ce(self, x, table, labels):
        logits = self.mm(x, table.t())
        return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               labels.reshape(-1).long(), reduction="sum")

    def loss(self, w: dict, tokens, labels):
        x = self.hidden(w, tokens)
        table = w["embed"]["table"]
        total = x.new_zeros(())
        for i in range(0, x.shape[1], LOSS_ROWS):
            total = total + _ckpt(self._ce, x[:, i:i + LOSS_ROWS], table,
                                  labels[:, i:i + LOSS_ROWS])
        return total / labels.numel()


def initial_weights(seed: int, cfg: dict, dtype, device) -> dict:
    """The weights both sides start from: the benchmark's draw from the
    seed in the run's parameter type, held here in float32, flat."""
    return {k: v.to(torch.float32) for k, v in
            jamba_inputs.all_weights(seed, cfg, dtype, device).items()}


def nest(flat: dict) -> dict:
    out = {}
    for k, v in flat.items():
        node = out
        parts = k.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = v
    out["layers"] = [out["layers"][str(i)] for i in range(len(out["layers"]))]
    return out


def change_norms(seed: int, cfg: dict, dtype, w: dict) -> dict:
    """Each leaf's change: `w` less the initial weights, drawn again from
    the seed a layer at a time."""
    dev = next(iter(w.values())).device
    out = {}

    def add(tree, prefix=""):
        for k, v in generators.flatten(tree, prefix).items():
            out[k] = float((w[k] - v.float()).norm())
    add(jamba_inputs.outer_weights(seed, cfg, dtype, dev))
    for i in range(jamba_inputs.sizes(cfg)["layers"]):
        add(jamba_inputs.layer_weights(seed, cfg, i, dtype, dev),
            f"layers.{i}.")
    return out


def train(seed: int, cfg: dict, job: dict, batches: list, device,
          precision: str = "float32", against: dict | None = None,
          keep_grads: bool = False) -> dict:
    """Follow len(batches) training steps from the seed's weights. Each
    batch is (tokens, labels) int32 (B, S), split into the job's
    micro-batches (the loss and gradient are their mean). Returns the
    steps' losses, the first step's gradient norm per leaf, and the norm
    of each leaf's change after the last step; with `against` (the first
    step's gradient per leaf of another run, float32 on the host) also
    each leaf's ``grad_errors``, ``|g - g_ref| / |g_ref|``; with
    `keep_grads` also the first step's gradients (``grads``, float32 on
    the host)."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _train(seed, cfg, job, batches, torch.device(device),
                      precision, against, keep_grads)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def _train(seed, cfg, job, batches, dev, precision, against, keep_grads):
    model = Model(cfg, precision)
    dtype = getattr(torch, job["dtype"])
    w = initial_weights(seed, cfg, dtype, dev)
    for v in w.values():
        v.requires_grad_(True)
    tree = nest(w)
    opt = job["optimizer"]
    b1, b2, eps = opt["b1"], opt["b2"], opt["eps"]
    lr, wd = opt["lr"], opt["weight_decay"]
    # AdamW's moments on the host (pinned on a card), a leaf at a time on
    # the device for its update
    pin = dev.type == "cuda"
    m = {k: torch.zeros(v.shape, pin_memory=pin) for k, v in w.items()}
    s = {k: torch.zeros(v.shape, pin_memory=pin) for k, v in w.items()}
    micro = job["micro_batches"]
    losses, first = [], None
    for step, (tokens, labels) in enumerate(batches):
        tokens = torch.as_tensor(np.asarray(tokens), device=dev)
        labels = torch.as_tensor(np.asarray(labels), device=dev)
        part = tokens.shape[0] // micro
        total = 0.0
        for i in range(micro):
            sl = slice(i * part, (i + 1) * part)
            loss = model.loss(tree, tokens[sl], labels[sl]) / micro
            loss.backward()
            total += float(loss.detach())
        losses.append(total)
        with torch.no_grad():
            for v in w.values():
                if v.grad is None:        # a leaf the loss does not reach
                    v.grad = torch.zeros_like(v)
            if first is None:
                first = whisper_lm._first_step(w, against, keep_grads)
            t = step + 1
            for k, v in w.items():
                g = v.grad
                mk = m[k].to(dev, non_blocking=True)
                sk = s[k].to(dev, non_blocking=True)
                mk.mul_(b1).add_(g, alpha=1 - b1)
                sk.mul_(b2).addcmul_(g, g, value=1 - b2)
                u = (mk / (1 - b1 ** t)) / (
                    torch.sqrt(sk / (1 - b2 ** t)) + eps) + wd * v
                v.sub_(lr * u)
                v.grad = None
                m[k].copy_(mk, non_blocking=True)
                s[k].copy_(sk, non_blocking=True)
            if pin:
                torch.cuda.synchronize(dev)
    del m, s
    with torch.no_grad():
        change = change_norms(seed, cfg, dtype, w)
    return {"losses": losses, **first, "change_norms": change}


# the numbers compared: whisper's cell's (`mamba_lm.compare`'s norm gaps
# and the gradient's element-wise error)
compare = whisper_lm.compare
