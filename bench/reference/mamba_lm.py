"""A Mamba-1 language model's training steps, in plain PyTorch, float32.

The configuration's semantics: token embedding; per layer
``x + out_proj(y * silu(z))`` where ``(x_in, z) = in_proj(rmsnorm(x))``,
``u = silu(causal depthwise conv(x_in) + bias)``, ``(dt_r, B, C) =
x_proj(u)``, ``dt = softplus(dt_proj(dt_r) + bias)``, ``A = -exp(a_log)``
and the selective scan

    h_t = exp(dt_t A) h_{t-1} + dt_t u_t B_t,   y_t = C_t . h_t + D u_t;

then rmsnorm, the head, and the mean next-token cross entropy. RMSNorm is
``x / sqrt(mean(x^2) + 1e-6) * scale``. AdamW as the configuration states
(bias-corrected moments, decoupled weight decay on every leaf).

The scan is written for speed in plain operations, not as the kernel
does it: the sequence is cut into chunks of `CHUNK` steps; a first pass
runs every chunk from a zero state at once, a pass over the chunks
carries each chunk's end state into the next (the chunk's decay is
``exp(A sum dt)``), and a second pass runs every chunk again from its
true start state and reads y. Autograd differentiates it. Matrix products
run with TF32 off. Each layer is recomputed in the backward
(`torch.utils.checkpoint`) so that one layer's scan at a time holds its
saved states.

``precision="fp8"`` is the control: every matrix product's two operands
are rounded to float8 e4m3 with a per-tensor scale (amax / 448) in the
forward, the gradient passing straight through.

Nothing here imports or reads the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from bench import generators

CHUNK = 64
NORM_EPS = 1e-6


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        amax = x.detach().abs().amax().clamp(min=1e-30)
        scale = amax / 448.0
        return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale

    @staticmethod
    def backward(ctx, g):
        return g


class Model:
    def __init__(self, cfg: dict, precision: str = "float32"):
        self.cfg = cfg
        self.fp8 = precision == "fp8"
        if precision not in ("float32", "fp8"):
            raise ValueError(precision)

    def mm(self, x, w):
        if self.fp8:
            x, w = _Fp8.apply(x), _Fp8.apply(w)
        return x @ w

    @staticmethod
    def rmsnorm(x, scale):
        return x * torch.rsqrt(x.square().mean(-1, keepdim=True)
                               + NORM_EPS) * scale

    @staticmethod
    def scan(u, dt, A, Bm, Cm, D):
        Bsz, T, Dn = u.shape
        N = A.shape[1]
        L = CHUNK if T % CHUNK == 0 else T
        nc = T // L
        dtv = dt.view(Bsz, nc, L, Dn)
        xv = (dt * u).view(Bsz, nc, L, Dn)
        bv = Bm.view(Bsz, nc, L, N)
        cv = Cm.view(Bsz, nc, L, N)
        h = u.new_zeros((Bsz, nc, Dn, N))
        for step in range(L):
            h = (torch.exp(dtv[:, :, step, :, None] * A) * h
                 + xv[:, :, step, :, None] * bv[:, :, step, None, :])
        decay = torch.exp(dtv.sum(2)[..., None] * A)     # (B, nc, D, N)
        carry = [u.new_zeros((Bsz, Dn, N))]
        for c in range(nc - 1):
            carry.append(decay[:, c] * carry[-1] + h[:, c])
        h = torch.stack(carry, 1)
        ys = []
        for step in range(L):
            h = (torch.exp(dtv[:, :, step, :, None] * A) * h
                 + xv[:, :, step, :, None] * bv[:, :, step, None, :])
            ys.append((h * cv[:, :, step, None, :]).sum(-1))
        return torch.stack(ys, 2).reshape(Bsz, T, Dn) + u * D

    def layer(self, x, p):
        cfg = self.cfg
        di, r, n = (cfg["intermediate_size"], cfg["time_step_rank"],
                    cfg["state_size"])
        m = p["mamba"]
        h = self.rmsnorm(x, p["ln1"]["scale"])
        xz = self.mm(h, m["in_proj"]["w"])
        xin, z = xz[..., :di], xz[..., di:]
        K = m["conv_w"].shape[0]
        xp = F.pad(xin, (0, 0, K - 1, 0))
        T = x.shape[1]
        conv = sum(xp[:, i:i + T] * m["conv_w"][i] for i in range(K))
        u = F.silu(conv + m["conv_b"])
        proj = self.mm(u, m["x_proj"]["w"])
        dt_r, bm, cm = proj[..., :r], proj[..., r:r + n], proj[..., r + n:]
        dt = F.softplus(self.mm(dt_r, m["dt_proj"]["w"]) + m["dt_proj"]["b"])
        y = self.scan(u, dt, -torch.exp(m["a_log"]), bm, cm, m["d_skip"])
        return x + self.mm(y * F.silu(z), m["out_proj"]["w"])

    def loss(self, w: dict, tokens, labels):
        x = w["embed"]["table"][tokens.long()]
        for p in w["layers"]:
            x = checkpoint(self.layer, x, p, use_reentrant=False)
        x = self.rmsnorm(x, w["ln_f"]["scale"])
        total = x.new_zeros(())
        S, chunk = x.shape[1], 2048
        for i in range(0, S, chunk):
            logits = self.mm(x[:, i:i + chunk], w["head"]["w"])
            total = total + F.cross_entropy(
                logits.reshape(-1, logits.shape[-1]),
                labels[:, i:i + chunk].reshape(-1).long(), reduction="sum")
        return total / labels.numel()


def initial_weights(seed: int, cfg: dict, device) -> dict:
    """The weights both sides start from: the benchmark's draw from the
    seed in the configuration's parameter type (bfloat16), held here in
    float32."""
    dt = getattr(torch, cfg["torch_dtype"])
    outer = generators.mamba_outer_weights(seed, cfg, dt, device)
    layers = [generators.mamba_layer_weights(seed, cfg, i, dt, device)
              for i in range(cfg["num_hidden_layers"])]
    tree = {**outer, "layers": {str(i): l for i, l in enumerate(layers)}}
    flat = generators.flatten(tree)
    return {k: v.to(torch.float32) for k, v in flat.items()}


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


def train(seed: int, cfg: dict, job: dict, batches: list, device,
          precision: str = "float32") -> dict:
    """Follow len(batches) training steps from the seed's weights. Each
    batch is (tokens, labels) int32 (B, S), split into the job's
    micro-batches (the loss and gradient are their mean). Returns the
    steps' losses, the first step's gradient norm per leaf, and the norm
    of each leaf's change after the last step."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _train(seed, cfg, job, batches, torch.device(device),
                      precision)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def _train(seed, cfg, job, batches, dev, precision):
    model = Model(cfg, precision)
    w = initial_weights(seed, cfg, dev)
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
    losses, grad_norms = [], None
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
            if grad_norms is None:
                grad_norms = {k: float(v.grad.norm()) for k, v in w.items()}
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
    return {"losses": losses, "grad_norms": grad_norms,
            "change_norms": change}


def compare(got: dict, want: dict) -> dict:
    """The numbers compared, each a gap between the program's reading and
    the reference's, as a share of the reference's:

    - loss_gap: the worst step's |loss - loss_ref| / loss_ref;
    - grad_gap: the worst leaf's |norm(g) - norm(g_ref)| / max(norm(g_ref),
      the median leaf's norm(g_ref)), the first step's gradient;
    - grad_median_gap: the median leaf's of the same gaps, steady from seed
      to seed where the worst leaf (a small bias whose gradient sums
      terms that cancel) swings;
    - update_gap: the worst leaf's gap of the norm of each leaf's change
      after the last step.

    Leaves whose reference gradient norm is under a thousandth of the
    median leaf's (a gradient that is nought but for rounding) are left
    out of the gaps; `skipped` names them."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in
                   zip(got["losses"], want["losses"]))
    if len(got["losses"]) != len(want["losses"]):
        loss_gap = math.inf
    gref = want["grad_norms"]
    med = float(np.median(list(gref.values())))
    keep = [k for k in gref if gref[k] >= 1e-3 * med]
    skipped = sorted(set(gref) - set(keep))

    def gaps(a, b):
        """(the worst gap, its leaf, the median gap) over the kept leaves."""
        base = float(np.median([b[k] for k in keep]))
        each = {k: (abs(a[k] - b[k]) / max(b[k], base) if k in a
                    else math.inf) for k in keep}
        leaf = max(each, key=each.get)
        return each[leaf], leaf, float(np.median(list(each.values())))

    grad_gap, grad_leaf, grad_med = gaps(got["grad_norms"], gref)
    upd_gap, upd_leaf, _ = gaps(got["change_norms"], want["change_norms"])
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "grad_median_gap": grad_med, "grad_worst_leaf": grad_leaf,
            "update_gap": upd_gap, "update_worst_leaf": upd_leaf,
            "skipped": skipped}
