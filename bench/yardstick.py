"""The yardstick: the card's published peaks and the benchmark's own counts
of the bytes and operations a kernel launch or a training step needs.

Nothing here reads the program: the counts are functions of the launch
shapes that the program's counters report (`kernel_launch_shapes()`) and
of the configuration's sizes.
"""

from __future__ import annotations

import math
import subprocess

# NVIDIA H100 SXM data sheet, dense rates, at the full 700 W power limit.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
# The scans' and the scan kernels' arithmetic runs outside the tensor cores;
# the float32 rate outside them stands in as the peak of that work.
ALU_OPS_PER_S = 67e12
# Exponentials an SM's special-function units take a clock (sm_90).
SFU_EXP_PER_CLOCK = 16


# -- the exact scans (K1 and its join lane, K9) ------------------------------

def scan_cost(shape) -> tuple[int, int]:
    """(bytes, operations) of one single-island scan launch.

    ``shape`` is what the scan wrappers count: ``(n, k)`` plus the join's
    ``k_join`` and then ``nq``: n rows of filter codes, aggregate codes
    (int32 each) and validity (a byte) read once, the aggregate dictionary
    (k int32) read once, the nq predicates' bounds (8 B each) read and the
    partial sums (2 or 3 int64 lanes a predicate) written; the join lane
    reads the join codes and their validity (5 B a row) and the join
    column's per-code counts (k_join int32). Per row and predicate a
    compare pair and an add, per row a dictionary gather and a mask; the
    join lane doubles them."""
    n, k, q = int(shape[0]), int(shape[1]), int(shape[-1])
    join = len(shape) == 4
    nbytes = n * (4 + 4 + 1) + k * 4 + q * 8 + (3 if join else 2) * q * 8
    if join:
        nbytes += n * (4 + 1) + int(shape[2]) * 4
    return nbytes, n * (2 * q + 2) * (2 if join else 1)


def scan_bound_s(shape) -> float:
    """The least time one scan launch can take on the card."""
    nbytes, ops = scan_cost(shape)
    return max(nbytes / HBM_BYTES_PER_S, ops / ALU_OPS_PER_S)


# -- the selective scan (K17) and its backward --------------------------------

def ssm_cost(shape) -> tuple[int, int]:
    """(bytes, operations) of the forward at (B, T, D, N): x and dt read
    and y written (12 B per (t, channel)), B_t and C_t (8 N B a step), A
    and the skip; per (t, channel, state) an exponential, three
    multiply-adds and a multiply, and 3 more per (t, channel)."""
    B, T, D, N = map(int, shape)
    return (12 * B * T * D + 8 * B * T * N + 4 * D * (N + 1),
            B * T * D * (7 * N + 3))


def ssm_bwd_cost(shape) -> tuple[int, int]:
    """(bytes, operations) of the backward at (B, T, D, N): x, dt and gy
    read and gx, gdt written (20 B per (t, channel)), B_t and C_t read and
    their gradients written (16 N B a step), A and the skip read and their
    gradients written; per (t, channel, state) the recurrence again to
    re-derive h (5) and the reverse recurrence with its products (19), and
    4 per (t, channel)."""
    B, T, D, N = map(int, shape)
    return (20 * B * T * D + 16 * B * T * N + 8 * D * (N + 1),
            B * T * D * (24 * N + 4))


def ssm_exponentials(shape) -> int:
    """Exponentials a launch must evaluate, forward or backward: one per
    (t, channel, state). The backward's reverse recurrence multiplies by
    the same exp(dt A) that its recompute of h evaluates, so the least
    work takes each once."""
    B, T, D, N = map(int, shape)
    return B * T * D * N


def ssm_bound_s(shape, backward: bool, sms: int, sm_clock_hz: float
                ) -> tuple[float, str]:
    """(the least time, which bound binds): the larger of the bytes at the
    HBM rate and the exponentials on the SFUs at the card's highest SM
    clock."""
    nbytes, _ = (ssm_bwd_cost if backward else ssm_cost)(shape)
    by_bytes = nbytes / HBM_BYTES_PER_S
    by_sfu = ssm_exponentials(shape) / (
        SFU_EXP_PER_CLOCK * sms * sm_clock_hz)
    return (by_sfu, "sfu") if by_sfu > by_bytes else (by_bytes, "bytes")


def max_sm_clock_hz() -> float | None:
    """The card's highest SM clock, as `nvidia-smi` reports it (None where
    it cannot be read)."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                              "--format=csv,noheader,nounits"], check=True,
                             capture_output=True, text=True,
                             timeout=30).stdout
        return float(out.split()[0]) * 1e6
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def power_limit_w() -> float | None:
    """The card's power limit in watts (None where it cannot be read)."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"], check=True,
                             capture_output=True, text=True,
                             timeout=30).stdout
        return float(out.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


# -- a Mamba-1 language model's training step ---------------------------------

def mamba_matmul_params(cfg: dict) -> int:
    """Parameters that enter a matrix product, per the configuration's
    published names: each layer's in_proj (d -> 2 d_inner), x_proj
    (d_inner -> dt_rank + 2 N), dt_proj (dt_rank -> d_inner) and out_proj
    (d_inner -> d), and the output head (d -> vocab). The embedding is a
    lookup and enters no product."""
    d, di = cfg["hidden_size"], cfg["intermediate_size"]
    r, n, v = cfg["time_step_rank"], cfg["state_size"], cfg["vocab_size"]
    layer = d * 2 * di + di * (r + 2 * n) + r * di + di * d
    return cfg["num_hidden_layers"] * layer + d * v


def mamba_train_flops(cfg: dict, tokens: int) -> float:
    """Model flops of one training step over `tokens` tokens: 6 a matmul
    parameter a token (forward 2, backward 4), plus the selective scan's
    own operations forward and backward at every layer (`ssm_cost`,
    `ssm_bwd_cost`) and the causal convolution's multiply-adds (2 a tap a
    channel a token, three times). A remat's recompute is not model work
    and is not counted."""
    di, n = cfg["intermediate_size"], cfg["state_size"]
    shape = (1, tokens, di, n)
    scan = ssm_cost(shape)[1] + ssm_bwd_cost(shape)[1]
    conv = 3 * 2 * cfg["conv_kernel"] * di * tokens
    return (6.0 * mamba_matmul_params(cfg) * tokens
            + cfg["num_hidden_layers"] * (scan + conv))


def share(bound_s: float, time_s: float) -> float | None:
    """100 x bound / time, or None where nothing was timed."""
    if not time_s or not math.isfinite(time_s):
        return None
    return 100.0 * bound_s / time_s
