"""Assigned architecture configs (+ reduced smoke variants) and input shapes.

Every module exports CONFIG (the exact assigned architecture) and SMOKE
(a reduced same-family config for CPU tests). `get_config(name)` /
`get_smoke_config(name)` dispatch by arch id. SHAPES defines the assigned
input-shape set; `cells()` enumerates the (arch x shape) dry-run grid with
the DESIGN.md §5 applicability rules.
"""

from __future__ import annotations

import dataclasses
import importlib

ARCH_NAMES = [
    "falcon-mamba-7b",
    "internvl2-26b",
    "kimi-k2-1t-a32b",
    "llama4-scout-17b-a16e",
    "phi3-medium-14b",
    "deepseek-coder-33b",
    "gemma2-9b",
    "qwen2.5-14b",
    "whisper-base",
    "jamba-1.5-large-398b",
]

_MODULES = {
    "falcon-mamba-7b": "falcon_mamba_7b",
    "internvl2-26b": "internvl2_26b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "phi3-medium-14b": "phi3_medium_14b",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "gemma2-9b": "gemma2_9b",
    "qwen2.5-14b": "qwen2_5_14b",
    "whisper-base": "whisper_base",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    # whisper's own block at its large published widths (the benchmark's
    # whisper-train cell); not one of the assigned ARCH_NAMES
    "whisper-large-v3": "whisper_large_v3",
}


def _module(name: str):
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")


def get_config(name: str):
    return _module(name).CONFIG


def get_smoke_config(name: str):
    return _module(name).SMOKE


@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": Shape("train_4k", 4096, 256, "train"),
    "prefill_32k": Shape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": Shape("decode_32k", 32768, 128, "decode"),
    "long_500k": Shape("long_500k", 524288, 1, "decode"),
}


def shape_applicable(arch: str, shape_name: str) -> tuple[bool, str]:
    """DESIGN.md §5 rules. Returns (runnable, reason-if-skipped)."""
    cfg = get_config(arch)
    if shape_name == "long_500k" and not cfg.sub_quadratic:
        return False, ("pure full-attention arch: 500k context needs "
                       "sub-quadratic attention (DESIGN.md §5 skip note)")
    return True, ""


def cells():
    """All 40 (arch, shape) cells with applicability flags."""
    out = []
    for a in ARCH_NAMES:
        for s in SHAPES:
            ok, why = shape_applicable(a, s)
            out.append((a, s, ok, why))
    return out
