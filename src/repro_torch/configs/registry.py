"""Architecture registry: --arch <id> resolution + shape grid definitions."""
from __future__ import annotations

from typing import Dict, List, Tuple

from ..models.config import ModelConfig
from . import (command_r_plus_104b, internvl2_26b, kimi_k2, mamba2_2_7b,
               olmoe_1b_7b, qwen2_5_3b, smollm_135m, whisper_large_v3,
               yi_34b, zamba2_2_7b)

_MODULES = {
    "whisper-large-v3": whisper_large_v3,
    "qwen2.5-3b": qwen2_5_3b,
    "yi-34b": yi_34b,
    "smollm-135m": smollm_135m,
    "command-r-plus-104b": command_r_plus_104b,
    "zamba2-2.7b": zamba2_2_7b,
    "internvl2-26b": internvl2_26b,
    "olmoe-1b-7b": olmoe_1b_7b,
    "kimi-k2-1t-a32b": kimi_k2,
    "mamba2-2.7b": mamba2_2_7b,
}

ARCH_IDS: List[str] = list(_MODULES)

# shape id -> (seq_len, global_batch, step kind)
SHAPES: Dict[str, Tuple[int, int, str]] = {
    "train_4k": (4096, 256, "train"),
    "prefill_32k": (32768, 32, "prefill"),
    "decode_32k": (32768, 128, "decode"),
    "long_500k": (524288, 1, "decode"),
}


def get_config(arch: str) -> ModelConfig:
    return _MODULES[arch].CONFIG


def get_reduced(arch: str) -> ModelConfig:
    return _MODULES[arch].REDUCED


def shapes_for(arch: str) -> List[str]:
    """long_500k only runs for sub-quadratic archs."""
    cfg = get_config(arch)
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.supports_long:
        out.append("long_500k")
    return out


def all_cells():
    """All 40 (arch, shape) cells; skipped ones flagged with a reason."""
    cells = []
    for a in ARCH_IDS:
        cfg = get_config(a)
        for s in SHAPES:
            skip = None
            if s == "long_500k" and not cfg.supports_long:
                skip = "full attention is O(S^2) at 524k; arch defines no sub-quadratic path"
            cells.append((a, s, skip))
    return cells
