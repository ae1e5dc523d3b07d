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
