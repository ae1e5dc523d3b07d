"""Unified model API: ``build(cfg)`` returns the step functions and input
specs of one architecture. The port trains and serves the dense family;
the other families raise ``NotImplementedError`` naming the ROADMAP item
that ports them."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from . import transformer
from .config import ModelConfig
from .spec import PSpec

# family -> the ROADMAP Queue 1 item that ports it
_LATER = {"moe": "11c (MoE)", "ssm": "11d (Mamba2)", "hybrid": "11e (hybrid)",
          "encdec": "11f (enc-dec)", "vlm": "11g (VLM)"}


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    param_specs: Any
    train_loss: Callable          # (params, batch, remat) -> loss
    prefill: Callable             # (params, batch) -> (logits, cache)
    decode: Callable              # (params, batch) -> (logits, cache)
    train_input_specs: Callable   # (gb, seq) -> PSpec dict
    prefill_input_specs: Callable  # (gb, seq) -> PSpec dict
    decode_input_specs: Callable  # (gb, seq) -> PSpec dict (incl cache, pos)


def _tok_spec(gb: int, s: int) -> PSpec:
    return PSpec((gb, s), torch.int32, "zeros")


def build(cfg: ModelConfig) -> Model:
    if cfg.family in _LATER:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet: ROADMAP Queue 1 item "
            f"{_LATER[cfg.family]}")
    if cfg.family != "dense":
        raise ValueError(f"unknown family {cfg.family!r}")

    def train(p, b, remat="dots_no_batch"):
        return transformer.train_loss(cfg, p, b, remat)

    def prefill(p, b):
        return transformer.prefill(cfg, p, b["tokens"], b.get("max_len"))

    def decode(p, b):
        return transformer.decode_step(cfg, p, b["token"], b["cache"],
                                       b["pos"])

    def tok_in(gb, s):
        return {"tokens": _tok_spec(gb, s)}

    def decode_in(gb, s):
        return {"token": _tok_spec(gb, 1),
                "pos": PSpec((), torch.int32, "zeros"),
                "cache": transformer.cache_specs(cfg, gb, s)}

    return Model(cfg, transformer.param_specs(cfg), train, prefill, decode,
                 tok_in, tok_in, decode_in)
