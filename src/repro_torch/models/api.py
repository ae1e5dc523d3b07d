"""Unified model API: ``build(cfg)`` returns the step functions and input
specs of one architecture. The port trains and serves the dense, MoE,
Mamba2 (``ssm``) and hybrid families; the other families raise
``NotImplementedError`` naming the ROADMAP item that ports them."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from . import hybrid, mamba2, transformer
from .config import ModelConfig
from .spec import PSpec

# family -> the ROADMAP Queue 1 item that ports it
_LATER = {"encdec": "11f (enc-dec)", "vlm": "11g (VLM)"}
# family -> (its module, the PSpecs (cfg, batch, max_len) of its decode state)
_FAMILIES = {"dense": (transformer, transformer.cache_specs),
             "moe": (transformer, transformer.cache_specs),
             "ssm": (mamba2, mamba2.state_specs),
             "hybrid": (hybrid, hybrid.state_specs)}


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
    """The step functions of ``cfg``'s family. Prefill takes
    ``{"tokens", "max_len"?}`` (an SSM's state does not grow with the
    length, so it ignores ``max_len``); decode takes ``{"token", "cache",
    "pos"}`` (no ``pos`` for an SSM)."""
    f = cfg.family
    if f in _LATER:
        raise NotImplementedError(
            f"family {f!r} is not ported yet: ROADMAP Queue 1 item "
            f"{_LATER[f]}")
    if f not in _FAMILIES:
        raise ValueError(f"unknown family {f!r}")
    m, state_specs = _FAMILIES[f]

    def train(p, b, remat="dots_no_batch"):
        return m.train_loss(cfg, p, b, remat)

    def prefill(p, b):
        return m.prefill(cfg, p, b["tokens"], b.get("max_len"))

    def decode(p, b):
        return m.decode_step(cfg, p, b["token"], b["cache"], b.get("pos"))

    def tok_in(gb, s):
        return {"tokens": _tok_spec(gb, s)}

    def decode_in(gb, s):
        specs = {"token": _tok_spec(gb, 1),
                 "cache": state_specs(cfg, gb, s)}
        if f != "ssm":
            specs["pos"] = PSpec((), torch.int32, "zeros")
        return specs

    return Model(cfg, m.param_specs(cfg), train, prefill, decode, tok_in,
                 tok_in, decode_in)
