"""Unified model API: ``build(cfg)`` returns the step functions and input
specs of one architecture: the dense, MoE, Mamba2 (``ssm``), hybrid,
enc-dec and VLM families train and serve."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from . import encdec, hybrid, mamba2, transformer, vlm
from .config import ModelConfig
from .spec import PSpec, mesh_scope

# family -> (its module, the PSpecs (cfg, batch, max_len) of its decode state)
_FAMILIES = {"dense": (transformer, transformer.cache_specs),
             "moe": (transformer, transformer.cache_specs),
             "ssm": (mamba2, mamba2.state_specs),
             "hybrid": (hybrid, hybrid.state_specs),
             "encdec": (encdec, encdec.cache_specs),
             "vlm": (vlm, vlm.cache_specs)}


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    param_specs: Any
    train_loss: Callable          # (params, batch, remat, sh) -> loss
    prefill: Callable             # (params, batch, sh) -> (logits, cache[, cross])
    decode: Callable              # (params, batch, sh) -> (logits, cache)
    train_input_specs: Callable   # (gb, seq) -> PSpec dict
    prefill_input_specs: Callable  # (gb, seq) -> PSpec dict
    decode_input_specs: Callable  # (gb, seq) -> PSpec dict (incl cache, pos)


def _tok_spec(gb: int, s: int) -> PSpec:
    return PSpec((gb, s), torch.int32, "zeros", axes=("batch", None))


def prefix_input(cfg: ModelConfig):
    """(batch key, length) of the embeddings [B, length, d_model] that an
    enc-dec (audio frames) or a VLM (image embeddings) takes ahead of its
    tokens, the frontends being stubs; None for the other families."""
    return {"encdec": ("frames", cfg.n_frames),
            "vlm": ("img_embeds", cfg.n_img_tokens)}.get(cfg.family)


def build(cfg: ModelConfig) -> Model:
    """The step functions of ``cfg``'s family. Prefill takes
    ``{"tokens", "max_len"?}``, with ``"frames"`` [B, n_frames, d_model]
    (enc-dec) or ``"img_embeds"`` [B, n_img, d_model] (VLM); an SSM's
    state does not grow with the length, so it ignores ``max_len``.
    Decode takes ``{"token", "cache", "pos"}`` (no ``pos`` for an SSM;
    enc-dec also ``"cross"``, the cross-attention keys and values its
    prefill returns after the self cache). Each step takes the
    activation-sharding hook ``sh`` last (``spec.make_sharder``; None is
    the identity)."""
    f = cfg.family
    if f not in _FAMILIES:
        raise ValueError(f"unknown family {f!r}")
    m, state_specs = _FAMILIES[f]
    prefix = prefix_input(cfg)

    def train(p, b, remat="dots_no_batch", sh=None):
        with mesh_scope(sh):
            return m.train_loss(cfg, p, b, remat, sh=sh)

    def prefill(p, b, sh=None):
        with mesh_scope(sh):
            if prefix is not None:
                return m.prefill(cfg, p, b[prefix[0]], b["tokens"],
                                 b.get("max_len"), sh=sh)
            return m.prefill(cfg, p, b["tokens"], b.get("max_len"), sh=sh)

    def decode(p, b, sh=None):
        with mesh_scope(sh):
            if f == "encdec":
                return m.decode_step(cfg, p, b["token"], b["cache"],
                                     b["cross"], b["pos"], sh=sh)
            return m.decode_step(cfg, p, b["token"], b["cache"],
                                 b.get("pos"), sh=sh)

    def tok_in(gb, s):
        if prefix is None:
            return {"tokens": _tok_spec(gb, s)}
        name, n = prefix  # a VLM's image prefix takes n of the s positions
        return {"tokens": _tok_spec(gb, s - n if f == "vlm" else s),
                name: PSpec((gb, n, cfg.d_model), cfg.dtype,
                            axes=("batch", None, None))}

    def decode_in(gb, s):
        specs = {"token": _tok_spec(gb, 1)}
        if f == "encdec":
            specs["cache"], specs["cross"] = state_specs(cfg, gb, s)
        else:
            specs["cache"] = state_specs(cfg, gb, s)
        if f != "ssm":
            specs["pos"] = PSpec((), torch.int32, "zeros")
        return specs

    return Model(cfg, m.param_specs(cfg), train, prefill, decode, tok_in,
                 tok_in, decode_in)
