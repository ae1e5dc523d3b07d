"""Decoder-only transformer LM, dense GQA family: the serving steps.

The parameter tree keeps the JAX package's stacked ``[L, ...]`` block
leaves; the JAX ``lax.scan`` over layers is a Python loop over per-layer
views. Two step kinds: prefill (builds the KV cache) and single-token
decode. Training (``train_loss``, ``apply_stack``, remat) and the MoE
block come with later slices (ROADMAP Queue 1 items 11b and 11c).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from . import layers
from .config import ModelConfig
from .spec import PSpec, tree_map

Cache = Tuple[torch.Tensor, torch.Tensor]  # (k, v), each [L, B, Smax, KV, hd]


def _dense_only(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r}: the port serves the dense family only "
            "(MoE blocks: ROADMAP Queue 1 item 11c)")


def block_specs(cfg: ModelConfig, L: Tuple[int, ...]) -> Dict:
    _dense_only(cfg)
    return {
        "ln1": layers.norm_specs(cfg, L),
        "ln2": layers.norm_specs(cfg, L),
        "attn": layers.attn_specs(cfg, L),
        "mlp": layers.mlp_specs(cfg, L),
    }


def param_specs(cfg: ModelConfig) -> Dict:
    return {
        "embed": layers.embed_specs(cfg),
        "blocks": block_specs(cfg, (cfg.n_layers,)),
        "final_norm": layers.norm_specs(cfg),
    }


def apply_block(cfg: ModelConfig, p, x: torch.Tensor, positions, *,
                cache: Optional[Cache] = None, cache_pos: int = 0):
    """One pre-norm block; returns (x, cache)."""
    h, new_kv = layers.attention(
        cfg, p["attn"], layers.apply_norm(cfg, p["ln1"], x), positions,
        causal=True, cache=cache, cache_pos=cache_pos)
    x = x + h
    x = x + layers.apply_mlp(cfg, p["mlp"], layers.apply_norm(cfg, p["ln2"], x))
    return x, new_kv


def _run_layers(cfg: ModelConfig, params, x, positions, cache: Cache,
                pos: int):
    blocks = params["blocks"]
    for i in range(cfg.n_layers):  # layer i's parameters: views of the stack
        x, _ = apply_block(cfg, tree_map(lambda w: w[i], blocks), x,
                           positions, cache=(cache[0][i], cache[1][i]),
                           cache_pos=pos)
    return layers.apply_norm(cfg, params["final_norm"], x)


@torch.no_grad()
def prefill(cfg: ModelConfig, params, tokens: torch.Tensor,
            max_len: Optional[int] = None):
    """Forward pass over ``tokens`` [B, S] that also builds the KV cache
    (k, v), each [L, B, max_len, KV, hd] (``max_len`` defaults to S).
    Returns (last-position logits [B, 1, vocab_padded] float32, cache).
    As in the JAX package, attention runs over all ``max_len`` slots."""
    _dense_only(cfg)
    b, s = tokens.shape
    smax = max_len or s
    cache = cache_zeros(cfg, b, smax, tokens.device)
    x = layers.embed_tokens(params["embed"], tokens)
    positions = torch.arange(s, dtype=torch.int32, device=tokens.device)
    x = _run_layers(cfg, params, x, positions, cache, 0)
    return layers.unembed(cfg, params["embed"], x[:, -1:]), cache


@torch.no_grad()
def decode_step(cfg: ModelConfig, params, token: torch.Tensor, cache: Cache,
                pos: int):
    """One decode step. token: [B, 1]; ``pos`` (an int) is the new token's
    position. The cache is updated in place and returned with the logits
    [B, 1, vocab_padded] float32."""
    _dense_only(cfg)
    x = layers.embed_tokens(params["embed"], token)
    positions = torch.full((1,), pos, dtype=torch.int32, device=token.device)
    x = _run_layers(cfg, params, x, positions, cache, pos)
    return layers.unembed(cfg, params["embed"], x), cache


def cache_specs(cfg: ModelConfig, batch: int, max_len: int):
    """PSpec pair for the decode KV cache."""
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
    return (PSpec(shape, cfg.dtype, "zeros"), PSpec(shape, cfg.dtype, "zeros"))


def cache_zeros(cfg: ModelConfig, batch: int, max_len: int, device) -> Cache:
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
    return (torch.zeros(shape, dtype=cfg.dtype, device=device),
            torch.zeros(shape, dtype=cfg.dtype, device=device))
