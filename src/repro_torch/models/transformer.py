"""Decoder-only transformer LM (dense GQA and MoE families, and the VLM's
backbone): the train loss and the serving steps.

The parameter tree keeps the JAX package's stacked ``[L, ...]`` block
leaves; the JAX ``lax.scan`` over layers is a Python loop over per-layer
views. Three step kinds: the train loss (with per-layer remat), prefill
(builds the KV cache) and single-token decode. Each takes the
activation-sharding hook ``sh`` (None: the identity).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from . import layers, moe, spec
from .config import ModelConfig
from .spec import PSpec, no_sharding, tree_map

Cache = Tuple[torch.Tensor, torch.Tensor]  # (k, v), each [L, B, Smax, KV, hd]


def block_specs(cfg: ModelConfig, L: Tuple[int, ...]) -> Dict:
    if cfg.family not in ("dense", "moe", "vlm"):  # vlm: dense blocks
        raise ValueError(f"transformer: family {cfg.family!r} is not a "
                         "decoder-only transformer")
    sp = {
        "ln1": layers.norm_specs(cfg, L),
        "ln2": layers.norm_specs(cfg, L),
        "attn": layers.attn_specs(cfg, L),
    }
    if cfg.family == "moe":
        sp["moe"] = moe.moe_specs(cfg, L)
    else:
        sp["mlp"] = layers.mlp_specs(cfg, L)
    return sp


def param_specs(cfg: ModelConfig) -> Dict:
    return {
        "embed": layers.embed_specs(cfg),
        "blocks": block_specs(cfg, (cfg.n_layers,)),
        "final_norm": layers.norm_specs(cfg),
    }


def apply_block(cfg: ModelConfig, p, x: torch.Tensor, positions, *,
                cache: Optional[Cache] = None, cache_pos: int = 0, sh=None):
    """One pre-norm block; returns (x, cache, aux), aux the MoE block's
    load-balance loss (0 for a dense block)."""
    h, new_kv = layers.attention(
        cfg, p["attn"], layers.apply_norm(cfg, p["ln1"], x), positions,
        causal=True, cache=cache, cache_pos=cache_pos, sh=sh)
    x = x + h
    hn = layers.apply_norm(cfg, p["ln2"], x)
    if cfg.family == "moe":
        h, aux = moe.apply_moe(cfg, p["moe"], hn, sh)
    else:
        h = layers.apply_mlp(cfg, p["mlp"], hn, sh)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + h, new_kv, aux


def apply_stack(cfg: ModelConfig, blocks, x: torch.Tensor, positions,
                remat: str = "dots_no_batch", sh=None):
    """The train path's layers in order, each under the remat policy
    ``remat`` (a ``REMAT_POLICIES`` name; another raises ``KeyError``);
    returns (x, aux_sum), the dense family's aux being 0."""
    run = layers.remat_runner(remat)

    def body(blk, y):
        y, _, aux = apply_block(cfg, blk, y, positions, sh=sh)
        return y, aux

    aux_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.n_layers):  # layer i's parameters: views of the stack
        x, aux = run(body, tree_map(lambda w: w[i], blocks), x)
        aux_sum = aux_sum + aux
    return x, aux_sum


def train_loss(cfg: ModelConfig, params, batch: Dict,
               remat: str = "dots_no_batch", sh=None) -> torch.Tensor:
    """Mean next-token cross-entropy of ``batch["tokens"]`` [B, S] (the
    last position masked) plus 0.01 x the blocks' aux loss: a 0-d float32
    tensor."""
    sh = sh or no_sharding
    tokens = batch["tokens"]
    x = sh(layers.embed_tokens(params["embed"], tokens), "batch", "seq",
           "model_dim_act")
    positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                             device=tokens.device)
    x, aux = apply_stack(cfg, params["blocks"], x, positions, remat, sh)
    x = layers.apply_norm(cfg, params["final_norm"], x)
    logits = layers.unembed(cfg, params["embed"], x, sh)
    return layers.next_token_loss(cfg, logits, tokens) + 0.01 * aux


def _run_layers(cfg: ModelConfig, params, x, positions, cache: Cache,
                pos: int, sh=None):
    blocks = params["blocks"]
    for i in range(cfg.n_layers):  # layer i's parameters: views of the stack
        x, _, _ = apply_block(cfg, tree_map(lambda w: w[i], blocks), x,
                              positions, cache=(cache[0][i], cache[1][i]),
                              cache_pos=pos, sh=sh)
    return layers.apply_norm(cfg, params["final_norm"], x)


@torch.no_grad()
def prefill(cfg: ModelConfig, params, tokens: torch.Tensor,
            max_len: Optional[int] = None, sh=None):
    """Forward pass over ``tokens`` [B, S] that also builds the KV cache
    (k, v), each [L, B, max_len, KV, hd] (``max_len`` defaults to S).
    Returns (last-position logits [B, 1, vocab_padded] float32, cache).
    As in the JAX package, attention runs over all ``max_len`` slots."""
    b, s = tokens.shape
    smax = max_len or s
    x = layers.embed_tokens(params["embed"], tokens)
    cache = cache_zeros(cfg, b, smax, tokens.device, sh, x)
    positions = torch.arange(s, dtype=torch.int32, device=tokens.device)
    x = _run_layers(cfg, params, x, positions, cache, 0, sh)
    return layers.unembed(cfg, params["embed"], x[:, -1:], sh), cache


@torch.no_grad()
def decode_step(cfg: ModelConfig, params, token: torch.Tensor, cache: Cache,
                pos: int, sh=None):
    """One decode step. token: [B, 1]; ``pos`` (an int) is the new token's
    position. The cache is updated in place and returned with the logits
    [B, 1, vocab_padded] float32."""
    x = layers.embed_tokens(params["embed"], token)
    positions = torch.full((1,), pos, dtype=torch.int32, device=token.device)
    x = _run_layers(cfg, params, x, positions, cache, pos, sh)
    return layers.unembed(cfg, params["embed"], x, sh), cache


def cache_specs(cfg: ModelConfig, batch: int, max_len: int):
    """PSpec pair for the decode KV cache."""
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
    axes = (None, "batch", "kv_seq", None, None)
    return (PSpec(shape, cfg.dtype, "zeros", axes=axes),
            PSpec(shape, cfg.dtype, "zeros", axes=axes))


def cache_zeros(cfg: ModelConfig, batch: int, max_len: int, device,
                sh=None, like=None) -> Cache:
    """A zero KV cache; placed by the rules of ``sh`` on the mesh of
    ``like`` where that is a DTensor (``spec.zeros``)."""
    return tuple(spec.zeros(s, device, sh, like)
                 for s in cache_specs(cfg, batch, max_len))
