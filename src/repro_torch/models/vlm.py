"""VLM (internvl2): a vision frontend stub ahead of the GQA decoder-only
backbone (the JAX package's ``models/vlm.py``).

As in the JAX package the InternViT frontend is a stub: the inputs are
precomputed patch embeddings [B, n_img, d_model], cast to the parameter
dtype and put ahead of the text embeddings; positions run over the
combined sequence. The loss covers the text positions only. Serving
reuses the transformer's decode step: the image prefix lives in the KV
cache after prefill.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from . import layers, transformer
from .config import ModelConfig
from .spec import no_sharding

param_specs = transformer.param_specs
decode_step = transformer.decode_step
cache_specs = transformer.cache_specs
cache_zeros = transformer.cache_zeros


def _prefix(cfg: ModelConfig, params, img: torch.Tensor,
            tokens: torch.Tensor):
    """(the image embeddings then the token embeddings [B, n_img + S, D],
    their positions 0 .. n_img + S - 1)."""
    x = torch.cat([img.to(cfg.dtype),
                   layers.embed_tokens(params["embed"], tokens)], dim=1)
    return x, torch.arange(x.shape[1], dtype=torch.int32, device=x.device)


def train_loss(cfg: ModelConfig, params, batch: Dict,
               remat: str = "dots_no_batch", sh=None) -> torch.Tensor:
    """Mean next-token cross-entropy of ``batch["tokens"]`` [B, S] (the
    last position masked) after the prefix ``batch["img_embeds"]`` [B,
    n_img, D], plus 0.01 x the blocks' aux loss (0 for dense blocks)."""
    sh = sh or no_sharding
    img, tokens = batch["img_embeds"], batch["tokens"]
    x, positions = _prefix(cfg, params, img, tokens)
    x = sh(x, "batch", "seq", "model_dim_act")
    x, aux = transformer.apply_stack(cfg, params["blocks"], x, positions,
                                     remat, sh)
    x = layers.apply_norm(cfg, params["final_norm"], x)
    logits = layers.unembed(cfg, params["embed"], x[:, img.shape[1]:], sh)
    return layers.next_token_loss(cfg, logits, tokens) + 0.01 * aux


@torch.no_grad()
def prefill(cfg: ModelConfig, params, img_embeds: torch.Tensor,
            tokens: torch.Tensor, max_len: Optional[int] = None, sh=None):
    """Forward over the image prefix and the prompt that builds the KV
    cache (k, v), each [L, B, max_len, KV, hd] over the combined sequence
    (``max_len`` defaults to n_img + S). Returns (last-position logits
    [B, 1, vocab_padded] float32, cache); decode the next token at
    ``pos = n_img + S``."""
    x, positions = _prefix(cfg, params, img_embeds, tokens)
    cache = cache_zeros(cfg, x.shape[0], max_len or x.shape[1], x.device, sh,
                        x)
    x = transformer._run_layers(cfg, params, x, positions, cache, 0, sh)
    return layers.unembed(cfg, params["embed"], x[:, -1:], sh), cache
