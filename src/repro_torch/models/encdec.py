"""Encoder-decoder transformer (whisper-large-v3 backbone): the train loss
and the serving steps (the JAX package's ``models/encdec.py``).

The conv audio frontend is a stub, as in the JAX package: the inputs are
precomputed frame embeddings [B, n_frames, d_model]. Both stacks add
sinusoidal positions to the activations (in the activation dtype) and
rotate nothing. Every attention is ``kernels.flash_attention``: the
encoder's self-attention and the decoder's cross-attention with
``causal=False``, the decoder's self-attention causal over its KV cache.
The JAX ``lax.scan`` over layers is a Python loop over per-layer views of
the stacked ``[L, ...]`` leaves.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from . import layers, spec
from .config import ModelConfig
from .spec import PSpec, tree_map

KV = Tuple[torch.Tensor, torch.Tensor]  # (k, v), each [L, B, S, KV, hd]


def sinusoidal_pos(positions: torch.Tensor, dim: int) -> torch.Tensor:
    """[len(positions), dim] float32: the sines of ``position * freq`` in
    the first half, the cosines in the second (not interleaved), freq_i =
    exp(-2i / dim * log(10000)), all in float32 as the JAX function."""
    dev = positions.device
    freqs = torch.exp(-torch.arange(0, dim, 2, dtype=torch.float32,
                                    device=dev) / dim
                      * torch.log(torch.tensor(10000.0, device=dev)))
    ang = positions.float()[:, None] * freqs[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def sinusoidal(length: int, dim: int, device=None) -> torch.Tensor:
    return sinusoidal_pos(torch.arange(length, device=device), dim)


def param_specs(cfg: ModelConfig) -> Dict:
    le, ld = (cfg.n_enc_layers,), (cfg.n_layers,)
    return {
        "embed": layers.embed_specs(cfg),
        "enc_blocks": {
            "ln1": layers.norm_specs(cfg, le),
            "attn": layers.attn_specs(cfg, le),
            "ln2": layers.norm_specs(cfg, le),
            "mlp": layers.mlp_specs(cfg, le),
        },
        "enc_final": layers.norm_specs(cfg),
        "dec_blocks": {
            "ln1": layers.norm_specs(cfg, ld),
            "attn": layers.attn_specs(cfg, ld),
            "lnx": layers.norm_specs(cfg, ld),
            "xattn": layers.attn_specs(cfg, ld),
            "ln2": layers.norm_specs(cfg, ld),
            "mlp": layers.mlp_specs(cfg, ld),
        },
        "final_norm": layers.norm_specs(cfg),
    }


def _layer(blocks, i: int):
    return tree_map(lambda w: w[i], blocks)


def _enc_block(cfg: ModelConfig, blk, x, positions, sh=None):
    h, _ = layers.attention(cfg, blk["attn"],
                            layers.apply_norm(cfg, blk["ln1"], x), positions,
                            causal=False, use_rope=False, sh=sh)
    x = x + h
    return x + layers.apply_mlp(cfg, blk["mlp"],
                                layers.apply_norm(cfg, blk["ln2"], x), sh)


def encode(cfg: ModelConfig, params, frames: torch.Tensor,
           remat: str = "dots_no_batch", sh=None) -> torch.Tensor:
    """frames: [B, F, D] precomputed frontend embeddings -> the encoder's
    output [B, F, D], each layer one checkpoint under ``remat``."""
    run = layers.remat_runner(remat)
    f = frames.shape[1]
    x = frames + sinusoidal(f, cfg.d_model, frames.device).to(frames.dtype)
    positions = torch.arange(f, dtype=torch.int32, device=frames.device)
    for i in range(cfg.n_enc_layers):
        x = run(lambda blk, y: _enc_block(cfg, blk, y, positions, sh),
                _layer(params["enc_blocks"], i), x)
    return layers.apply_norm(cfg, params["enc_final"], x)


def _dec_block(cfg: ModelConfig, blk, x, positions, enc_out=None,
               cache=None, cache_pos: int = 0, cross: Optional[Tuple] = None,
               sh=None):
    """One decoder block: causal self-attention (over ``cache`` when
    given), cross-attention over ``cross`` (or over ``enc_out``'s keys and
    values, computed here), the MLP. Returns (x, cache, cross)."""
    h, kv = layers.attention(cfg, blk["attn"],
                             layers.apply_norm(cfg, blk["ln1"], x), positions,
                             causal=True, use_rope=False, cache=cache,
                             cache_pos=cache_pos, sh=sh)
    x = x + h
    if cross is None:
        cross = layers.cross_kv(cfg, blk["xattn"], enc_out)
    x = x + layers.cross_attention(cfg, blk["xattn"],
                                   layers.apply_norm(cfg, blk["lnx"], x),
                                   cross, sh)
    x = x + layers.apply_mlp(cfg, blk["mlp"],
                             layers.apply_norm(cfg, blk["ln2"], x), sh)
    return x, kv, cross


def _embed(cfg: ModelConfig, params, tokens: torch.Tensor,
           positions: torch.Tensor) -> torch.Tensor:
    x = layers.embed_tokens(params["embed"], tokens)
    return x + sinusoidal_pos(positions, cfg.d_model).to(x.dtype)


def logits(cfg: ModelConfig, params, frames: torch.Tensor,
           tokens: torch.Tensor, remat: str = "none",
           sh=None) -> torch.Tensor:
    """The logits [B, S, vocab_padded] of one forward over ``frames``
    [B, F, D] and ``tokens`` [B, S] (the train path's), each layer of
    both stacks one checkpoint under ``remat``."""
    run = layers.remat_runner(remat)
    enc_out = encode(cfg, params, frames, remat, sh)
    positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                             device=tokens.device)
    x = _embed(cfg, params, tokens, positions)
    for i in range(cfg.n_layers):
        x = run(lambda blk, y, e: _dec_block(cfg, blk, y, positions, e,
                                             sh=sh)[0],
                _layer(params["dec_blocks"], i), x, enc_out)
    x = layers.apply_norm(cfg, params["final_norm"], x)
    return layers.unembed(cfg, params["embed"], x, sh)


def train_loss(cfg: ModelConfig, params, batch: Dict,
               remat: str = "dots_no_batch", sh=None) -> torch.Tensor:
    """Mean next-token cross-entropy of ``batch["tokens"]`` [B, S] (the
    last position masked) given ``batch["frames"]`` [B, F, D]."""
    tokens = batch["tokens"]
    return layers.next_token_loss(
        cfg, logits(cfg, params, batch["frames"], tokens, remat, sh), tokens)


@torch.no_grad()
def prefill(cfg: ModelConfig, params, frames: torch.Tensor,
            tokens: torch.Tensor, max_len: Optional[int] = None, sh=None):
    """Encode ``frames`` [B, F, D] and prefill the decoder over ``tokens``
    [B, S]. Returns (last-position logits [B, 1, vocab_padded] float32,
    the self-attention cache (k, v) [L, B, max_len, KV, hd], the
    cross-attention keys and values (k, v) [L, B, F, KV, hd]);
    ``max_len`` defaults to S."""
    b, s = tokens.shape
    enc_out = encode(cfg, params, frames, remat="none", sh=sh)
    positions = torch.arange(s, dtype=torch.int32, device=tokens.device)
    x = _embed(cfg, params, tokens, positions)
    self_kv, cross_kv = cache_specs(cfg, b, max_len or s, frames.shape[1])
    cache = tuple(spec.zeros(kv, tokens.device, sh, x) for kv in self_kv)
    cross = tuple(spec.zeros(kv, tokens.device, sh, x) for kv in cross_kv)
    for i in range(cfg.n_layers):
        x, _, (xk, xv) = _dec_block(cfg, _layer(params["dec_blocks"], i), x,
                                    positions, enc_out,
                                    cache=(cache[0][i], cache[1][i]), sh=sh)
        cross[0][i], cross[1][i] = xk, xv
    x = layers.apply_norm(cfg, params["final_norm"], x)
    return layers.unembed(cfg, params["embed"], x[:, -1:], sh), cache, cross


@torch.no_grad()
def decode_step(cfg: ModelConfig, params, token: torch.Tensor, cache: KV,
                cross: KV, pos: int, sh=None):
    """One decode step. token: [B, 1]; ``pos`` (an int) is the new token's
    position; ``cache`` and ``cross`` as ``prefill`` returns them. The
    cache is updated in place and returned with the logits [B, 1,
    vocab_padded] float32."""
    positions = torch.full((1,), pos, dtype=torch.int32, device=token.device)
    x = _embed(cfg, params, token, positions)
    for i in range(cfg.n_layers):
        x, _, _ = _dec_block(cfg, _layer(params["dec_blocks"], i), x,
                             positions, cache=(cache[0][i], cache[1][i]),
                             cache_pos=pos, cross=(cross[0][i], cross[1][i]),
                             sh=sh)
    x = layers.apply_norm(cfg, params["final_norm"], x)
    return layers.unembed(cfg, params["embed"], x, sh), cache


def cache_specs(cfg: ModelConfig, batch: int, max_len: int,
                n_frames: Optional[int] = None):
    """PSpecs of the decode state: ((k, v) of the self-attention cache,
    (k, v) of the cross-attention over ``n_frames`` (default
    ``cfg.n_frames``) frames)."""
    self_kv = PSpec((cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd),
                    cfg.dtype, "zeros",
                    axes=(None, "batch", "kv_seq", None, None))
    cross = PSpec((cfg.n_layers, batch, n_frames or cfg.n_frames,
                   cfg.n_kv_heads, cfg.hd), cfg.dtype, "zeros",
                  axes=(None, "batch", None, None, None))
    return (self_kv, self_kv), (cross, cross)
