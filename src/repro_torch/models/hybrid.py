"""Zamba2-style hybrid: a Mamba2 backbone and one *shared* attention + MLP
block applied every ``shared_attn_every`` layers with per-application
input norms (the JAX package's ``models/hybrid.py``, whose docstring notes
the simplifications against Zamba2).

The mamba blocks are stacked ``[G, per, ...]`` (G groups of ``per``
layers); each group ends with the shared block, whose self-attention is
``kernels.flash_attention`` (hd 80 at zamba2-2.7b's full width). The
decode state is ``((ssm, conv), (k, v))``: the mamba states
``[G, per, B, ...]`` and the shared block's KV caches ``[G, B, Smax, KV,
hd]``, one per application.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from . import layers, mamba2, spec
from .config import ModelConfig
from .spec import PSpec, tree_map


def _groups(cfg: ModelConfig) -> Tuple[int, int]:
    per = cfg.shared_attn_every
    if per <= 0 or cfg.n_layers % per:
        raise ValueError(f"hybrid: {cfg.n_layers} layers do not split into "
                         f"groups of shared_attn_every={per}")
    return cfg.n_layers // per, per


def param_specs(cfg: ModelConfig) -> Dict:
    g, per = _groups(cfg)
    return {
        "embed": layers.embed_specs(cfg),
        "mamba_blocks": {
            "ln": layers.norm_specs(cfg, (g, per)),
            "mamba": mamba2.mamba_specs(cfg, (g, per)),
        },
        "shared": {
            "attn": layers.attn_specs(cfg),
            "mlp": layers.mlp_specs(cfg),
        },
        "inv_ln1": layers.norm_specs(cfg, (g,)),
        "inv_ln2": layers.norm_specs(cfg, (g,)),
        "final_norm": layers.norm_specs(cfg),
    }


def _shared_block(cfg: ModelConfig, params, p_ln1, p_ln2, x, positions,
                  cache=None, cache_pos: int = 0, sh=None):
    h, kv = layers.attention(cfg, params["shared"]["attn"],
                             layers.apply_norm(cfg, p_ln1, x), positions,
                             causal=True, cache=cache, cache_pos=cache_pos,
                             sh=sh)
    x = x + h
    h = layers.apply_mlp(cfg, params["shared"]["mlp"],
                         layers.apply_norm(cfg, p_ln2, x), sh)
    return x + h, kv


def _group(params, gi: int):
    """Group ``gi``'s mamba blocks and its two shared-block norms."""
    return (tree_map(lambda w: w[gi], params["mamba_blocks"]),
            tree_map(lambda w: w[gi], params["inv_ln1"]),
            tree_map(lambda w: w[gi], params["inv_ln2"]))


def logits(cfg: ModelConfig, params, tokens: torch.Tensor,
           remat: str = "none", sh=None) -> torch.Tensor:
    """The logits [B, S, vocab_padded] of one causal forward over
    ``tokens`` [B, S], each group one checkpoint under ``remat``."""
    g, per = _groups(cfg)
    run = layers.remat_runner(remat)
    x = layers.embed_tokens(params["embed"], tokens)
    positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                             device=tokens.device)

    def group_body(mblk, ln1, ln2, y):
        for j in range(per):
            y = mamba2.residual_block(cfg, tree_map(lambda w: w[j], mblk), y,
                                      sh)
        return _shared_block(cfg, params, ln1, ln2, y, positions, sh=sh)[0]

    for gi in range(g):
        x = run(group_body, *_group(params, gi), x)
    x = layers.apply_norm(cfg, params["final_norm"], x)
    return layers.unembed(cfg, params["embed"], x, sh)


def train_loss(cfg: ModelConfig, params, batch: Dict,
               remat: str = "dots_no_batch", sh=None) -> torch.Tensor:
    """Mean next-token cross-entropy of ``batch["tokens"]`` [B, S] (the
    last position masked), each group one checkpoint under ``remat``."""
    tokens = batch["tokens"]
    return layers.next_token_loss(cfg, logits(cfg, params, tokens, remat, sh),
                                  tokens)


@torch.no_grad()
def prefill(cfg: ModelConfig, params, tokens: torch.Tensor,
            max_len: Optional[int] = None, sh=None):
    """Forward over ``tokens`` [B, S] that builds the decode state, the KV
    caches ``max_len`` (default S) slots long. Returns (last-position
    logits [B, 1, vocab_padded] float32, ((ssm, conv), (k, v)))."""
    b, s = tokens.shape
    g, per = _groups(cfg)
    x = layers.embed_tokens(params["embed"], tokens)
    states = state_zeros(cfg, b, max_len or s, tokens.device, sh, x)
    (ssm, conv), (ck, cv) = states
    positions = torch.arange(s, dtype=torch.int32, device=tokens.device)
    for gi in range(g):
        mblk, ln1, ln2 = _group(params, gi)
        for j in range(per):
            blk = tree_map(lambda w: w[j], mblk)
            h, (ss, cs) = mamba2.apply_mamba(
                cfg, blk["mamba"], layers.apply_norm(cfg, blk["ln"], x),
                return_state=True, sh=sh)
            x = x + h
            ssm[gi, j] = ss
            conv[gi, j] = cs
        x, _ = _shared_block(cfg, params, ln1, ln2, x, positions,
                             cache=(ck[gi], cv[gi]), cache_pos=0, sh=sh)
    x = layers.apply_norm(cfg, params["final_norm"], x)
    return layers.unembed(cfg, params["embed"], x[:, -1:], sh), states


@torch.no_grad()
def decode_step(cfg: ModelConfig, params, token: torch.Tensor, states,
                pos: int, sh=None):
    """One decode step. token: [B, 1]; ``pos`` (an int) is the new token's
    position; ``states`` as ``prefill`` returns them, updated in place and
    returned with the logits [B, 1, vocab_padded] float32."""
    g, per = _groups(cfg)
    (ssm, conv), (ck, cv) = states
    x = layers.embed_tokens(params["embed"], token)[:, 0, :]
    positions = torch.full((1,), pos, dtype=torch.int32, device=token.device)
    for gi in range(g):
        mblk, ln1, ln2 = _group(params, gi)
        for j in range(per):
            blk = tree_map(lambda w: w[j], mblk)
            xn = layers.apply_norm(cfg, blk["ln"], x[:, None, :])[:, 0, :]
            h, ss, cs = mamba2.mamba_decode(cfg, blk["mamba"], xn,
                                            ssm[gi, j], conv[gi, j], sh)
            x = x + h
            ssm[gi, j] = ss
            conv[gi, j] = cs
        y, _ = _shared_block(cfg, params, ln1, ln2, x[:, None, :], positions,
                             cache=(ck[gi], cv[gi]), cache_pos=pos, sh=sh)
        x = y[:, 0, :]
    x = layers.apply_norm(cfg, params["final_norm"], x[:, None, :])
    return layers.unembed(cfg, params["embed"], x, sh), states


def state_specs(cfg: ModelConfig, batch: int, max_len: int):
    g, per = _groups(cfg)
    di, n = cfg.d_inner, cfg.ssm_state
    ssm = PSpec((g, per, batch, cfg.ssm_heads, cfg.ssm_headdim, n),
                torch.float32, "zeros",
                axes=(None, None, "batch", None, None, None))
    conv = PSpec((g, per, batch, cfg.ssm_conv - 1, di + 2 * n), cfg.dtype,
                 "zeros", axes=(None, None, "batch", None, "d_inner"))
    kv = PSpec((g, batch, max_len, cfg.n_kv_heads, cfg.hd), cfg.dtype,
               "zeros", axes=(None, "batch", "kv_seq", None, None))
    return ((ssm, conv), (kv, kv))


def state_zeros(cfg: ModelConfig, batch: int, max_len: int, device,
                sh=None, like=None):
    """The zero decode state, placed by the rules of ``sh`` on the mesh of
    ``like`` where that is a DTensor (``spec.zeros``)."""
    return tuple(tuple(spec.zeros(s, device, sh, like) for s in pair)
                 for pair in state_specs(cfg, batch, max_len))
