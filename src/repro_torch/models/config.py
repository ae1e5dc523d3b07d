"""Model configuration shared by all assigned architectures (a copy of the
JAX package's ``models/config.py``; ``dtype`` is a ``torch.dtype``)."""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int

    head_dim: Optional[int] = None
    qkv_bias: bool = False
    mlp: str = "swiglu"              # swiglu | gelu
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    param_dtype: str = "bfloat16"

    # MoE
    n_experts: int = 0
    experts_per_token: int = 0
    n_shared_experts: int = 0
    capacity_factor: float = 1.25

    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 128

    # hybrid (Zamba2-style shared attention block)
    shared_attn_every: int = 0

    # enc-dec (whisper)
    n_enc_layers: int = 0
    n_frames: int = 1500             # conv-frontend output length (stub)

    # vlm (internvl)
    n_img_tokens: int = 0

    # capability flags
    supports_long: bool = False      # sub-quadratic path for long_500k
    has_decoder: bool = True

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def vocab_padded(self) -> int:
        return round_up(self.vocab, 2048)  # keeps vocab shardable by 16

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def dtype(self):
        return (torch.bfloat16 if self.param_dtype == "bfloat16"
                else torch.float32)

    def n_params_analytic(self) -> int:
        """Total parameter count (for 6·N·D roofline bookkeeping)."""
        d, hd = self.d_model, self.hd
        emb = self.vocab_padded * d * (1 if self.tie_embeddings else 2)
        attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) \
            + (self.n_heads * hd) * d
        if self.mlp == "swiglu":
            mlp = 3 * d * self.d_ff
        else:
            mlp = 2 * d * self.d_ff
        if self.family == "moe":
            mlp = self.n_experts * 3 * d * self.d_ff + d * self.n_experts \
                + self.n_shared_experts * 3 * d * self.d_ff
        if self.family == "ssm":
            attn = 0
            mlp = self._mamba_params()
        if self.family == "hybrid":
            n_shared = max(self.n_layers // max(self.shared_attn_every, 1), 1)
            shared = attn + 3 * d * self.d_ff
            return emb + self.n_layers * self._mamba_params() + shared \
                + n_shared * 2 * d  # per-invocation norms
        layers = self.n_layers if self.family != "encdec" \
            else self.n_enc_layers + self.n_layers
        if self.family == "encdec":
            attn = attn * 2  # self + cross in decoder (approx; enc has one)
        return emb + layers * (attn + mlp)

    def _mamba_params(self) -> int:
        d, di, ns = self.d_model, self.d_inner, self.ssm_state
        h = self.ssm_heads
        in_proj = d * (2 * di + 2 * ns + h)
        return in_proj + (di + 2 * ns) * self.ssm_conv + di * d + 3 * h + di

    def n_params_active(self) -> int:
        """Active params per token (MoE: routed top-k + shared)."""
        if self.family != "moe":
            return self.n_params_analytic()
        d = self.d_model
        routed_inactive = self.n_layers * \
            (self.n_experts - self.experts_per_token) * 3 * d * self.d_ff
        return self.n_params_analytic() - routed_inactive
