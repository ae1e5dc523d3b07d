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
