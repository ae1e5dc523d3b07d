"""kimi-k2-1t-a32b [trillion-param MoE 384e top-8 + 1 shared expert] —
arXiv:2501 (paper-table config)."""
import dataclasses
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8, d_ff=2048,
    vocab=163840, head_dim=112, n_experts=384, experts_per_token=8,
    n_shared_experts=1, supports_long=False,
)

REDUCED = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=64,
    vocab=512, head_dim=16, n_experts=8, experts_per_token=2,
    n_shared_experts=1)
