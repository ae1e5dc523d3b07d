"""olmoe-1b-7b [MoE 64e top-8] — arXiv:2409.02060."""
import dataclasses
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b", family="moe",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=1024,
    vocab=50304, n_experts=64, experts_per_token=8, supports_long=False,
)

REDUCED = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=64,
    vocab=512, n_experts=8, experts_per_token=2)
