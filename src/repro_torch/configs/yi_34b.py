"""yi-34b [dense GQA, llama arch] — arXiv:2403.04652."""
import dataclasses
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="yi-34b", family="dense",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8, d_ff=20480,
    vocab=64000, head_dim=128, rope_theta=5e6, supports_long=False,
)

REDUCED = dataclasses.replace(
    CONFIG, n_layers=3, d_model=64, n_heads=8, n_kv_heads=2, d_ff=192,
    vocab=512, head_dim=8)
