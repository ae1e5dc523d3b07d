"""command-r-plus-104b [dense GQA, no-bias] — hf:CohereForAI/c4ai-command-r-plus."""
import dataclasses
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b", family="dense",
    n_layers=64, d_model=12288, n_heads=96, n_kv_heads=8, d_ff=33792,
    vocab=256000, head_dim=128, tie_embeddings=True, rope_theta=75e6,
    supports_long=False,
)

REDUCED = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, d_ff=176,
    vocab=512, head_dim=8)
