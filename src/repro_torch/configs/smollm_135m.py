"""smollm-135m [dense GQA, small llama arch] — hf:HuggingFaceTB/SmolLM-135M."""
import dataclasses
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="smollm-135m", family="dense",
    n_layers=30, d_model=576, n_heads=9, n_kv_heads=3, d_ff=1536,
    vocab=49152, tie_embeddings=True, rope_theta=1e4, supports_long=False,
)

REDUCED = dataclasses.replace(
    CONFIG, n_layers=3, d_model=48, n_heads=3, n_kv_heads=3, d_ff=128,
    vocab=512)
