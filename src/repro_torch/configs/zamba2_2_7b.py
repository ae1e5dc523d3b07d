"""zamba2-2.7b [hybrid: Mamba2 backbone + shared attention] — arXiv:2411.15242."""
import dataclasses
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32, d_ff=10240,
    vocab=32000, ssm_state=64, ssm_headdim=64, ssm_expand=2,
    shared_attn_every=6, supports_long=True,
)

REDUCED = dataclasses.replace(
    CONFIG, n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab=512, ssm_state=16, ssm_headdim=16, shared_attn_every=2,
    ssm_chunk=16)
