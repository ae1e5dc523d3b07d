"""mamba2-2.7b [attention-free SSD] — arXiv:2405.21060."""
import dataclasses
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b", family="ssm",
    n_layers=64, d_model=2560, n_heads=1, n_kv_heads=1, d_ff=0,
    vocab=50280, ssm_state=128, ssm_headdim=64, ssm_expand=2,
    supports_long=True, mlp="swiglu",
)

REDUCED = dataclasses.replace(
    CONFIG, n_layers=3, d_model=64, vocab=512, ssm_state=16, ssm_headdim=16,
    ssm_chunk=16)
