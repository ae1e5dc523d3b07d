"""whisper-large-v3 [audio enc-dec] — arXiv:2212.04356. Conv frontend is a
stub: input_specs provide precomputed frame embeddings [B, 1500, 1280]."""
import dataclasses
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3", family="encdec",
    n_layers=32, n_enc_layers=32, d_model=1280, n_heads=20, n_kv_heads=20,
    d_ff=5120, vocab=51866, mlp="gelu", norm="layernorm",
    n_frames=1500, supports_long=False,
)

REDUCED = dataclasses.replace(
    CONFIG, n_layers=2, n_enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=512, n_frames=16)
