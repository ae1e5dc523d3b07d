"""internvl2-26b [vlm: InternViT stub + InternLM2 backbone] — arXiv:2404.16821."""
import dataclasses
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b", family="vlm",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=16384,
    vocab=92553, head_dim=128, n_img_tokens=256, supports_long=False,
)

REDUCED = dataclasses.replace(
    CONFIG, n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab=512, head_dim=16, n_img_tokens=8)
