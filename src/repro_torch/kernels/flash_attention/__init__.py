from .ops import attention_cost, flash_attention
from .ref import flash_attention_bwd_ref, flash_attention_ref, merge_shards_ref

__all__ = ["attention_cost", "flash_attention", "flash_attention_bwd_ref",
           "flash_attention_ref", "merge_shards_ref"]
