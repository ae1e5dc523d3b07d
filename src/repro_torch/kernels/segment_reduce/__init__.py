from .ops import segment_sum, segment_sum_direct
from .ref import segment_sum_ref

__all__ = ["segment_sum", "segment_sum_direct", "segment_sum_ref"]
