from .ops import rank_batched, sorted_search_batched, sorted_search_endpoints
from .ref import rank_batched_ref, sorted_search_batched_ref

__all__ = ["rank_batched", "rank_batched_ref", "sorted_search_batched",
           "sorted_search_batched_ref", "sorted_search_endpoints"]
