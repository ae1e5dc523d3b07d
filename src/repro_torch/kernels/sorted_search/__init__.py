from .ops import (rank, rank_batched, sorted_search, sorted_search_batched,
                  sorted_search_endpoints)
from .ref import (rank_batched_ref, rank_ref, rank_sides_ref,
                  sorted_search_batched_ref)

__all__ = ["rank", "rank_batched", "rank_batched_ref", "rank_ref",
           "rank_sides_ref", "sorted_search", "sorted_search_batched",
           "sorted_search_batched_ref", "sorted_search_endpoints"]
