from .ops import (rank, rank_batched, rank_binary, sorted_search,
                  sorted_search_batched, sorted_search_endpoints,
                  tablet_gather, tablet_read)
from .ref import (rank_batched_ref, rank_ref, rank_sides_ref,
                  sorted_search_batched_ref, tablet_gather_ref,
                  tablet_read_ref)

__all__ = ["rank", "rank_batched", "rank_batched_ref", "rank_binary",
           "rank_ref", "rank_sides_ref", "sorted_search",
           "sorted_search_batched", "sorted_search_batched_ref",
           "sorted_search_endpoints", "tablet_gather", "tablet_gather_ref",
           "tablet_read", "tablet_read_ref"]
