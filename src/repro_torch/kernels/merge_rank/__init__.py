from .ops import (kway_merge, merge_combine_rows, merge_ranks, merge_sorted,
                  pair_rank, row_rank)
from .ref import (merge_combine_rows_ref, merge_ranks_ref, merge_sorted_ref,
                  pair_rank_ref, row_rank_ref)

__all__ = ["kway_merge", "merge_combine_rows", "merge_combine_rows_ref",
           "merge_ranks", "merge_ranks_ref", "merge_sorted",
           "merge_sorted_ref", "pair_rank", "pair_rank_ref", "row_rank",
           "row_rank_ref"]
