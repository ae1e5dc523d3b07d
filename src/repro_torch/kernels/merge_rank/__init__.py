from .ops import (kway_merge, merge_combine_rows, merge_ranks, merge_sorted,
                  pair_rank, row_merge, row_rank)
from .ref import (apply_row_rank, merge_combine_rows_ref, merge_ranks_ref,
                  merge_sorted_ref, pair_rank_ref, row_merge_ref,
                  row_rank_ref)

__all__ = ["apply_row_rank", "kway_merge", "merge_combine_rows",
           "merge_combine_rows_ref", "merge_ranks", "merge_ranks_ref",
           "merge_sorted", "merge_sorted_ref", "pair_rank", "pair_rank_ref",
           "row_merge", "row_merge_ref", "row_rank", "row_rank_ref"]
