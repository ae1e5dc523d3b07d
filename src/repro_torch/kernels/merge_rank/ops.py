"""Merges of sorted runs by rank + scatter: the two-run merge of major
compaction (``merge_sorted`` / ``kway_merge``) and the row-wise K-way merge
of the fused point read (``merge_combine_rows``).

Invalid entries in either run must carry key (I32_MAX, I32_MAX); they sort
to the tail of the merged output, so fixed-capacity runs merge without
knowing their valid counts. A CUDA tensor goes to the hand kernels
(``csrc/merge_path.cu`` for the two-run merge, ``csrc/row_rank.cu`` for the
row rank and the row merge, and ``csrc/pair_rank.cu`` for the rank of
queries not known to be sorted); a CPU tensor to the plain versions in
``ref.py``.
"""
import torch

from ..common import cdiv, check_cuda, launch
from .ref import (merge_ranks_ref, merge_sorted_ref, pair_rank_ref,
                  row_merge_ref, row_rank_ref)

# merged outputs per block of csrc/merge_path.cu (its kTile): the wrapper
# sizes the co-rank scratch with it, and the C entry point checks the size
MERGE_TILE = 2048


def pair_rank(tr, tc, qr, qc, strict: bool) -> torch.Tensor:
    """Lexicographic rank of each ``(qr, qc)[S, n]`` in the sorted run
    ``(tr, tc)[S, m]`` of the same shard, strict or not: int32 [S, n]."""
    if tr.dim() != 2 or qr.dim() != 2 or tr.shape != tc.shape \
            or qr.shape != qc.shape or tr.shape[0] != qr.shape[0]:
        raise ValueError("pair_rank takes runs [S, m] and queries [S, n]")
    if tr.device.type == "cpu":
        return pair_rank_ref(tr, tc, qr, qc, strict)
    check_cuda("pair_rank", *((t, torch.int32) for t in (tr, tc, qr, qc)))
    n_s, m = tr.shape
    n = qr.shape[1]
    if n_s > 65535:
        raise ValueError(f"pair_rank: S={n_s} exceeds the grid limit")
    out = torch.empty((n_s, n), dtype=torch.int32, device=tr.device)
    launch("pair_rank", tr.device, tr.data_ptr(), tc.data_ptr(), m,
           qr.data_ptr(), qc.data_ptr(), n, n_s, int(strict), out.data_ptr())
    return out


def merge_ranks(ar, ac, br, bc):
    """The merge ranks of two runs sorted over their full width (pads
    (I32_MAX, I32_MAX) at the tail), A before B on equal keys:
    ``rank_a = pair_rank(B, A, strict=True)`` and ``rank_b = pair_rank(A,
    B, strict=False)``, in one merge-path pass over both runs. Runs are
    int32 [S, n_a] and [S, n_b]; returns int32 (rank_a [S, n_a], rank_b
    [S, n_b])."""
    if ar.dim() != 2 or br.dim() != 2 or ar.shape != ac.shape \
            or br.shape != bc.shape or ar.shape[0] != br.shape[0]:
        raise ValueError("merge_ranks takes runs A [S, n_a] and B [S, n_b]")
    if ar.device.type == "cpu":
        return merge_ranks_ref(ar, ac, br, bc)
    check_cuda("merge_ranks", *((t, torch.int32) for t in (ar, ac, br, bc)))
    n_s, n_a = ar.shape
    n_b = br.shape[1]
    if n_s > 65535:
        raise ValueError(f"merge_ranks: S={n_s} exceeds the grid limit")
    if n_a + n_b >= 2 ** 31:
        raise ValueError(f"merge_ranks: n_a + n_b = {n_a + n_b} >= 2^31")
    rank_a = torch.empty((n_s, n_a), dtype=torch.int32, device=ar.device)
    rank_b = torch.empty((n_s, n_b), dtype=torch.int32, device=ar.device)
    n_bounds = cdiv(n_a + n_b, MERGE_TILE) + 1
    bounds = torch.empty((n_s, n_bounds), dtype=torch.int32, device=ar.device)
    launch("merge_path_rank", ar.device, ar.data_ptr(), ac.data_ptr(), n_a,
           br.data_ptr(), bc.data_ptr(), n_b, n_s, bounds.data_ptr(),
           n_bounds, rank_a.data_ptr(), rank_b.data_ptr())
    return rank_a, rank_b


def row_rank(keys: torch.Tensor) -> torch.Tensor:
    """Per-row strict self-rank of ``keys[Q, W]`` (int32): int32 [Q, W]."""
    if keys.dim() != 2:
        raise ValueError("row_rank takes keys[Q, W]")
    if keys.device.type == "cpu":
        return row_rank_ref(keys)
    check_cuda("row_rank", (keys, torch.int32))
    out = torch.empty_like(keys)
    launch("row_rank", keys.device, keys.data_ptr(), keys.shape[0],
           keys.shape[1], out.data_ptr())
    return out


def row_merge(keys: torch.Tensor, vals: torch.Tensor):
    """Merge each row of ``keys[Q, W]`` (int32) into ascending key order in
    one launch, ``vals[Q, W]`` riding along: every valid key (not I32_MAX)
    goes to the slot its strict self-rank names, and slots [n_valid, W) get
    I32_MAX and 0. Precondition: valid keys are unique within a row (pads
    may sit anywhere, also inside a segment); a row that breaks it has no
    defined result. The kernel moves 4-byte values (float32, int32) as
    bits. Returns (keys, vals) [Q, W]."""
    if keys.dim() != 2 or vals.shape != keys.shape:
        raise ValueError("row_merge takes keys[Q, W] and vals[Q, W]")
    if keys.device.type == "cpu":
        return row_merge_ref(keys, vals)
    check_cuda("row_merge", (keys, torch.int32), (vals, vals.dtype))
    if vals.element_size() != 4:
        raise TypeError(f"row_merge: values of 4 bytes, got {vals.dtype}")
    out_k = torch.empty_like(keys)
    out_v = torch.empty_like(vals)
    launch("row_merge", keys.device, keys.data_ptr(), vals.data_ptr(),
           keys.shape[0], keys.shape[1], out_k.data_ptr(), out_v.data_ptr())
    return out_k, out_v


def merge_sorted(ar, ac, av, br, bc, bv):
    """Merge sorted runs A and B (each sorted lex by (r, c), pads = I32_MAX).

    Both runs must be sorted over their full width, pads included. Runs
    are 1-D, or [S, n] for S independent shards ranked in one merge-path
    launch (``merge_ranks``). Returns (r, c, v) of length len(A)+len(B)
    along the last axis; valid entries first in sorted order, A-side
    entries preceding B-side entries on equal keys (so a later dedup pass
    can implement last-wins for the newer B side); the pad tail holds the
    runs' pads and their values.
    """
    flat = ar.dim() == 1
    if flat:
        ar, ac, av, br, bc, bv = (x[None] for x in (ar, ac, av, br, bc, bv))
    ar, ac, br, bc = (x.to(torch.int32).contiguous()
                      for x in (ar, ac, br, bc))
    n_s, n_a = ar.shape
    n_b = br.shape[1]
    dev = ar.device
    rank_a, rank_b = merge_ranks(ar, ac, br, bc)
    # the merge ranks place every entry, pads included, at its own slot of
    # the merged run: the positions are a permutation of [0, n_a + n_b)
    pos_a = torch.arange(n_a, device=dev) + rank_a
    pos_b = torch.arange(n_b, device=dev) + rank_b
    out_r = torch.empty((n_s, n_a + n_b), dtype=torch.int32, device=dev)
    out_c = torch.empty_like(out_r)
    out_v = torch.empty((n_s, n_a + n_b), dtype=av.dtype, device=dev)
    out_r.scatter_(1, pos_b, br).scatter_(1, pos_a, ar)
    out_c.scatter_(1, pos_b, bc).scatter_(1, pos_a, ac)
    out_v.scatter_(1, pos_b, bv).scatter_(1, pos_a, av)
    if flat:
        return out_r[0], out_c[0], out_v[0]
    return out_r, out_c, out_v


def kway_merge(runs, use_pallas: bool = True):
    """Merge k sorted runs into one by pairwise reduction (major compaction).

    ``runs`` is a list of (rows, cols, vals) triples sorted lex by (r, c)
    with I32_MAX key pads, ordered OLDEST FIRST (1-D, or [S, n] per shard).
    Each pairwise merge keeps the left (older) side first on equal keys,
    and the tree reduction only ever merges a prefix-contiguous older group
    with a newer one, so the merged output preserves global age order
    within every equal-key group: one downstream dedup pass implements
    every combiner. ``use_pallas`` selects the rank merge (hand kernel on
    the card) over the plain stable sort.

    Returns (rows, cols, vals) of length sum(len(run)); valid entries first.
    """
    if not runs:
        raise ValueError("kway_merge needs at least one run")
    merge = merge_sorted if use_pallas else merge_sorted_ref
    runs = list(runs)
    while len(runs) > 1:
        nxt = [merge(*runs[i], *runs[i + 1])
               for i in range(0, len(runs) - 1, 2)]
        if len(runs) % 2:
            nxt.append(runs[-1])
        runs = nxt
    return runs[0]


def merge_combine_rows(keys, vals, use_pallas: bool = False):
    """Row-wise K-way merge of ``keys[Q, W]`` int32 by rank + scatter.

    Each row is the CONCATENATION of K sorted candidate segments (one per
    run, (col, age)-packed by the fused query so valid keys are unique per
    row); pads carry I32_MAX. ``vals[Q, W]`` rides along. Because valid
    keys are unique, an element's strict self-rank against its row IS its
    merged position. Under ``use_pallas`` the rank and the scatter are one
    hand-kernel launch (``row_merge``); otherwise the plain compare count
    and a scatter (``row_merge_ref``). Returns (keys, vals) with every row
    in ascending key order; unfilled slots hold I32_MAX (keys) / 0 (vals).
    """
    keys = keys.to(torch.int32).contiguous()
    vals = vals.contiguous()
    return row_merge(keys, vals) if use_pallas else row_merge_ref(keys, vals)
