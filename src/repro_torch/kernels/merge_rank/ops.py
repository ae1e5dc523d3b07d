"""Merges of sorted runs by rank + scatter: the two-run merge of major
compaction (``merge_sorted`` / ``kway_merge``) and the row-wise K-way merge
of the fused point read (``merge_combine_rows``).

Invalid entries in either run must carry key (I32_MAX, I32_MAX); they sort
to the tail of the merged output, so fixed-capacity runs merge without
knowing their valid counts. A CUDA tensor goes to the hand kernels
(``csrc/pair_rank.cu``, ``csrc/row_rank.cu``); a CPU tensor to the plain
versions in ``ref.py``.
"""
import torch

from ..common import I32_MAX, check_cuda_int32, launch
from .ref import merge_sorted_ref, pair_rank_ref, row_rank_ref


def pair_rank(tr, tc, qr, qc, strict: bool) -> torch.Tensor:
    """Lexicographic rank of each ``(qr, qc)[S, n]`` in the sorted run
    ``(tr, tc)[S, m]`` of the same shard, strict or not: int32 [S, n]."""
    if tr.dim() != 2 or qr.dim() != 2 or tr.shape != tc.shape \
            or qr.shape != qc.shape or tr.shape[0] != qr.shape[0]:
        raise ValueError("pair_rank takes runs [S, m] and queries [S, n]")
    if tr.device.type == "cpu":
        return pair_rank_ref(tr, tc, qr, qc, strict)
    check_cuda_int32("pair_rank", tr, tc, qr, qc)
    n_s, m = tr.shape
    n = qr.shape[1]
    if n_s > 65535:
        raise ValueError(f"pair_rank: S={n_s} exceeds the grid limit")
    out = torch.empty((n_s, n), dtype=torch.int32, device=tr.device)
    launch("pair_rank", tr.device, tr.data_ptr(), tc.data_ptr(), m,
           qr.data_ptr(), qc.data_ptr(), n, n_s, int(strict), out.data_ptr())
    return out


def row_rank(keys: torch.Tensor) -> torch.Tensor:
    """Per-row strict self-rank of ``keys[Q, W]`` (int32): int32 [Q, W]."""
    if keys.dim() != 2:
        raise ValueError("row_rank takes keys[Q, W]")
    if keys.device.type == "cpu":
        return row_rank_ref(keys)
    check_cuda_int32("row_rank", keys)
    out = torch.empty_like(keys)
    launch("row_rank", keys.device, keys.data_ptr(), keys.shape[0],
           keys.shape[1], out.data_ptr())
    return out


def merge_sorted(ar, ac, av, br, bc, bv):
    """Merge sorted runs A and B (each sorted lex by (r, c), pads = I32_MAX).

    Runs are 1-D, or [S, n] for S independent shards merged in one launch
    per direction. Returns (r, c, v) of length len(A)+len(B) along the last
    axis; valid entries first in sorted order, A-side entries preceding
    B-side entries on equal keys (so a later dedup pass can implement
    last-wins for the newer B side). Values in the pad tail are undefined.
    """
    flat = ar.dim() == 1
    if flat:
        ar, ac, av, br, bc, bv = (x[None] for x in (ar, ac, av, br, bc, bv))
    ar, ac, br, bc = (x.to(torch.int32).contiguous()
                      for x in (ar, ac, br, bc))
    n_s, n_a = ar.shape
    n_b = br.shape[1]
    dev = ar.device
    rank_a = pair_rank(br, bc, ar, ac, strict=True)
    rank_b = pair_rank(ar, ac, br, bc, strict=False)
    # rank counts include the other side's pads only for pad queries,
    # which always land at/after position len(valid A)+len(valid B)
    last = max(n_a + n_b - 1, 0)
    pos_a = (torch.arange(n_a, device=dev) + rank_a).clamp_(max=last)
    pos_b = (torch.arange(n_b, device=dev) + rank_b).clamp_(max=last)
    out_r = torch.full((n_s, n_a + n_b), I32_MAX, dtype=torch.int32,
                       device=dev)
    out_c = torch.full_like(out_r, I32_MAX)
    out_v = torch.zeros((n_s, n_a + n_b), dtype=av.dtype, device=dev)
    # valid A and valid B never share a slot; pads may collide (pad over pad)
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
    merged position. The rank comes from the hand kernel under
    ``use_pallas`` (the plain compare count otherwise); the permutation is
    applied as a direct scatter of the valid entries into a buffer of width
    W + 1 (all pads rank at n_valid, so they go to the spare column).
    Returns (keys, vals) with every row in ascending key order; unfilled
    slots hold I32_MAX (keys) / 0 (vals).
    """
    n_q, n_w = keys.shape
    keys = keys.to(torch.int32).contiguous()
    rank = row_rank(keys) if use_pallas else row_rank_ref(keys)
    valid = keys != I32_MAX
    dst = torch.where(valid, rank.to(torch.int64), n_w)
    out_k = torch.full((n_q, n_w + 1), I32_MAX, dtype=torch.int32,
                       device=keys.device)
    out_v = torch.zeros((n_q, n_w + 1), dtype=vals.dtype, device=keys.device)
    out_k.scatter_(1, dst, keys)
    out_v.scatter_(1, dst, torch.where(valid, vals, torch.zeros_like(vals)))
    return out_k[:, :n_w], out_v[:, :n_w]
