"""Plain PyTorch versions of the merge-rank kernels and of the merges
built on them (the definitions the CUDA kernels are held against)."""
import torch

from ..common import I32_MAX

# compare-count chunking: at most this many [query, run] pairs at once
_CHUNK = 1 << 24


def pair_rank_ref(tr, tc, qr, qc, strict: bool) -> torch.Tensor:
    """Lexicographic rank of each query pair ``(qr, qc)[S, n]`` in the run
    ``(tr, tc)[S, m]`` of its shard: the count of run pairs that precede it
    (strictly, or not). The compare count itself. int32 [S, n]."""
    n_s, m = tr.shape
    n = qr.shape[1]
    out = torch.empty((n_s, n), dtype=torch.int32, device=tr.device)
    step = max(1, _CHUNK // max(1, n_s * m))
    r, c = tr[:, None, :], tc[:, None, :]
    for i in range(0, n, step):
        xr = qr[:, i:i + step, None]
        xc = qc[:, i:i + step, None]
        second = (c < xc) if strict else (c <= xc)
        less = (r < xr) | ((r == xr) & second)
        out[:, i:i + step] = less.sum(-1, dtype=torch.int32)
    return out


def merge_ranks_ref(ar, ac, br, bc):
    """Plain version of ``merge_ranks``: each entry's position in a stable
    sort of the concatenated keys (A before B on equal keys) less its own
    index, i.e. the number of the other run's entries placed before it.
    Returns int32 (rank_a [S, n_a], rank_b [S, n_b])."""
    n_a = ar.shape[-1]
    key = pair_key(torch.cat([ar, br], dim=-1), torch.cat([ac, bc], dim=-1))
    order = torch.sort(key, dim=-1, stable=True).indices
    idx = torch.arange(key.shape[-1], device=key.device)
    pos = torch.empty_like(order).scatter_(-1, order, idx.expand_as(order))
    # less the entry's index in its own run
    own = torch.cat([idx[:n_a], idx[:key.shape[-1] - n_a]])
    rank = (pos - own).to(torch.int32)
    return rank[..., :n_a], rank[..., n_a:]


def pair_key(r, c):
    """One int64 per (row, col) pair, in the pairs' lexicographic order for
    the non-negative int32 keys (and I32_MAX pads) the runs hold."""
    return (r.to(torch.int64) << 32) | c.to(torch.int64)


def row_rank_ref(keys: torch.Tensor) -> torch.Tensor:
    """Per-row strict self-rank: ``o[i, j] = |{ k : keys[i, k] < keys[i, j] }|``."""
    return (keys[:, None, :] < keys[:, :, None]).sum(2, dtype=torch.int32)


def row_merge_ref(keys: torch.Tensor, vals: torch.Tensor):
    """Plain version of ``row_merge``: the strict self-rank of every valid
    key (not I32_MAX) is its slot in the merged row (every pad ranks at
    n_valid). Returns (keys, vals) [Q, W]; slots [n_valid, W) hold I32_MAX
    and 0."""
    return apply_row_rank(keys, vals, row_rank_ref(keys))


def apply_row_rank(keys, vals, rank):
    """Place every valid key of ``keys[Q, W]`` and its value at the slot
    ``rank`` names, by a scatter into a buffer of width W + 1 (pads go to
    the spare column); slots [n_valid, W) hold I32_MAX and 0."""
    n_q, n_w = keys.shape
    valid = keys != I32_MAX
    dst = torch.where(valid, rank.to(torch.int64), n_w)
    out_k = torch.full((n_q, n_w + 1), I32_MAX, dtype=torch.int32,
                       device=keys.device)
    out_v = torch.zeros((n_q, n_w + 1), dtype=vals.dtype, device=keys.device)
    out_k.scatter_(1, dst, keys)
    out_v.scatter_(1, dst, torch.where(valid, vals, torch.zeros_like(vals)))
    return out_k[:, :n_w], out_v[:, :n_w]


def merge_sorted_ref(ar, ac, av, br, bc, bv):
    """Concatenate + stable lexicographic sort (A entries precede ties)."""
    r = torch.cat([ar, br], dim=-1)
    c = torch.cat([ac, bc], dim=-1)
    v = torch.cat([av, bv], dim=-1)
    _, order = torch.sort(pair_key(r, c), dim=-1, stable=True)
    return (r.gather(-1, order), c.gather(-1, order), v.gather(-1, order))


def merge_combine_rows_ref(keys, vals):
    """Sort-based version of ``merge_combine_rows``: row-wise ascending key
    order with vals carried along (pad vals are left as they fall)."""
    keys_s, order = torch.sort(keys, dim=1, stable=True)
    return keys_s, vals.gather(1, order)

