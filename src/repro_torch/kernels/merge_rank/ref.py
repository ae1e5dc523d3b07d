"""Plain PyTorch versions of the merge-rank kernels and of the merges
built on them (the definitions the CUDA kernels are held against)."""
import torch

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


def row_rank_ref(keys: torch.Tensor) -> torch.Tensor:
    """Per-row strict self-rank: ``o[i, j] = |{ k : keys[i, k] < keys[i, j] }|``."""
    return (keys[:, None, :] < keys[:, :, None]).sum(2, dtype=torch.int32)


def merge_sorted_ref(ar, ac, av, br, bc, bv):
    """Concatenate + stable lexicographic sort (A entries precede ties)."""
    r = torch.cat([ar, br], dim=-1)
    c = torch.cat([ac, bc], dim=-1)
    v = torch.cat([av, bv], dim=-1)
    key = (r.to(torch.int64) << 32) | c.to(torch.int64)
    _, order = torch.sort(key, dim=-1, stable=True)
    return (r.gather(-1, order), c.gather(-1, order), v.gather(-1, order))


def merge_combine_rows_ref(keys, vals):
    """Sort-based version of ``merge_combine_rows``: row-wise ascending key
    order with vals carried along (pad vals are left as they fall)."""
    keys_s, order = torch.sort(keys, dim=1, stable=True)
    return keys_s, vals.gather(1, order)

