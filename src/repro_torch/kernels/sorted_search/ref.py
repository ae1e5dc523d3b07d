"""Plain PyTorch versions of the rank searches (the definitions the CUDA
kernels are held against)."""
import torch

# compare-count chunking: at most this many [query, table] pairs at once
_CHUNK = 1 << 24


def rank_batched_ref(tabs: torch.Tensor, q: torch.Tensor,
                     strict: bool) -> torch.Tensor:
    """``out[k, i] = #{tabs[k, :] < q[i]}`` (strict) or ``<= q[i]``: the
    compare count itself, for any rows, sorted or not. int32 [K, Q]."""
    n_k, n = tabs.shape
    n_q = q.shape[0]
    out = torch.empty((n_k, n_q), dtype=torch.int32, device=tabs.device)
    step = max(1, _CHUNK // max(1, n_k * n))
    for i in range(0, n_q, step):
        qi = q[i:i + step][None, :, None]
        cmp = (tabs[:, None, :] < qi) if strict else (tabs[:, None, :] <= qi)
        out[:, i:i + step] = cmp.sum(-1, dtype=torch.int32)
    return out


def rank_sides_ref(tabs: torch.Tensor, q: torch.Tensor,
                   side: str) -> torch.Tensor:
    """Plain version of ``rank_batched``: ``rank_batched_ref`` strict for
    ``side="left"``, non-strict for ``"right"``, the two stacked (int32
    [2, K, Q]) for ``"both"``."""
    if side == "both":
        return torch.stack([rank_batched_ref(tabs, q, True),
                            rank_batched_ref(tabs, q, False)])
    return rank_batched_ref(tabs, q, side == "left")


def sorted_search_batched_ref(tabs, q, side: str = "left"):
    """Per-run searchsorted over stacked I32_MAX-padded runs ``tabs[K, N]``
    (pads count only for queries >= I32_MAX, which real ids never are)."""
    return rank_batched_ref(tabs, q, strict=(side == "left"))


def rank_ref(tab: torch.Tensor, q: torch.Tensor, side: str) -> torch.Tensor:
    """Plain version of ``rank``: the compare count over the one table
    ``tab[N]``, ``tab < q[i]`` for ``side="left"``, ``<=`` for
    ``"right"`` (int32 [Q]), the two stacked for ``"both"`` (int32
    [2, Q])."""
    return rank_sides_ref(tab[None], q, side)[..., 0, :]


def tablet_gather_ref(cols, vals, start, ends, q, total: int):
    """Plain version of ``tablet_gather``: query ``i``'s ``cnt[i] = ends[i]
    - ends[i - 1]`` entries from ``start[i]`` of the tablet, at offsets
    ``ends[i] - cnt[i]`` onward of the output, with ``q[i]`` beside each.
    Returns (r int32, c int32, v float32) [total]."""
    cnt = torch.diff(ends, prepend=ends.new_zeros(1))
    i = torch.repeat_interleave(torch.arange(q.shape[0], device=q.device),
                                cnt.long(), output_size=total)
    src = (start.long()[i] + torch.arange(total, device=q.device)
           - (ends - cnt).long()[i])
    return q[i], cols[src], vals[src]


def tablet_read_ref(rows, cols, vals, q):
    """Plain version of ``tablet_read``: the single engine's point read as
    it was before the compacting kernel, on PyTorch's ops. Both ranks by
    ``torch.searchsorted``, the ``[Q, top]`` candidate block of the longest
    queried row (what the batch scanner's widen reaches), then ``nonzero``
    in row-major order. Returns (r int32, c int32, v float32)."""
    start = torch.searchsorted(rows, q, out_int32=True)
    end = torch.searchsorted(rows, q, right=True, out_int32=True)
    top = int((end - start).max()) if q.shape[0] else 0
    idx = start[:, None] + torch.arange(top, dtype=torch.int32,
                                        device=q.device)[None, :]
    ok = idx < end[:, None]
    idxc = idx.clamp(0, max(rows.shape[0] - 1, 0)).long()
    qi, ki = torch.nonzero(ok, as_tuple=True)
    src = idxc[qi, ki]
    return q[qi], cols[src], vals[src]
