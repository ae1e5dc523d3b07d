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


def rank_ref(tab: torch.Tensor, q: torch.Tensor, strict: bool) -> torch.Tensor:
    """``out[i] = #{tab < q[i]}`` (strict) or ``<= q[i]``: the compare
    count over the one table ``tab[N]``. int32 [Q]."""
    return rank_batched_ref(tab[None], q, strict)[0]

