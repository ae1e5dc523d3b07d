"""Plain PyTorch versions of the batched rank search (the definition the
CUDA kernel is held against)."""
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


def sorted_search_batched_ref(tabs, q, side: str = "left"):
    """Per-run searchsorted over stacked I32_MAX-padded runs ``tabs[K, N]``
    (pads count only for queries >= I32_MAX, which real ids never are)."""
    return rank_batched_ref(tabs, q, strict=(side == "left"))
