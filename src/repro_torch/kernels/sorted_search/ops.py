"""Public wrappers of the batched rank search: the fence search of the
fused LSM read and range scan. A CUDA tensor goes to the hand kernel
(``csrc/rank_batched.cu``); a CPU tensor to the plain version."""
import torch

from ..common import check_cuda_int32, launch
from .ref import rank_batched_ref


def rank_batched(tabs: torch.Tensor, q: torch.Tensor,
                 strict: bool) -> torch.Tensor:
    """Ranks of ``q[Q]`` in each sorted row of ``tabs[K, N]``: int32
    [K, Q]. Rows must be sorted (pads I32_MAX); both inputs int32."""
    if tabs.dim() != 2 or q.dim() != 1:
        raise ValueError("rank_batched takes tabs[K, N] and q[Q]")
    if tabs.device.type == "cpu":
        return rank_batched_ref(tabs, q, strict)
    check_cuda_int32("rank_batched", tabs, q)
    n_k, n = tabs.shape
    if n_k > 65535:
        raise ValueError(f"rank_batched: K={n_k} exceeds the grid limit")
    out = torch.empty((n_k, q.shape[0]), dtype=torch.int32,
                      device=tabs.device)
    launch("rank_batched", tabs.device, tabs.data_ptr(), n_k, n,
           q.data_ptr(), q.shape[0], int(strict), out.data_ptr())
    return out


def sorted_search_batched(tabs: torch.Tensor, q: torch.Tensor,
                          side: str = "left") -> torch.Tensor:
    """Batched searchsorted: ranks of ``q`` in each row of ``tabs[K, N]``.

    Every row must be sorted and padded with I32_MAX past its valid prefix.
    One kernel launch covers all K runs. Returns int32[K, Q].
    """
    if side not in ("left", "right"):
        raise ValueError(f"side must be 'left' or 'right', got {side!r}")
    tabs = tabs.to(torch.int32).contiguous()
    q = q.to(torch.int32).reshape(-1).contiguous()
    return rank_batched(tabs, q, strict=(side == "left"))


def sorted_search_endpoints(tabs: torch.Tensor, lohi: torch.Tensor):
    """Fence-to-fence endpoint ranks for a ``[lo, hi)`` range scan: the
    ``side='left'`` ranks of both endpoints in each row of ``tabs[K, N]``,
    in ONE kernel launch (``lohi`` is the length-2 [lo, hi] vector; ``hi``
    is exclusive, so both endpoints rank strictly). Returns
    (start[K], end[K]) int32 — the candidate window of each run.
    """
    out = sorted_search_batched(tabs, lohi, "left")
    return out[:, 0], out[:, 1]
