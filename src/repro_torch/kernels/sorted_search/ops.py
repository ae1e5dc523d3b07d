"""Public wrappers of the rank searches: the 1-D search of the legacy
single-run engine's point reads (``csrc/rank.cu``) and the batched fence
search of the fused LSM read and range scan (``csrc/rank_batched.cu``). A
CUDA tensor goes to the hand kernel; a CPU tensor to the plain version."""
import torch

from ..common import check_cuda, launch
from .ref import rank_ref, rank_sides_ref


def rank(tab: torch.Tensor, q: torch.Tensor, strict: bool) -> torch.Tensor:
    """Ranks of ``q[Q]`` in the sorted table ``tab[N]`` (pads I32_MAX):
    int32 [Q]. Both inputs int32."""
    if tab.dim() != 1 or q.dim() != 1:
        raise ValueError("rank takes tab[N] and q[Q]")
    if tab.device.type == "cpu":
        return rank_ref(tab, q, strict)
    check_cuda("rank", (tab, torch.int32), (q, torch.int32))
    out = torch.empty(q.shape[0], dtype=torch.int32, device=tab.device)
    launch("rank", tab.device, tab.data_ptr(), tab.shape[0], q.data_ptr(),
           q.shape[0], int(strict), out.data_ptr())
    return out


def sorted_search(tab: torch.Tensor, q: torch.Tensor,
                  side: str = "left") -> torch.Tensor:
    """Vectorized searchsorted: positions of ``q`` in sorted 1-D ``tab``.

    ``tab`` must be padded with I32_MAX beyond its valid prefix (the pad
    never counts: every real query is < I32_MAX). Returns int32[Q].
    """
    if side not in ("left", "right"):
        raise ValueError(f"side must be 'left' or 'right', got {side!r}")
    tab = tab.to(torch.int32).reshape(-1).contiguous()
    q = q.to(torch.int32).reshape(-1).contiguous()
    return rank(tab, q, strict=(side == "left"))


_SIDES = {"left": 0, "right": 1, "both": 2}


def rank_batched(tabs: torch.Tensor, q: torch.Tensor,
                 side: str) -> torch.Tensor:
    """Ranks of ``q[Q]`` in each sorted row of ``tabs[K, N]`` (pads
    I32_MAX; both inputs int32): ``side="left"`` counts the entries < q,
    ``"right"`` those <= q, each int32 [K, Q]; ``"both"`` gives the two in
    one launch, stacked left first: int32 [2, K, Q]."""
    if side not in _SIDES:
        raise ValueError(f"side must be one of {sorted(_SIDES)}, got {side!r}")
    if tabs.dim() != 2 or q.dim() != 1:
        raise ValueError("rank_batched takes tabs[K, N] and q[Q]")
    if tabs.device.type == "cpu":
        return rank_sides_ref(tabs, q, side)
    check_cuda("rank_batched", (tabs, torch.int32),
               (q, torch.int32))
    n_k, n = tabs.shape
    if n_k > 65535:
        raise ValueError(f"rank_batched: K={n_k} exceeds the grid limit")
    shape = (n_k, q.shape[0]) if side != "both" else (2, n_k, q.shape[0])
    out = torch.empty(shape, dtype=torch.int32, device=tabs.device)
    launch("rank_batched", tabs.device, tabs.data_ptr(), n_k, n,
           q.data_ptr(), q.shape[0], _SIDES[side], out.data_ptr())
    return out


def sorted_search_batched(tabs: torch.Tensor, q: torch.Tensor,
                          side: str = "left") -> torch.Tensor:
    """Batched searchsorted: ranks of ``q`` in each row of ``tabs[K, N]``.

    Every row must be sorted and padded with I32_MAX past its valid prefix.
    One kernel launch covers all K runs. Returns int32[K, Q]; with
    ``side="both"`` the left and right ranks of one launch, int32
    [2, K, Q].
    """
    tabs = tabs.to(torch.int32).contiguous()
    q = q.to(torch.int32).reshape(-1).contiguous()
    return rank_batched(tabs, q, side)


def sorted_search_endpoints(tabs: torch.Tensor, lohi: torch.Tensor):
    """Fence-to-fence endpoint ranks for a ``[lo, hi)`` range scan: the
    ``side='left'`` ranks of both endpoints in each row of ``tabs[K, N]``,
    in ONE kernel launch (``lohi`` is the length-2 [lo, hi] vector; ``hi``
    is exclusive, so both endpoints rank strictly). Returns
    (start[K], end[K]) int32 — the candidate window of each run.
    """
    out = sorted_search_batched(tabs, lohi, "left")
    return out[:, 0], out[:, 1]
