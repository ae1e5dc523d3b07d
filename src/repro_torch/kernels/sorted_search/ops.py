"""Public wrappers of the rank searches: the 1-D search of the legacy
single-run engine's point reads and the compacting copy that finishes them
(``csrc/rank.cu``; ``tablet_read`` runs the two), and the batched fence
search of the fused LSM read and range scan (``csrc/rank_batched.cu``). A
CUDA tensor goes to the hand kernel; a CPU tensor to the plain version."""
import torch

from ..common import check_cuda, launch
from .ref import rank_ref, rank_sides_ref, tablet_gather_ref

_SIDES = {"left": 0, "right": 1, "both": 2}


def rank(tab: torch.Tensor, q: torch.Tensor, side: str) -> torch.Tensor:
    """Ranks of ``q[Q]`` in the sorted table ``tab[N]`` (pads I32_MAX; both
    inputs int32): ``side="left"`` counts the entries < q, ``"right"`` those
    <= q, each int32 [Q]; ``"both"`` gives the two in one launch, stacked
    left first: int32 [2, Q]. On the card, a 32-lane warp search."""
    return _rank(tab, q, side, binary=False)


def rank_binary(tab: torch.Tensor, q: torch.Tensor, side: str) -> torch.Tensor:
    """``rank`` by the kernel's earlier design, one thread a query and a
    binary search per side: the yardstick the warp search is timed against
    (``chip_smoke.py``). No path calls it; a launch counts under
    ``rank``."""
    return _rank(tab, q, side, binary=True)


def _rank(tab, q, side: str, binary: bool) -> torch.Tensor:
    if side not in _SIDES:
        raise ValueError(f"side must be one of {sorted(_SIDES)}, got {side!r}")
    if tab.dim() != 1 or q.dim() != 1:
        raise ValueError("rank takes tab[N] and q[Q]")
    if tab.device.type == "cpu":
        return rank_ref(tab, q, side)
    check_cuda("rank", (tab, torch.int32), (q, torch.int32))
    n_q = q.shape[0]
    out = torch.empty((n_q,) if side != "both" else (2, n_q),
                      dtype=torch.int32, device=tab.device)
    if n_q:
        launch("rank", tab.device, tab.data_ptr(), tab.shape[0], q.data_ptr(),
               n_q, _SIDES[side], int(binary), out.data_ptr())
    return out


def sorted_search(tab: torch.Tensor, q: torch.Tensor,
                  side: str = "left") -> torch.Tensor:
    """Vectorized searchsorted: positions of ``q`` in sorted 1-D ``tab``.

    ``tab`` must be padded with I32_MAX beyond its valid prefix (the pad
    never counts: every real query is < I32_MAX). Returns int32[Q]; with
    ``side="both"`` the left and right positions of one launch, int32
    [2, Q].
    """
    tab = tab.to(torch.int32).reshape(-1).contiguous()
    q = q.to(torch.int32).reshape(-1).contiguous()
    return rank(tab, q, side)


def tablet_gather(cols: torch.Tensor, vals: torch.Tensor, start: torch.Tensor,
                  ends: torch.Tensor, q: torch.Tensor, total: int):
    """The compacting copy of the single engine's point read: query ``i``
    owns the ``cnt[i] = ends[i] - ends[i - 1]`` tablet entries from
    ``start[i]`` (``ends`` is the inclusive sum of the counts, ``total`` its
    last value), written at output offsets ``ends[i] - cnt[i]`` onward with
    ``q[i]`` beside each. Returns (r int32, c int32, v float32) [total]."""
    if cols.dim() != 1 or cols.shape != vals.shape:
        raise ValueError("tablet_gather takes cols[N] and vals[N]")
    if not start.shape == ends.shape == q.shape or q.dim() != 1:
        raise ValueError("tablet_gather takes start, ends and q of one [Q]")
    if cols.device.type == "cpu":
        return tablet_gather_ref(cols, vals, start, ends, q, total)
    check_cuda("tablet_gather", (cols, torch.int32), (vals, torch.float32),
               (start, torch.int32), (ends, torch.int32), (q, torch.int32))
    if not 0 <= total <= 2 ** 31 - 2 ** 11:
        raise ValueError(f"tablet_gather: {total} entries exceed the int32 "
                         "indexing")
    dev = cols.device
    r = torch.empty(total, dtype=torch.int32, device=dev)
    c = torch.empty(total, dtype=torch.int32, device=dev)
    v = torch.empty(total, dtype=torch.float32, device=dev)
    if total:
        launch("tablet_gather", dev, cols.data_ptr(), vals.data_ptr(),
               start.data_ptr(), ends.data_ptr(), q.data_ptr(), q.shape[0],
               total, r.data_ptr(), c.data_ptr(), v.data_ptr())
    return r, c, v


def tablet_read(rows: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor,
                q: torch.Tensor):
    """Every entry of every queried row of one tablet (``rows[N]`` sorted,
    I32_MAX pads; ``cols``, ``vals`` [N]), in query order and then in run
    order, duplicate queries repeated: (r int32, c int32, v float32)
    [total]. One two-sided ``rank`` launch, a scan of the counts, one host
    read of the total, and one ``tablet_gather`` launch (none when no
    entry matches). On the CPU both take their plain versions."""
    q = q.to(torch.int32).reshape(-1).contiguous()
    ranks = rank(rows, q, "both")
    ends = torch.cumsum(ranks[1] - ranks[0], 0, dtype=torch.int32)
    total = int(ends[-1]) if q.shape[0] else 0
    if total == 0:
        z = torch.empty(0, dtype=torch.int32, device=rows.device)
        return z, z.clone(), torch.empty(0, dtype=torch.float32,
                                         device=rows.device)
    return tablet_gather(cols, vals, ranks[0], ends, q, total)


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
