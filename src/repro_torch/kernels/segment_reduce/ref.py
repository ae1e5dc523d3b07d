"""Plain PyTorch version of the segment sum (what the CUDA kernel is held
against)."""
import torch


def segment_sum_ref(ids: torch.Tensor, vals: torch.Tensor,
                    n_segments: int) -> torch.Tensor:
    """Scatter-add; ids < 0 or >= n_segments are dropped."""
    valid = (ids >= 0) & (ids < n_segments)
    safe = torch.where(valid, ids, torch.zeros_like(ids)).long()
    contrib = torch.where(valid, vals.to(torch.float32),
                          torch.zeros((), dtype=torch.float32,
                                      device=vals.device))
    return torch.zeros(n_segments, dtype=torch.float32,
                       device=ids.device).index_add_(0, safe, contrib)
