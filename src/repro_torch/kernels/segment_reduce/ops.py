"""Public wrapper of the segment sum: the combiner iterator behind the
degree table (``kvstore.degree_update``). A CUDA tensor goes to the hand
kernel (``csrc/segment_sum.cu``, shared-memory slabs); a CPU tensor to the
plain version."""
import torch

from ..common import check_cuda, launch
from .ref import segment_sum_ref


def segment_sum(ids: torch.Tensor, vals: torch.Tensor,
                n_segments: int) -> torch.Tensor:
    """Sum ``vals`` into ``n_segments`` buckets by ``ids``: float32
    [n_segments]. Ids < 0 or >= n_segments are dropped (the JAX wrapper
    pads the segments to its block multiple and slices the pad off, which
    drops the same ids)."""
    return _segment_sum(ids, vals, n_segments, direct=False)


def segment_sum_direct(ids: torch.Tensor, vals: torch.Tensor,
                       n_segments: int) -> torch.Tensor:
    """``segment_sum`` by the kernel's earlier design, one global atomic per
    entry: the yardstick the shared-memory slabs are timed against
    (``chip_smoke.py``, ``experiments/segment_sum_ablation.py``). No path
    calls it; a launch counts under ``segment_sum``."""
    return _segment_sum(ids, vals, n_segments, direct=True)


def _segment_sum(ids, vals, n_segments: int, direct: bool) -> torch.Tensor:
    ids = ids.to(torch.int32).reshape(-1).contiguous()
    vals = vals.to(torch.float32).reshape(-1).contiguous()
    if ids.shape != vals.shape:
        raise ValueError(f"segment_sum: {ids.shape[0]} ids, "
                         f"{vals.shape[0]} values")
    if n_segments < 0:
        raise ValueError(f"segment_sum: n_segments={n_segments}")
    if ids.device.type == "cpu":
        return segment_sum_ref(ids, vals, n_segments)
    check_cuda("segment_sum", (ids, torch.int32), (vals, torch.float32))
    if ids.shape[0] > 2 ** 31 - 2 ** 16 or n_segments >= 2 ** 31:
        raise ValueError(f"segment_sum: {ids.shape[0]} entries into "
                         f"{n_segments} segments exceed the int32 indexing")
    out = torch.zeros(n_segments, dtype=torch.float32, device=ids.device)
    launch("segment_sum", ids.device, ids.data_ptr(), vals.data_ptr(),
           ids.shape[0], n_segments, int(direct), out.data_ptr())
    return out
