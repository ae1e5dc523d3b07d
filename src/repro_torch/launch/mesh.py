"""Production mesh construction (the JAX package's ``launch/mesh.py``).

A function, not a module-level constant: importing this module starts no
process group. ``make_production_mesh`` builds a ``DeviceMesh`` over the
process group that is up, or, with ``fake=True``, first starts a fake
world of 256 (or 512) ranks in this process: every collective on it
returns at once and leaves its output buffer as it is, which is what a
dry run of one rank of the production mesh needs. The JAX package's
``XLA_FLAGS`` fake-device lines have no counterpart: a fake world is a
process group here, not a device count.
"""
from __future__ import annotations

import torch.distributed as dist


def mesh_shape(multi_pod: bool):
    """(shape, axis names) of the production mesh."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def start_fake_world(world_size: int, rank: int = 0) -> None:
    """Make this process rank ``rank`` of a fake world of ``world_size``,
    destroying the process group that was up (a second fake world replaces
    the first)."""
    # The fake backend and its store live in PyTorch's testing package, the
    # one place PyTorch ships them; nothing else of the port imports it.
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)


def make_production_mesh(multi_pod: bool = False, *, fake: bool = False):
    """The ``(16, 16)`` ``("data", "model")`` mesh, or with ``multi_pod``
    the ``(2, 16, 16)`` ``("pod", "data", "model")`` one, over the cards of
    the process group that is up (``fake=True``: a fake world of 256 or 512
    ranks, started here, whose mesh is on the CPU because a dry run
    allocates nothing)."""
    from torch.distributed.device_mesh import init_device_mesh
    shape, axes = mesh_shape(multi_pod)
    n = 1
    for s in shape:
        n *= s
    if fake:
        start_fake_world(n)
    if not dist.is_initialized() or dist.get_world_size() != n:
        have = dist.get_world_size() if dist.is_initialized() else 0
        raise RuntimeError(f"mesh {shape} needs a world of {n} ranks, found "
                           f"{have}: start the process group first, or pass "
                           "fake=True for a dry run")
    return init_device_mesh("cpu" if fake else "cuda", shape,
                            mesh_dim_names=axes)


def batch_axes(multi_pod: bool):
    return ("pod", "data") if multi_pod else ("data",)
