"""Attention on a device mesh: #7 (``kernels.flash_attention``) on each
rank's shards, placed as the JAX package's rules place them, so that no
rank holds the scores or more of the keys than the rules give it.

``models.layers`` calls ``attend`` where ``plan`` finds a mesh: when q is a
DTensor (a dry run's fake world, or a real mesh), or when the sharding hook
``sh`` (``spec.make_sharder``) carries rules and a mesh while the tensors
are the full values, the same on every rank (the mode of ``moe.
apply_moe_spmd``: each rank computes its part, and the result comes back
whole on every rank). Four cases, the first that applies:

* "context" (the JAX ``_blocked_sdpa``'s context parallelism, taken where
  JAX takes it: causal and Sq >= ``layers.BLOCKED_ATTN_MIN_SQ``). Query
  rows go where JAX's ``attn_q`` sharding puts them: within every
  512-row block, rank r of the model axis holds rows r·512/n .. (r+1)·512/n
  - 1; K and V are whole on that axis (a ``kv_seq``-sharded cache is
  gathered for it, as XLA must). Each rank launches #7 once per block,
  with the rows' global position as ``q_offset``; the output comes back
  in full rows on that axis, and the gradients of K and V are summed
  over it (JAX's ``sh`` transpose).
* "kv_seq" (decode over a cache sharded on ``kv_seq``): each rank attends
  its own key slots and returns ``(o_r, lse_r)``; the ranks merge them by
  an all-reduce max of lse and an all-reduce sum of ``w_r·o_r`` beside
  ``w_r = exp(lse_r - max)`` (on full values: one all-gather of every
  rank's (o_r, lse_r), merged on each rank, ``merge_shards_ref``, which
  halves the host round trips of a staged exchange). No rank gathers the
  cache. A shard whose slots all lie past every query's position weighs
  0 and launches nothing; where only the later rows reach it, #7 runs on
  those rows.
* "heads": the rules shard both heads and KV heads evenly on the same mesh
  dims; each rank attends its own heads, no collective (DTensors only).
* "replicated": any other placement of DTensors; every rank of the
  blocking axes attends the whole heads of its batch shard. It is counted
  in ``sh.fallbacks`` under the op's name, so that a dry run shows it.

On CUDA tensors over gloo the full-value mode's collectives go through
host buffers (``moe._staged``), as ``db.spmd`` stages its exchange; #7
itself always runs on the card.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..kernels.flash_attention import flash_attention, merge_shards_ref
from . import moe
from .spec import axis_sizes, contiguous_stride, placements

Q_BLOCK = 512  # query rows of a block (the JAX ``_blocked_sdpa``'s qb)
OP_NAME = "repro_torch.flash_attention"  # the name a fallback counts under


def _dtensor(t) -> bool:
    if type(t) in (torch.Tensor, torch.nn.Parameter):
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def _mesh_of(q, sh):
    return q.device_mesh if _dtensor(q) else getattr(sh, "mesh", None)


def plan(q, k, sh, *, blocked: bool, kv_sharded: bool) -> Optional[str]:
    """Which case ``attend`` takes for these operands, or None: no mesh
    (one local ``flash_attention`` call)."""
    full_values = not _dtensor(q)
    mesh, rules = _mesh_of(q, sh), getattr(sh, "rules", None)
    if mesh is None or (full_values and rules is None):
        return None
    if rules is None:
        return "replicated"
    sizes = axis_sizes(mesh)
    n_model = sizes.get(rules.model, 1)
    if blocked and n_model > 1 and Q_BLOCK % n_model == 0 \
            and q.shape[1] % Q_BLOCK == 0:
        return "context"
    n_kv = sizes.get(rules.kv_seq, 1) if rules.kv_seq else 1
    if kv_sharded and n_kv > 1 and k.shape[1] % n_kv == 0:
        return "kv_seq"
    if full_values:
        return None
    hq = rules.pspec_for_shape(q.shape, ("batch", None, "heads", None), mesh)
    hk = rules.pspec_for_shape(k.shape, ("batch", None, "kv_heads", None),
                               mesh)
    if hq[2] is not None and hq[2] == hk[2]:
        return "heads"
    return "replicated"


def attend(q, k, v, sh, *, causal: bool, q_offset: int = 0,
           blocked: bool = False, kv_sharded: bool = False):
    """#7 over q [B, Sq, H, hd] and k, v [B, Sk, KV, hd] on the mesh of q
    (a DTensor) or of ``sh`` (full values): [B, Sq, H, hd], a DTensor
    placed on the batch axes only (or, in the "heads" case, on the heads'
    too), or the full value on every rank. ``kv_sharded``: k and v are the
    cache, which the rules place on ``kv_seq``."""
    case = plan(q, k, sh, blocked=blocked, kv_sharded=kv_sharded)
    if case is None:
        raise ValueError("sharded attention: no mesh for these operands")
    if _dtensor(q):
        return _on_dtensors(case, q, k, v, sh, causal, q_offset)
    return _on_full_values(case, q, k, v, sh, causal, q_offset)


def write_cache(cache: torch.Tensor, new: torch.Tensor, pos: int) -> bool:
    """Write ``new`` [B, S, KV, hd] into the DTensor ``cache`` [B, Smax,
    KV, hd] at slot ``pos`` in place, each rank into its own slots of a
    sequence-sharded cache: no rank gathers the cache. False (nothing
    written) unless the cache is a DTensor."""
    if not _dtensor(cache):
        return False
    from torch.distributed.tensor import Replicate, Shard
    mesh, pl = cache.device_mesh, list(cache.placements)
    lo, n = 0, cache.shape[1]  # this rank's slots [lo, lo + n)
    coord = mesh.get_coordinate()
    for i, p in enumerate(pl):
        if isinstance(p, Shard) and p.dim == 1:
            n //= mesh.shape[i]
            lo += coord[i] * n
    # the new rows: on the cache's batch shard, whole along the slots
    want = [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
            for p in pl]
    if _dtensor(new):
        new = new.redistribute(mesh, want).to_local()
    else:
        from torch.distributed.tensor import DTensor
        new = DTensor.from_local(new, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False).redistribute(
            mesh, want).to_local()
    a, b = max(pos, lo), min(pos + new.shape[1], lo + n)
    if a < b:
        cache.to_local()[:, a - lo:b - lo] = new[:, a - pos:b - pos].to(
            cache.dtype)
    return True


# ----------------------------------------------------------- the arithmetic
def _on_shard(q, k, v, causal: bool, off: int):
    """(o, lse) of q over one shard of keys whose first key sits at
    position -off relative to query row 0's position (``off`` = that row's
    position minus the shard's first slot). Rows before the shard's first
    key see none of it: o = 0, lse = -inf, and #7 runs on the rest only
    (none when no row reaches the shard)."""
    if not causal or off >= 0:
        return flash_attention(q, k, v, causal=causal, q_offset=max(off, 0),
                               return_lse=True)
    b, sq, h, hd = q.shape
    first = min(-off, sq)  # rows that see no key of the shard
    o = q.new_zeros(b, first, h, hd)
    lse = q.new_full((b, h, first), float("-inf"), dtype=torch.float32)
    if first < sq:
        o_s, lse_s = flash_attention(q[:, first:], k, v, causal=True,
                                     q_offset=0, return_lse=True)
        o, lse = torch.cat([o, o_s], 1), torch.cat([lse, lse_s], 2)
    return o, lse


def _merge(o_r, lse_r, reduce):
    """The attention over every rank's keys from this rank's (o_r, lse_r):
    ``reduce(t, op)`` all-reduces t over the ranks that hold the other
    keys ("max" or "sum"). The max is a stabiliser (the result does not
    depend on it), so it carries no gradient."""
    b, sq, h, hd = o_r.shape
    top = reduce(lse_r.detach(), "max")
    top = torch.where(torch.isfinite(top), top, torch.zeros_like(top))
    w = torch.exp(lse_r - top).transpose(1, 2)  # [B, Sq, H]; empty: 0
    packed = torch.cat([(o_r.float() * w[..., None]).flatten(2), w], dim=-1)
    tot = reduce(packed, "sum")
    num = tot[..., :h * hd].unflatten(-1, (h, hd))
    den = tot[..., h * hd:].clamp_min(1e-30)
    return (num / den[..., None]).to(o_r.dtype)


def _blocks(q, k, v, causal: bool, q_offset: int, r: int, n: int):
    """This rank's query rows of every 512-row block (``ql`` [B, nq,
    512 / n, H, hd]) attended over the whole K and V, one launch a block:
    [B, nq, 512 / n, H, hd]."""
    rows = Q_BLOCK // n
    return torch.stack([
        flash_attention(q[:, i], k, v, causal=causal,
                        q_offset=q_offset + i * Q_BLOCK + r * rows)
        for i in range(q.shape[1])], dim=1)


# ------------------------------------------------------------------ DTensors
def _on_dtensors(case, q, k, v, sh, causal, q_offset):
    from torch.distributed.tensor import DTensor, Partial, Replicate
    mesh, rules = q.device_mesh, sh.rules if sh is not None else None
    names = list(mesh.mesh_dim_names)
    coord = mesh.get_coordinate()

    def lift(t):  # a plain tensor (a full value) among DTensors
        if _dtensor(t):
            return t
        return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                  run_check=False)

    def pl(shape, axes):
        if rules is None:
            return [Replicate()] * mesh.ndim
        return list(placements(rules.pspec_for_shape(shape, axes, mesh),
                               mesh))

    def local(t, p, summed=()):
        """t's local tensor under placements p; its gradient is this
        rank's part of a sum over the mesh dims ``summed``."""
        grad = [Partial() if i in summed else x for i, x in enumerate(p)]
        return lift(t).redistribute(mesh, p).to_local(grad_placements=grad)

    def wrap(t, p, shape):
        return DTensor.from_local(t, mesh, p, run_check=False,
                                  shape=torch.Size(shape),
                                  stride=contiguous_stride(shape))

    batch4 = ("batch", None, None, None)
    if case == "context":
        b, sq, h, hd = q.shape
        m = names.index(rules.model)
        n = mesh.shape[m]
        shape5 = (b, sq // Q_BLOCK, Q_BLOCK, h, hd)
        pb5 = pl(shape5, ("batch", None, None, None, None))
        q5 = q.redistribute(mesh, pl(q.shape, batch4)).view(shape5)
        pq = pl(shape5, ("batch", None, "attn_q", None, None))
        pk = pl(k.shape, batch4)
        ol = _blocks(local(q5, pq), local(k, pk, (m,)), local(v, pk, (m,)),
                     causal, q_offset, coord[m], n)
        return wrap(ol, pq, shape5).redistribute(mesh, pb5).view(q.shape)
    if case == "kv_seq":
        d = names.index(rules.kv_seq)
        pq = pl(q.shape, batch4)
        pk = pl(k.shape, ("batch", "kv_seq", None, None))
        kl, vl = local(k, pk), local(v, pk)
        o_r, lse_r = _on_shard(local(q, pq, (d,)), kl, vl, causal,
                               q_offset - coord[d] * kl.shape[1])

        def reduce(t, op):
            p = [Partial(op) if i == d else x for i, x in enumerate(pq)]
            shape = (q.shape[0],) + tuple(t.shape[1:])
            return wrap(t, p, shape).redistribute(mesh, pq).to_local()

        return wrap(_merge(o_r, lse_r, reduce), pq, q.shape)
    if case == "heads":
        pq = pl(q.shape, ("batch", None, "heads", None))
        pk = pl(k.shape, ("batch", None, "kv_heads", None))
    else:  # "replicated": counted, so that a dry run shows it
        pq, pk = pl(q.shape, batch4), pl(k.shape, batch4)
        fallbacks = getattr(sh, "fallbacks", None)
        if fallbacks is not None:
            fallbacks[OP_NAME] = fallbacks.get(OP_NAME, 0) + 1
    ol = flash_attention(local(q, pq), local(k, pk), local(v, pk),
                         causal=causal, q_offset=q_offset)
    return wrap(ol, pq, q.shape)


# ------------------------------------------------------------- full values
def _on_full_values(case, q, k, v, sh, causal, q_offset):
    mesh, rules = sh.mesh, sh.rules
    names = list(mesh.mesh_dim_names)
    coord = mesh.get_coordinate()
    axis = rules.model if case == "context" else rules.kv_seq
    i = names.index(axis)
    group, r, n = mesh.get_group(axis), coord[i], mesh.shape[i]
    if torch.is_grad_enabled():  # each rank's gradient is a part of a sum
        q, k, v = (moe._SumGrads.apply(x, [group]) if x.requires_grad else x
                   for x in (q, k, v))
    if case == "context":
        b, sq, h, hd = q.shape
        rows = Q_BLOCK // n
        q5 = q.view(b, sq // Q_BLOCK, Q_BLOCK, h, hd)[:, :, r * rows:
                                                       (r + 1) * rows]
        ol = _blocks(q5, k, v, causal, q_offset, r, n)
        return moe._GatherReplicated.apply(ol, group, 2, r).reshape(q.shape)
    slots = k.shape[1] // n
    keys = slice(r * slots, (r + 1) * slots)
    o_r, lse_r = _on_shard(q, k[:, keys], v[:, keys], causal,
                           q_offset - r * slots)
    b, sq, h, hd = o_r.shape
    mine = torch.cat([o_r.float().flatten(2), lse_r.transpose(1, 2)], -1)
    every = moe._GatherReplicated.apply(mine[None], group, 0, r)
    parts = [(x[..., :h * hd].unflatten(-1, (h, hd)),
              x[..., h * hd:].transpose(1, 2)) for x in every]
    return merge_shards_ref(parts)[0].to(o_r.dtype)
