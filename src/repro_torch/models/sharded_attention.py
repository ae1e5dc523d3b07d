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
  with the rows' global position as ``q_offset``; the gradients of K and V
  are summed over the axis (JAX's ``sh`` transpose). On DTensors q comes
  from the heads placement and the output goes back to it by one
  all-to-all each (XLA's move); on full values the output comes back in
  full rows on every rank.
* "kv_seq" (decode over a cache sharded on ``kv_seq``): each rank attends
  its own key slots and returns ``(o_r, lse_r)``; the ranks merge them by
  an all-reduce max of lse and an all-reduce sum of ``w_r·o_r`` beside
  ``w_r = exp(lse_r - max)`` (on full values: one all-gather of every
  rank's (o_r, lse_r), merged on each rank, ``merge_shards_ref``, which
  halves the host round trips of a staged exchange). No rank gathers the
  cache. A shard whose slots all lie past every query's position weighs
  0 and launches nothing; where only the later rows reach it, #7 runs on
  those rows.
* "heads": the rules shard heads on the model axis (DTensors only). Each
  rank attends its own query heads, DTensor's split of the heads dim
  (``heads_placement``: ceil(H/n) a rank from rank 0 up, so that a head
  count the axis does not divide leaves the last ranks none), over the KV
  heads those queries use (``_kv_for_heads``: one all-to-all brings a rank
  the KV heads another rank holds; none where every rank holds its own).
  A rank with no heads launches nothing.
* "replicated": any other placement of DTensors; every rank of the
  blocking axes attends the whole heads of its batch shard. It is counted
  in ``sh.fallbacks`` under the op's name, so that a dry run shows it.

``split_heads`` and ``merge_heads`` take q, k, v from the projections'
flattened ``heads`` placement (each rank a run of columns, which cuts
heads apart where the axis does not divide them) to the heads placement
and the output back, by one all-to-all each: DTensor refuses that view.
These all-to-alls are ``moe.exchange`` (``dist.all_to_all_single`` on
the local tensors, uneven splits allowed): DTensor's shard-to-shard
redistribution is an all-gather on a CPU mesh, and the dry run's fake
world is one.

On CUDA tensors over gloo these collectives go through host buffers
(``moe._collective``), as ``db.spmd`` stages its exchange; #7 itself
always runs on the card.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from ..kernels.flash_attention import flash_attention, merge_shards_ref
from . import moe
from .spec import axis_sizes, contiguous_stride, placements, shard_mesh_dim

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
    if rules.of("heads") in sizes:
        return "heads"
    return "replicated"


def attend(q, k, v, sh, *, causal: bool, q_offset: int = 0,
           blocked: bool = False, kv_sharded: bool = False):
    """#7 over q [B, Sq, H, hd] and k, v [B, Sk, KV, hd] on the mesh of q
    (a DTensor) or of ``sh`` (full values): [B, Sq, H, hd], a DTensor
    placed on the batch axes (and, in the "heads" and "context" cases, on
    the heads), or the full value on every rank. ``kv_sharded``: k and v
    are the cache, which the rules place on ``kv_seq``."""
    case = plan(q, k, sh, blocked=blocked, kv_sharded=kv_sharded)
    if case is None:
        raise ValueError("sharded attention: no mesh for these operands")
    if _dtensor(q):
        return _on_dtensors(case, q, k, v, sh, causal, q_offset)
    return _on_full_values(case, q, k, v, sh, causal, q_offset)


def write_cache(cache: torch.Tensor, new: torch.Tensor, pos: int) -> bool:
    """Write ``new`` [B, S, KV, hd] into the DTensor ``cache`` [B, Smax,
    KV, hd] at slot ``pos`` in place, each rank into its own slots of a
    sequence-sharded cache: no rank gathers the cache. Where ``new`` holds
    its heads on the mesh dim that shards the slots (its batch placed as
    the cache's), one all-to-all brings each rank the rows of its slots
    (XLA's move), else ``new`` is made whole along the slots. False
    (nothing written) unless the cache is a DTensor."""
    if not _dtensor(cache):
        return False
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh, pl = cache.device_mesh, list(cache.placements)
    lo, n = 0, cache.shape[1]  # this rank's slots [lo, lo + n)
    coord = mesh.get_coordinate()
    slot_dims = [i for i, p in enumerate(pl)
                 if isinstance(p, Shard) and p.dim == 1]
    for i in slot_dims:
        n //= mesh.shape[i]
        lo += coord[i] * n
    if not _dtensor(new):
        new = DTensor.from_local(new, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    i = shard_mesh_dim(new, 2)
    if slot_dims == [i] and all(p == new.placements[j]
                                for j, p in enumerate(pl) if j != i):
        # heads -> slots: rank s gets the rows of its slots, all heads
        span = (pos, pos + new.shape[1])
        rows = [(max(span[0], s * n), min(span[1], (s + 1) * n))
                for s in range(mesh.shape[i])]
        nl = new.to_local()
        heads = head_chunks(new.shape[2], mesh.shape[i])
        a, b = rows[coord[i]]
        mine = max(b - a, 0)
        got = moe.exchange(
            [nl[:, ra - pos:rb - pos] if ra < rb else nl[:, :0]
             for ra, rb in rows],
            [(nl.shape[0], mine, hi - hl, nl.shape[3]) for hl, hi in heads],
            mesh.get_group(i), 2)
    else:  # the new rows on the cache's batch shard, whole along the slots
        want = [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
                for p in pl]
        a, b = max(pos, lo), min(pos + new.shape[1], lo + n)
        got = new.redistribute(mesh, want).to_local()[:, a - pos:b - pos]
    if a < b:
        cache.to_local()[:, a - lo:b - lo] = got.to(cache.dtype)
    return True


# ------------------------------------------------------- the heads placement
def head_chunks(n_heads: int, n: int) -> List[Tuple[int, int]]:
    """The heads [lo, hi) of each of n ranks under DTensor's split of a
    heads dim (``torch.chunk``): ceil(n_heads / n) a rank from rank 0 up,
    the last ranks none where that runs out (9 heads on 16 ranks: one each
    to ranks 0-8)."""
    size = -(-n_heads // n)
    return [(min(r * size, n_heads), min((r + 1) * size, n_heads))
            for r in range(n)]


def _regroup(xl, own, want, r: int, group, dim: int = -1):
    """This rank's ``xl``, the indices ``own[r]`` ([lo, hi)) of ``dim``,
    regrouped so that each rank s holds ``want[s]``: one all-to-all. Both
    are runs that cover the dim from rank 0 up."""
    dim = dim % xl.dim()
    lo = own[r][0]

    def cut(a, b):
        return max(a[0], b[0]), min(a[1], b[1])

    pieces, shapes = [], []
    for s in range(len(own)):
        a, b = cut(own[r], want[s])
        pieces.append(xl.narrow(dim, a - lo, b - a) if a < b else
                      xl.narrow(dim, 0, 0))
        a, b = cut(own[s], want[r])
        shape = list(xl.shape)
        shape[dim] = max(b - a, 0)
        shapes.append(shape)
    return moe.exchange(pieces, shapes, group, dim)


def _wrap(t, mesh, pl, shape):
    """The DTensor of local shards ``t``, whose global ``shape`` has a
    contiguous stride: so ``t`` is made contiguous (the plain attention's
    output is a permuted view)."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(t.contiguous(), mesh, pl, run_check=False,
                              shape=torch.Size(shape),
                              stride=contiguous_stride(shape))


def split_heads(x, n_heads: int, hd: int):
    """x [..., n_heads * hd] as [..., n_heads, hd]. A DTensor whose last
    dim one mesh dim shards into runs that cut heads apart (``n_heads``
    not a multiple of its size) goes to the heads placement on that mesh
    dim by one all-to-all; any other tensor is viewed."""
    shape = tuple(x.shape[:-1]) + (n_heads, hd)
    i = shard_mesh_dim(x, -1) if _dtensor(x) else None
    if i is None or n_heads % x.device_mesh.shape[i] == 0:
        return x.reshape(shape)
    mesh = x.device_mesh
    n, r = mesh.shape[i], mesh.get_coordinate()[i]
    c = x.shape[-1] // n
    heads = head_chunks(n_heads, n)
    xl = _regroup(x.to_local(), [(s * c, (s + 1) * c) for s in range(n)],
                  [(a * hd, b * hd) for a, b in heads], r, mesh.get_group(i))
    out = xl.unflatten(-1, (heads[r][1] - heads[r][0], hd))
    return _wrap(out, mesh, x.placements, shape)


def merge_heads(x):
    """x [..., H, hd] as [..., H * hd]: ``split_heads`` reversed (a DTensor
    on an uneven heads placement goes back to even runs of columns by one
    all-to-all)."""
    *lead, h, hd = x.shape
    shape = tuple(lead) + (h * hd,)
    i = shard_mesh_dim(x, -2) if _dtensor(x) else None
    if i is None or h % x.device_mesh.shape[i] == 0:
        return x.reshape(shape)
    mesh = x.device_mesh
    n, r = mesh.shape[i], mesh.get_coordinate()[i]
    c = h * hd // n
    xl = _regroup(x.to_local().flatten(-2),
                  [(a * hd, b * hd) for a, b in head_chunks(h, n)],
                  [(s * c, (s + 1) * c) for s in range(n)], r,
                  mesh.get_group(i))
    return _wrap(xl, mesh, x.placements, shape)


def _kv_heads_needed(h: int, kvh: int, lo: int, hi: int) -> List[int]:
    """The KV heads that query heads [lo, hi) of h use (head j uses KV
    head j // (h / kvh)), in the order #7 reads them: each once where the
    rank's heads map onto them as #7 maps GQA groups, else one per query
    head."""
    rep = h // kvh
    per_head = [j // rep for j in range(lo, hi)]
    if not per_head:
        return []
    first, m = per_head[0], per_head[-1] - per_head[0] + 1
    g = (hi - lo) // m
    if g * m == hi - lo and all(kv - first == j // g
                                for j, kv in enumerate(per_head)):
        return list(range(first, first + m))
    return per_head


def _kv_for_heads(kl, vl, h: int, kvh: int, kv_sharded: bool, r: int,
                  n: int, group):
    """This rank's KV heads for its query heads (``head_chunks(h, n)[r]``),
    from its local k and v [b, S, ·, hd]: all KV heads (``kv_sharded``
    False) or its own chunk of them. One all-to-all of k and v together
    brings each rank the KV heads another rank holds (the backward sums
    a head's gradient back to its holder); none where every rank holds
    what it uses."""
    need = [_kv_heads_needed(h, kvh, a, b) for a, b in head_chunks(h, n)]
    if not kv_sharded:
        idx = torch.tensor(need[r], dtype=torch.long, device=kl.device)
        return kl.index_select(2, idx), vl.index_select(2, idx)
    own = head_chunks(kvh, n)
    if all(need[s] == list(range(*own[s])) for s in range(n)):
        return kl, vl
    kv = torch.stack([kl, vl])  # [2, b, S, own, hd]: one exchange for both
    lo, hi = own[r]
    pieces, shapes = [], []
    for s in range(n):
        mine = [j - lo for j in need[s] if lo <= j < hi]
        pieces.append(kv.index_select(3, torch.tensor(
            mine, dtype=torch.long, device=kv.device)))
        shape = list(kv.shape)
        shape[3] = sum(1 for j in need[r] if own[s][0] <= j < own[s][1])
        shapes.append(shape)
    kv = moe.exchange(pieces, shapes, group, 3)
    return kv[0], kv[1]


class _NoHeads(torch.autograd.Function):
    """The output of a rank that holds no query heads: q's empty shape, no
    launch. Its gradient reaches q, k and v (as zeros), so that this rank
    runs the backward's all-to-alls with the others."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.like = [(t.shape, t.dtype, t.device) for t in (k, v)]
        return q.new_empty(q.shape)

    @staticmethod
    def backward(ctx, g):
        return (g.new_zeros(g.shape), *(torch.zeros(s, dtype=d, device=dev)
                                        for s, d, dev in ctx.like))


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
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
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
        return _wrap(t, mesh, p, shape)

    batch4 = ("batch", None, None, None)
    m = names.index(rules.model) if rules is not None else None

    def heads_placement(shape, dim):
        """The batch axes' placements, and ``Shard(dim)`` (uneven where the
        axis does not divide the heads) on the model axis."""
        p = pl(shape, ("batch",) + (None,) * (len(shape) - 1))
        p[m] = Shard(dim)
        return p

    if case == "context":
        b, sq, h, hd = q.shape
        n, r = mesh.shape[m], coord[m]
        rows, nb = Q_BLOCK // n, sq // Q_BLOCK
        pk = pl(k.shape, batch4)
        kl, vl = local(k, pk, (m,)), local(v, pk, (m,))
        # heads -> this rank's rows of every block, and back: XLA's moves
        ph = heads_placement(q.shape, 2)
        group, heads = mesh.get_group(m), head_chunks(h, n)
        ql = local(q, ph)
        b_l, h_r = ql.shape[0], ql.shape[2]
        ql = moe.exchange(
            [ql.unflatten(1, (nb, Q_BLOCK))[:, :, s * rows:(s + 1) * rows]
             for s in range(n)],
            [(b_l, nb, rows, hi - lo, hd) for lo, hi in heads], group, 3)
        ol = _blocks(ql, kl, vl, causal, q_offset, r, n)
        ol = moe.exchange([ol[:, :, :, lo:hi] for lo, hi in heads],
                          [(b_l, nb, rows, h_r, hd)] * n, group, 2)
        return wrap(ol.flatten(1, 2), ph, q.shape)
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
        h, kvh = q.shape[2], k.shape[2]
        n, r = mesh.shape[m], coord[m]
        pq = heads_placement(q.shape, 2)
        kv_sharded = all(_dtensor(t) and isinstance(t.placements[m], Shard)
                         and t.placements[m].dim == 2 for t in (k, v))
        pk = heads_placement(k.shape, 2) if kv_sharded else pl(k.shape,
                                                                batch4)
        ql = local(q, pq)
        kl, vl = _kv_for_heads(local(k, pk), local(v, pk), h, kvh,
                               kv_sharded, r, n, mesh.get_group(m))
        if ql.shape[2] == 0:  # no heads here: no launch
            ol = _NoHeads.apply(ql, kl, vl)
        else:
            ol = flash_attention(ql, kl, vl, causal=causal,
                                 q_offset=q_offset)
        return wrap(ol, pq, q.shape)
    # "replicated": counted, so that a dry run shows it
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
