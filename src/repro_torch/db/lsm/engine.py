"""Leveled LSM run structure — the multi-run tablet server storage engine.

The PyTorch counterpart of ``repro.db.lsm.engine``, with the same layout:

  memtable (unsorted, in ``ShardedTable``)
     │ minor compaction: sort + dedup, O(m log m)
     ▼
  L0: up to ``l0_slots`` independent sorted runs of memtable size
     │ major compaction when a shard's L0 fills: k-way merge by the
     │ merge-path rank kernel (``kernels.merge_rank.kway_merge``)
     ▼
  L1..Ld: one geometrically larger sorted run per level

Each run carries a packed bloom filter over its row ids and fence pointers
(block-start row ids). Combiner semantics hold across any flush/compaction
schedule because every merge preserves age order within equal-key groups
and every dedup applies the same combiner.

All state is stacked [S, ...] across shards on ``device``; a JAX ``vmap``
over shards is the leading [S] dimension here, so a flush or a compaction
is one pass over all S shards. Point reads go through the fused path: per
query tile, every resident run of the shard (levels deepest first, the
used L0 slots, the memtable tail) is fence-searched by the batched rank
kernel, bloom-masked, and combined on the device by the row-rank merge,
with ONE host sync per tile. Range scans are one fused pass per shard.
Under ``use_pallas`` the three hand kernels run (on the card; their plain
versions for CPU tensors); without it the same path runs on PyTorch ops.
"""
from __future__ import annotations

from time import perf_counter
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ...kernels.common import I32_MAX, resolve_device
from ...kernels.merge_rank import kway_merge, merge_combine_rows
from ...kernels.sorted_search import (sorted_search_batched,
                                      sorted_search_endpoints)
from ...obs import default_registry, default_tracer
from ..kvstore import _dedup_combine
from .bloom import (BITS_PER_KEY, MAX_HASHES, NUM_HASHES, bloom_build,
                    bloom_maybe_contains, bloom_maybe_contains_batch,
                    fence_build, num_words, theoretical_fp_rate)


def fence_block(cap: int) -> int:
    """Fence block size: small enough to bracket, large enough to amortize."""
    if cap < 32:
        return max(1, cap // 2)
    return max(16, min(1024, cap // 16))


def plan_levels(capacity_per_shard: int, mem_cap: int, l0_slots: int,
                fanout: int) -> List[int]:
    """Static per-level run capacities L1..Ld (geometric; deepest holds
    everything the structure can legally contain)."""
    need = l0_slots * mem_cap  # max entries a full L0 pushes down
    caps: List[int] = []
    c = need  # L1 absorbs exactly one L0's worth -> cheap frequent merges
    while c < capacity_per_shard:
        caps.append(c)
        c *= fanout
    caps.append(max(capacity_per_shard, need + sum(caps)))
    return caps


def _per_level(spec: Union[int, Sequence[int]], n_levels: int) -> Tuple[int, ...]:
    """Expand a scalar-or-sequence sizing spec to one value per level (a
    short sequence repeats its last entry for the deeper levels)."""
    if isinstance(spec, (int, np.integer)):
        return (int(spec),) * n_levels
    spec = tuple(int(x) for x in spec)
    if not spec:
        raise ValueError("empty bloom sizing spec")
    return tuple(spec[min(i, len(spec) - 1)] for i in range(n_levels))


def _bucket(n: int, lo: int = 8) -> int:
    """Next pow2 >= max(n, lo): the query-tile and window widths."""
    return 1 << (max(n, lo) - 1).bit_length()


# ---------------------------------------------------------------- device ops
def _compact(keep, r, c, v, out_cap: int):
    """Move the kept entries of each row of ``[..., L]`` to the front of an
    ``out_cap``-wide run (pads I32_MAX / 0). Entries past ``out_cap`` are
    dropped: the scatter goes into a buffer one slot wider, then a slice."""
    pos = torch.cumsum(keep, dim=-1) - 1
    idx = torch.where(keep & (pos < out_cap), pos, out_cap)
    shape = r.shape[:-1] + (out_cap + 1,)
    rr = torch.full(shape, I32_MAX, dtype=torch.int32, device=r.device)
    cc = torch.full(shape, I32_MAX, dtype=torch.int32, device=r.device)
    vv = torch.zeros(shape, dtype=torch.float32, device=r.device)
    rr.scatter_(-1, idx, r.to(torch.int32))
    cc.scatter_(-1, idx, c.to(torch.int32))
    vv.scatter_(-1, idx, v.to(torch.float32))
    n = keep.sum(-1)
    return rr[..., :out_cap], cc[..., :out_cap], vv[..., :out_cap], n


def _sort_dedup(r, c, v, combiner: str):
    """Sort each buffer ``[..., cap]`` lex by (row, col), apply the combiner,
    compact valid entries to the front. Returns (r, c, v, n).

    Keys are non-negative int32 with I32_MAX pads, so (row, col) packs into
    one int64 and ONE stable sort keeps age order within equal keys (the
    last write wins)."""
    cap = r.shape[-1]
    key = (r.to(torch.int64) << 32) | c.to(torch.int64)
    _, order = torch.sort(key, dim=-1, stable=True)
    sr, sc, sv = r.gather(-1, order), c.gather(-1, order), v.gather(-1, order)
    keep, out_v = _dedup_combine(sr, sc, sv, combiner)
    return _compact(keep, sr, sc, out_v, cap)


def _run_meta(rr, n, n_words: int, block: int, n_hashes: int):
    """Bloom, fences, and first/last row of freshly written runs [S, cap]."""
    last = (n - 1).clamp(min=0).clamp(max=rr.shape[-1] - 1)
    return (bloom_build(rr, n_words, n_hashes), fence_build(rr, block),
            rr[:, 0], rr.gather(1, last[:, None])[:, 0])


def _flush_runs(mem_r, mem_c, mem_v, combiner: str, n_words: int,
                block: int, n_hashes: int):
    """Memtable [S, m] -> one sorted+deduped L0 run per shard, with bloom +
    fence metadata. Cost O(m log m) per shard."""
    rr, cc, vv, n = _sort_dedup(mem_r, mem_c, mem_v, combiner)
    return (rr, cc, vv, n) + _run_meta(rr, n, n_words, block, n_hashes)


def _compact_runs(l0_r, l0_c, l0_v, lvls, combiner: str, use_pallas: bool,
                  out_cap: int, n_words: int, block: int, n_hashes: int):
    """k-way merge the L0 runs [S, K0, m] and the level runs (a tuple of
    [S, cap] triples ordered DEEPEST FIRST = oldest first) into one run of
    ``out_cap`` per shard. kway_merge keeps age order within equal-key
    groups, so one dedup pass applies the combiner exactly."""
    runs = list(lvls)
    runs += [(l0_r[:, k], l0_c[:, k], l0_v[:, k])
             for k in range(l0_r.shape[1])]
    mr, mc, mv = kway_merge(runs, use_pallas=use_pallas)
    keep, out_v = _dedup_combine(mr, mc, mv, combiner)
    rr, cc, vv, n = _compact(keep, mr, mc, out_v, out_cap)
    return (rr, cc, vv, n) + _run_meta(rr, n, n_words, block, n_hashes)


# ----------------------------------------------------------- fused read path
def _bracket(rows, f_rank, q, block: int, right: bool):
    """Exact rank of ``q`` in each run ``rows[K, cap]`` from its fence rank
    ``f_rank[K, Q]``: only the one fence block (+1 entry of spill) is
    searched. Returns int64 [K, Q]."""
    n_k, cap = rows.shape
    w = block + 1
    base = ((f_rank.to(torch.int64) - 1).clamp(min=0) * block).clamp(
        0, cap - w)
    idx = base[..., None] + torch.arange(w, device=rows.device)
    win = rows.gather(1, idx.reshape(n_k, -1)).reshape(idx.shape)
    qq = q.reshape(1, -1, 1).expand(n_k, -1, 1).contiguous()
    pos = torch.searchsorted(win, qq, right=right)
    return base + pos[..., 0]


def _probe_stack(rows, cols, vals, fences, q, max_return: int, block: int,
                 use_pallas: bool):
    """Fence-bracketed rank search of ``q`` against K stacked runs.
    rows/cols/vals [K, cap], fences [K, nb], q [Q]. Returns
    (cols[K, Q, R], vals[K, Q, R], ok[K, Q, R], counts[K, Q]).

    Under ``use_pallas`` the fence rank search is the batched rank kernel
    (one launch for both sides and all K fence rows)."""
    n_k, cap = rows.shape
    if use_pallas:
        fl, fr = sorted_search_batched(fences, q, "both")
    else:
        qq = q.reshape(1, -1).expand(n_k, -1).contiguous()
        fl = torch.searchsorted(fences, qq, side="left")
        fr = torch.searchsorted(fences, qq, side="right")
    start = _bracket(rows, fl, q, block, right=False)
    end = _bracket(rows, fr, q, block, right=True)
    idx = start[..., None] + torch.arange(max_return, device=rows.device)
    idxc = idx.clamp(0, cap - 1).reshape(n_k, -1)
    c_o = cols.gather(1, idxc).reshape(idx.shape)
    v_o = vals.gather(1, idxc).reshape(idx.shape)
    return c_o, v_o, idx < end[..., None], end - start


def _mem_window(mem_r, mem_c, mem_v, q, max_return: int):
    """Candidates of the sorted memtable tail for each query (no fences):
    (cols[Q, R], vals[Q, R], ok[Q, R], counts[Q])."""
    start = torch.searchsorted(mem_r, q, side="left")
    end = torch.searchsorted(mem_r, q, side="right")
    idx = start[:, None] + torch.arange(max_return, device=q.device)
    idxc = idx.clamp(0, mem_r.shape[0] - 1)
    return mem_c[idxc], mem_v[idxc], idx < end[:, None], end - start


def _in_filter(cols, filt):
    """Sorted membership of ``cols`` in ``filt`` (padded with I32_MAX, which
    never equals a valid col)."""
    pos = torch.searchsorted(filt, cols.contiguous()).clamp(
        0, filt.shape[0] - 1)
    return filt[pos] == cols


def _fused_query(q, levels, level_blocks, level_hashes, l0, b0: int, h0: int,
                 mem, mem_mode: str, filt, combiner: str, max_return: int,
                 pack: bool, use_pallas: bool):
    """One query tile against one shard: the resident leveled runs
    (deepest first), the used L0 slots and the memtable tail are searched
    and combined by (col, age) on the device.

    Ages: levels deepest→shallowest get 1..L, L0 slots L+1..L+K0, the
    memtable L+K0+1 (newest). Every run is probed and bloom-masked: a query
    the filter rules out is absent from the run (no false negatives), so
    masking gives what skipping a missed run would. Under ``pack`` the
    (col, age) pair packs into one int32 key, unique per query row, merged
    by ``merge_combine_rows`` (the row-merge kernel under ``use_pallas``)
    while the candidate width stays <= 256; wider rows and unpackable
    geometry fall back to a sort.

    Returns (cols[Q, W], vals[Q, W], keep[Q, W], cnt_max, hits[L+K0]) with
    W = n_runs * max_return; ``cnt_max`` > max_return tells the host to
    re-dispatch wider (batch-scanner semantics), ``hits`` holds the per-run
    bloom verdicts of the tile."""
    n_q = q.shape[0]
    dev = q.device
    seg_cols, seg_vals, seg_ok, seg_age, cnts, hits = [], [], [], [], [], []
    n_levels = len(levels)
    for i, (rows, cols, vals, fence, bloom) in enumerate(levels):
        hit = bloom_maybe_contains(bloom, q, level_hashes[i])
        c_o, v_o, ok, cnt = _probe_stack(rows[None], cols[None], vals[None],
                                         fence[None], q, max_return,
                                         level_blocks[i], use_pallas)
        seg_cols.append(c_o[0])
        seg_vals.append(v_o[0])
        seg_ok.append(ok[0] & hit[:, None])
        seg_age.append(i + 1)
        cnts.append(cnt[0])
        hits.append(hit.any())
    l0_rows, l0_cols, l0_vals, l0_fence, l0_bloom = l0
    k0 = l0_rows.shape[0]
    if k0:  # the whole used L0 stack in one probe
        l0_hit = bloom_maybe_contains_batch(l0_bloom, q, h0)  # [K0, Q]
        c_o, v_o, ok, cnt = _probe_stack(l0_rows, l0_cols, l0_vals, l0_fence,
                                         q, max_return, b0, use_pallas)
        for k in range(k0):
            seg_cols.append(c_o[k])
            seg_vals.append(v_o[k])
            seg_ok.append(ok[k] & l0_hit[k][:, None])
            seg_age.append(n_levels + 1 + k)
            cnts.append(cnt[k])
        hits.extend(l0_hit.any(dim=1).unbind(0))
    if mem_mode != "none":
        mem_r, mem_c, mem_v = mem
        if mem_mode == "raw":
            mem_r, mem_c, mem_v, _ = _sort_dedup(mem_r, mem_c, mem_v,
                                                 combiner)
        c_o, v_o, ok, cnt = _mem_window(mem_r, mem_c, mem_v, q, max_return)
        seg_cols.append(c_o)
        seg_vals.append(v_o)
        seg_ok.append(ok)
        seg_age.append(n_levels + k0 + 1)
        cnts.append(cnt)
    cols_all = torch.cat(seg_cols, dim=1)                         # [Q, W]
    vals_all = torch.cat(seg_vals, dim=1)
    ok_all = torch.cat(seg_ok, dim=1)
    if filt is not None:  # residual column filter, on the device
        ok_all = ok_all & _in_filter(cols_all, filt)
    ages = torch.tensor(seg_age, dtype=torch.int32, device=dev
                        ).repeat_interleave(max_return)[None].expand(n_q, -1)
    if pack:
        shift = (len(seg_age) + 1).bit_length()  # ages fit below shift
        key = torch.where(ok_all, (cols_all << shift) + ages, I32_MAX)
        if cols_all.shape[1] <= 256:
            key_s, val_s = merge_combine_rows(key, vals_all,
                                              use_pallas=use_pallas)
        else:  # widen retries blow the width up: sort instead
            key_s, order = torch.sort(key, dim=1, stable=True)
            val_s = vals_all.gather(1, order)
        col_s = torch.where(key_s == I32_MAX, I32_MAX, key_s >> shift)
    else:
        col_m = torch.where(ok_all, cols_all, I32_MAX)
        key = (col_m.to(torch.int64) << 32) | ages.to(torch.int64)
        _, order = torch.sort(key, dim=1, stable=True)
        col_s, val_s = col_m.gather(1, order), vals_all.gather(1, order)
    keep, out_v = _dedup_combine(col_s, torch.zeros_like(col_s), val_s,
                                 combiner)
    cnt_max = torch.stack([c.max() for c in cnts]).max()
    hits_vec = (torch.stack(hits) if hits
                else torch.zeros(0, dtype=torch.bool, device=dev))
    return (col_s, torch.where(keep, out_v, torch.zeros_like(out_v)), keep,
            cnt_max, hits_vec)


def _fused_scan(lohi, levels, level_blocks, l0, b0: int, mem, mem_mode: str,
                filt, combiner: str, width: int, id_capacity: int,
                use_pallas: bool):
    """One ``[lo, hi)`` row-range scan of one shard: both endpoints are
    fence-bracketed in every resident run (``side='left'``, ``hi``
    exclusive), each run contributes its window ``[start, end)`` of static
    ``width``, and the candidates are merged-deduped by (row, col, age) on
    the device. Under ``use_pallas`` the fence ranks are the batched rank
    kernel (the L0 stack in one launch, each level as a 1-row batch).

    Sort strategy by key geometry (``kbits`` = id bits, ``abits`` = age
    bits): ``2*kbits + abits <= 30`` packs (row, col, age) into ONE int32
    key; ``kbits + abits <= 31`` packs (col, age) into one int32 and two
    stable sorts give the lexicographic order; else the same two stable
    sorts run on an int64 (col, age) key.

    Returns (rows[W], cols[W], vals[W], keep[W], cnt_max) with
    W = n_runs * width; kept entries are sorted lex by (row, col)."""
    dev = lohi.device
    iota = torch.arange(width, device=dev)
    seg_r, seg_c, seg_v, seg_ok, seg_age, cnts = [], [], [], [], [], []

    def window(rows, cols, vals, start, end, age):
        # rows [K, cap], start/end [K] -> K windows of ``width``
        idx = start[:, None] + iota
        idxc = idx.clamp(0, rows.shape[1] - 1)
        for k in range(rows.shape[0]):
            seg_r.append(rows[k][idxc[k]])
            seg_c.append(cols[k][idxc[k]])
            seg_v.append(vals[k][idxc[k]])
            seg_ok.append(idx[k] < end[k])
            seg_age.append(age + k)
        cnts.append((end - start).max())

    n_levels = len(levels)
    for i, (rows, cols, vals, fence, _bloom) in enumerate(levels):
        if use_pallas:
            flo, fhi = sorted_search_endpoints(fence[None], lohi)
            fr = torch.stack([flo, fhi], dim=1)                   # [1, 2]
        else:
            fr = torch.searchsorted(fence, lohi, side="left")[None]
        se = _bracket(rows[None], fr, lohi, level_blocks[i], right=False)
        window(rows[None], cols[None], vals[None], se[:, 0], se[:, 1], i + 1)
    l0_rows, l0_cols, l0_vals, l0_fence, _l0_bloom = l0
    k0 = l0_rows.shape[0]
    if k0:
        if use_pallas:
            flo0, fhi0 = sorted_search_endpoints(l0_fence, lohi)
            fr0 = torch.stack([flo0, fhi0], dim=1)               # [K0, 2]
        else:
            fr0 = torch.searchsorted(
                l0_fence, lohi[None].expand(k0, 2).contiguous(), side="left")
        se = _bracket(l0_rows, fr0, lohi, b0, right=False)
        window(l0_rows, l0_cols, l0_vals, se[:, 0], se[:, 1], n_levels + 1)
    if mem_mode != "none":
        mem_r, mem_c, mem_v = mem
        if mem_mode == "raw":
            mem_r, mem_c, mem_v, _ = _sort_dedup(mem_r, mem_c, mem_v,
                                                 combiner)
        se = torch.searchsorted(mem_r, lohi, side="left")
        window(mem_r[None], mem_c[None], mem_v[None], se[:1], se[1:],
               n_levels + k0 + 1)
    rows_all = torch.cat(seg_r)
    cols_all = torch.cat(seg_c)
    vals_all = torch.cat(seg_v)
    ok_all = torch.cat(seg_ok)
    if filt is not None:  # residual column filter, on the device
        ok_all = ok_all & _in_filter(cols_all, filt)
    ages = torch.tensor(seg_age, dtype=torch.int32,
                        device=dev).repeat_interleave(width)
    abits = (len(seg_age) + 1).bit_length()
    kbits = max((id_capacity - 1).bit_length(), 1)
    if 2 * kbits + abits <= 30:
        key = torch.where(ok_all, (rows_all << (kbits + abits))
                          + (cols_all << abits) + ages, I32_MAX)
        key_s, order = torch.sort(key, stable=True)
        val_s = vals_all[order]
        pad = key_s == I32_MAX
        row_s = torch.where(pad, I32_MAX, key_s >> (kbits + abits))
        col_s = torch.where(pad, I32_MAX,
                            (key_s >> abits) & ((1 << kbits) - 1))
    else:
        row_m = torch.where(ok_all, rows_all, I32_MAX)
        if kbits + abits <= 31:
            key2 = torch.where(ok_all, (cols_all << abits) + ages, I32_MAX)
        else:
            key2 = torch.where(ok_all, (cols_all.to(torch.int64) << abits)
                               + ages, I32_MAX)
        k2_s, o1 = torch.sort(key2, stable=True)
        row_s, o2 = torch.sort(row_m[o1], stable=True)
        k2_f = k2_s[o2]
        val_s = vals_all[o1][o2]
        pad = row_s == I32_MAX
        col_s = torch.where(pad, I32_MAX, k2_f >> abits).to(torch.int32)
    keep, out_v = _dedup_combine(row_s, col_s, val_s, combiner)
    cnt_max = torch.stack(cnts).max()
    return (row_s, col_s, torch.where(keep, out_v, torch.zeros_like(out_v)),
            keep, cnt_max)


def _to_host(out):
    """A dispatch's result tensors as host numpy through ONE device-to-host
    copy (one host sync): each is viewed or cast as int32 words, the words
    are packed into one buffer, copied, and split back on the host."""
    if any(x.dtype not in (torch.float32, torch.int32, torch.int64,
                           torch.bool) for x in out):
        raise TypeError(f"unexpected dtypes {[x.dtype for x in out]}")
    words = [x.reshape(-1).view(torch.int32) if x.dtype == torch.float32
             else x.reshape(-1).to(torch.int32) for x in out]
    flat = torch.cat(words).cpu().numpy()
    res, at = [], 0
    for x in out:
        part = flat[at:at + x.numel()].reshape(tuple(x.shape))
        at += x.numel()
        if x.dtype == torch.float32:
            part = part.view(np.float32)
        elif x.dtype == torch.bool:
            part = part.astype(bool)
        res.append(part)
    return tuple(res)


def combine_triples(r: np.ndarray, c: np.ndarray, v: np.ndarray,
                    age: np.ndarray, combiner: str):
    """Host-side cross-run combine: sort candidates by (row, col, age) and
    reduce each key group per the combiner. Each source is already deduped
    (or, for the raw memtable, in append order with a constant age — the
    stable sort keeps append order, so 'last' still wins correctly)."""
    if len(r) == 0:
        z = np.zeros(0, np.int32)
        return z, z.copy(), np.zeros(0, np.float32)
    order = np.lexsort((age, c, r))
    r, c, v = r[order], c[order], v[order]
    new = np.ones(len(r), bool)
    new[1:] = (r[1:] != r[:-1]) | (c[1:] != c[:-1])
    starts = np.flatnonzero(new)
    if combiner == "last":
        ends = np.append(starts[1:], len(r)) - 1
        return r[starts], c[starts], v[ends]
    if combiner == "sum":
        vv = np.add.reduceat(v, starts)
    elif combiner == "min":
        vv = np.minimum.reduceat(v, starts)
    elif combiner == "max":
        vv = np.maximum.reduceat(v, starts)
    else:
        raise ValueError(f"unknown combiner {combiner!r}")
    return r[starts], c[starts], vv.astype(np.float32)


def _prep_mem(mem_host: Optional[Tuple], mem_sorted: bool,
              device: torch.device):
    """Pad an unflushed memtable tail (host numpy arrays) to a pow2 bucket
    on ``device`` and pick its treatment: ``"sorted"`` = host pre-sorted/
    deduped mirror, ``"raw"`` = sort in the dispatch, ``"none"``."""
    mem_n = 0 if mem_host is None else len(mem_host[0])
    if not mem_n:
        return None, "none"
    mb = _bucket(mem_n)
    mr, mc, mv = mem_host
    pr = np.full(mb, I32_MAX, np.int32)
    pc = np.full(mb, I32_MAX, np.int32)
    pv = np.zeros(mb, np.float32)
    pr[:mem_n], pc[:mem_n], pv[:mem_n] = mr, mc, mv
    mem = tuple(torch.as_tensor(x, device=device) for x in (pr, pc, pv))
    return mem, ("sorted" if mem_sorted else "raw")


# counter schema shared with the JAX engine, so stats line up key for key
STAT_KEYS = ("flushes", "major_compactions", "runs_probed", "runs_skipped",
             "fused_dispatches", "fused_widen_retries", "fused_tiles",
             "perrun_dispatches", "scan_dispatches", "scan_widen_retries")


# ------------------------------------------------------------------ engine
class LSMRuns:
    """The leveled run structure for S shards (no memtable — that stays in
    ``ShardedTable`` and is handed to ``flush_memtable``/read methods).

    ``bloom_bits_per_key`` / ``bloom_hashes`` size the per-run filters:
    scalars apply everywhere; sequences give one value per level (last
    entry repeats for deeper levels). L0 runs use the first entry.
    ``device`` holds every run (default ``"cuda"``; construction raises
    without a card unless ``device="cpu"`` is given)."""

    def __init__(self, num_shards: int, capacity_per_shard: int,
                 mem_cap: int, combiner: str, use_pallas: bool = False,
                 l0_slots: int = 4, fanout: int = 4,
                 bloom_bits_per_key: Union[int, Sequence[int]] = BITS_PER_KEY,
                 bloom_hashes: Union[int, Sequence[int]] = NUM_HASHES,
                 id_capacity: int = 1 << 22, name: str = "lsm",
                 device: Union[str, torch.device] = "cuda"):
        if mem_cap < 8:
            raise ValueError("LSM memtable too small to index")
        self.device = resolve_device(device)
        self.S = num_shards
        self.name = name
        self.cap = capacity_per_shard
        self.mem_cap = mem_cap
        self.combiner = combiner
        self.use_pallas = use_pallas
        self.id_capacity = id_capacity  # bounds col ids: fused key packing
        self.K0 = l0_slots
        self.fanout = fanout
        self.level_caps = plan_levels(capacity_per_shard, mem_cap, l0_slots,
                                      fanout)
        n_levels = len(self.level_caps)
        self.bloom_bits = _per_level(bloom_bits_per_key, n_levels)
        self.bloom_hashes = _per_level(bloom_hashes, n_levels)
        bad = [h for h in self.bloom_hashes if not 1 <= h <= MAX_HASHES]
        if bad:
            raise ValueError(
                f"bloom_hashes {bad} outside [1, {MAX_HASHES}]")
        S, m, K0 = num_shards, mem_cap, l0_slots
        self._w0 = num_words(m, self.bloom_bits[0])
        self._h0 = self.bloom_hashes[0]
        self._b0 = fence_block(m)
        nblk0 = -(-m // self._b0)
        self.l0_rows = self._full((S, K0, m), I32_MAX)
        self.l0_cols = self._full((S, K0, m), I32_MAX)
        self.l0_vals = self._full((S, K0, m), 0.0, torch.float32)
        self.l0_bloom = self._full((S, K0, self._w0), 0)
        self.l0_fence = self._full((S, K0, nblk0), I32_MAX)
        self.l0_n = np.zeros((S, K0), np.int64)
        # host-side row ranges per run: skip runs without device roundtrips
        self.l0_min = np.full((S, K0), I32_MAX, np.int64)
        self.l0_max = np.full((S, K0), -1, np.int64)
        # per-SHARD used-slot counts: shards fill (and major-compact) their
        # own L0 independently
        self.l0_used = np.zeros((S,), np.int64)
        self.levels: List[dict] = []
        for i, cap in enumerate(self.level_caps):
            w = num_words(cap, self.bloom_bits[i])
            b = fence_block(cap)
            self.levels.append({
                "cap": cap, "words": w, "block": b,
                "bits": self.bloom_bits[i], "hashes": self.bloom_hashes[i],
                "rows": self._full((S, cap), I32_MAX),
                "cols": self._full((S, cap), I32_MAX),
                "vals": self._full((S, cap), 0.0, torch.float32),
                "bloom": self._full((S, w), 0),
                "fence": self._full((S, -(-cap // b)), I32_MAX),
                "n": np.zeros((S,), np.int64),
                "minr": np.full((S,), I32_MAX, np.int64),
                "maxr": np.full((S,), -1, np.int64),
            })
        # registry counters labeled by table name, reset at construction so
        # a fresh engine reads zeros (two live engines sharing one table
        # name share series, which only test code does)
        self._reg = default_registry()
        self._trace = default_tracer()
        self._ctr = {k: self._reg.counter("lsm_" + k, table=name)
                     for k in STAT_KEYS}
        self._c_shard_flush = [
            self._reg.counter("lsm_shard_flushes", table=name, shard=s)
            for s in range(S)]
        self._c_shard_compact = [
            self._reg.counter("lsm_shard_compactions", table=name, shard=s)
            for s in range(S)]
        self._h_flush = self._reg.histogram("db_op_latency_s", table=name,
                                            op="flush")
        self._h_compact = self._reg.histogram("db_op_latency_s", table=name,
                                              op="major_compaction")
        # retrace telemetry has no meaning in eager PyTorch: the series
        # exist (schema parity with the JAX engine) and stay at zero
        self._c_retrace_q = self._reg.counter("lsm_retraces", table=name,
                                              op="query")
        self._c_retrace_s = self._reg.counter("lsm_retraces", table=name,
                                              op="scan")
        # write-amplification inputs: entries written into runs by flushes
        # and rewritten by compactions (vs db_ingest_entries)
        self._c_flush_entries = self._reg.counter("lsm_flush_entries",
                                                  table=name)
        self._c_compact_entries = self._reg.counter("lsm_compact_entries",
                                                    table=name)
        for inst in ([self._h_flush, self._h_compact]
                     + list(self._ctr.values())
                     + [self._c_retrace_q, self._c_retrace_s,
                        self._c_flush_entries, self._c_compact_entries]
                     + self._c_shard_flush + self._c_shard_compact):
            inst.reset()
        # per-shard views handed to the fused reads; invalidated whenever a
        # flush or compaction changes residency
        self._view_cache: dict = {}

    def _full(self, shape, value, dtype=torch.int32):
        return torch.full(shape, value, dtype=dtype, device=self.device)

    @property
    def stats(self) -> dict:
        """Dict view of the registry counters (a fresh dict per access)."""
        return {k: int(c.value) for k, c in self._ctr.items()}

    def warmup(self, mem_r, mem_c, mem_v) -> None:
        """Run the flush and every compaction depth on the current state,
        discarding the results (no state mutates): builds the kernels and
        warms the allocator before a timed window."""
        _flush_runs(mem_r, mem_c, mem_v, self.combiner, self._w0, self._b0,
                    self._h0)
        for d, lv in enumerate(self.levels):
            _compact_runs(self.l0_rows, self.l0_cols, self.l0_vals,
                          self._level_runs(d), self.combiner,
                          self.use_pallas, lv["cap"], lv["words"],
                          lv["block"], lv["hashes"])
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _level_runs(self, d: int):
        """Levels 0..d as merge inputs, deepest (oldest) first."""
        return tuple((self.levels[i]["rows"], self.levels[i]["cols"],
                      self.levels[i]["vals"]) for i in range(d, -1, -1))

    # ----------------------------------------------------------- write path
    def flush_memtable(self, mem_r, mem_c, mem_v) -> None:
        """Minor compaction: memtable [S, m] -> one L0 run per shard,
        O(m log m). Shards whose OWN L0 is full (and that have data to
        flush) are major-compacted first. May raise OverflowError."""
        t0 = perf_counter()
        with self._trace.span("flush", table=self.name):
            self._flush_memtable(mem_r, mem_c, mem_v)
        self._h_flush.observe(perf_counter() - t0)

    def _flush_memtable(self, mem_r, mem_c, mem_v) -> None:
        rr, cc, vv, n, bb, ff, mn, mx = _flush_runs(
            mem_r, mem_c, mem_v, self.combiner, self._w0, self._b0, self._h0)
        n_host = n.cpu().numpy().astype(np.int64)
        landing = n_host > 0          # shards receiving a non-empty run
        full = (self.l0_used >= self.K0) & landing
        if full.any():
            self.major_compact(mask=full)
        slot = self.l0_used.copy()    # per-shard next free slot (K0 = drop)
        self._write_slot(rr, cc, vv, bb, ff, slot)
        sidx = np.flatnonzero(landing)
        self.l0_n[sidx, slot[sidx]] = n_host[sidx]
        self.l0_min[sidx, slot[sidx]] = mn.cpu().numpy().astype(np.int64)[sidx]
        self.l0_max[sidx, slot[sidx]] = mx.cpu().numpy().astype(np.int64)[sidx]
        self._view_cache.clear()
        self.l0_used = self.l0_used + landing.astype(np.int64)
        self._ctr["flushes"].inc()
        self._c_flush_entries.inc(int(n_host[sidx].sum()))
        for s in sidx:
            self._c_shard_flush[s].inc()
        full = self.l0_used >= self.K0
        if full.any():
            self.major_compact(mask=full)

    def _write_slot(self, rr, cc, vv, bb, ff, slot: np.ndarray) -> None:
        """Write each shard's flushed run into ITS next free L0 slot, in
        place; a shard whose slot equals K0 (full L0, nothing incoming)
        drops the write."""
        sidx = np.flatnonzero(slot < self.K0)
        if not len(sidx):
            return
        s_t = torch.as_tensor(sidx, device=self.device)
        k_t = torch.as_tensor(slot[sidx], device=self.device)
        self.l0_rows[s_t, k_t] = rr[s_t]
        self.l0_cols[s_t, k_t] = cc[s_t]
        self.l0_vals[s_t, k_t] = vv[s_t]
        self.l0_bloom[s_t, k_t] = bb[s_t]
        self.l0_fence[s_t, k_t] = ff[s_t]

    def _pick_depth(self, mask: np.ndarray) -> int:
        """Smallest level whose capacity bounds the (pre-dedup) merge size
        for every COMPACTING shard; the deepest level is the fallback."""
        bound = self.l0_n.sum(axis=1)  # [S]
        for d, lv in enumerate(self.levels):
            bound = bound + lv["n"]
            if int(bound[mask].max()) <= lv["cap"]:
                return d
        return len(self.levels) - 1

    def major_compact(self, mask: Optional[np.ndarray] = None) -> None:
        """Size-triggered major compaction: k-way merge the L0 runs and
        levels 1..d into level d (the merge-path rank kernel under
        ``use_pallas``).

        ``mask`` selects WHICH shards compact (default: every shard with
        L0 data). The merge runs over all S shards at once; unmasked
        shards' merged output is discarded — their runs, counts, and L0
        slots are untouched."""
        if mask is None:
            mask = self.l0_used > 0
        mask = np.asarray(mask, bool)
        if not mask.any():
            return
        t0 = perf_counter()
        with self._trace.span("major_compact", table=self.name,
                              shards=int(mask.sum())):
            self._major_compact(mask)
        self._h_compact.observe(perf_counter() - t0)

    def _major_compact(self, mask: np.ndarray) -> None:
        d = self._pick_depth(mask)
        target = self.levels[d]
        rr, cc, vv, n, bb, ff, mn, mx = _compact_runs(
            self.l0_rows, self.l0_cols, self.l0_vals, self._level_runs(d),
            self.combiner, self.use_pallas, target["cap"], target["words"],
            target["block"], target["hashes"])
        n_host = n.cpu().numpy().astype(np.int64)
        if d == len(self.levels) - 1 and int(n_host[mask].max()) > self.cap:
            raise OverflowError(
                f"LSM shard overflow: {int(n_host[mask].max())} > {self.cap}")
        sidx = np.flatnonzero(mask)
        s_t = torch.as_tensor(sidx, device=self.device)
        for key, new in (("rows", rr), ("cols", cc), ("vals", vv),
                         ("bloom", bb), ("fence", ff)):
            target[key][s_t] = new[s_t]
        target["n"] = np.where(mask, n_host, target["n"]).astype(np.int64)
        target["minr"] = np.where(mask, mn.cpu().numpy(),
                                  target["minr"]).astype(np.int64)
        target["maxr"] = np.where(mask, mx.cpu().numpy(),
                                  target["maxr"]).astype(np.int64)
        # clear L0 + the shallower levels for the compacted shards ONLY
        self._clear(sidx, range(d))
        self._view_cache.clear()
        self._ctr["major_compactions"].inc()
        self._c_compact_entries.inc(int(n_host[mask].sum()))
        for s in sidx:
            self._c_shard_compact[s].inc()

    def _clear(self, sidx: np.ndarray, level_ids) -> None:
        """Empty the L0 slots and the given levels of shards ``sidx``."""
        s_t = torch.as_tensor(sidx, device=self.device)
        self.l0_rows[s_t] = I32_MAX
        self.l0_cols[s_t] = I32_MAX
        self.l0_vals[s_t] = 0.0
        self.l0_bloom[s_t] = 0
        self.l0_fence[s_t] = I32_MAX
        self.l0_n[sidx] = 0
        self.l0_min[sidx] = I32_MAX
        self.l0_max[sidx] = -1
        self.l0_used[sidx] = 0
        for i in level_ids:
            lv = self.levels[i]
            lv["rows"][s_t] = I32_MAX
            lv["cols"][s_t] = I32_MAX
            lv["vals"][s_t] = 0.0
            lv["bloom"][s_t] = 0
            lv["fence"][s_t] = I32_MAX
            lv["n"][sidx] = 0
            lv["minr"][sidx] = I32_MAX
            lv["maxr"][sidx] = -1

    # ------------------------------------------------------------ read path
    def resident_runs(self, s: int) -> int:
        """How many non-empty runs shard ``s`` holds (levels + L0)."""
        n = sum(1 for lv in self.levels if lv["n"][s])
        n += sum(1 for k in range(int(self.l0_used[s])) if self.l0_n[s, k])
        return n

    def clear_shard(self, s: int) -> None:
        """Drop EVERY resident run of one shard — L0 slots and all levels,
        including the deepest (tablet migration re-inserts the shard's
        combined triples under a new map after this)."""
        self._clear(np.asarray([s]), range(len(self.levels)))
        self._view_cache.clear()

    def fence_keys(self, s: int, lo: int, hi: int) -> np.ndarray:
        """Sorted host view of shard ``s``'s resident fence keys inside
        ``[lo, hi)`` (fences sample each sorted run at a fixed stride)."""
        keys = []
        for lv in self.levels:
            if lv["n"][s] and lv["minr"][s] < hi and lv["maxr"][s] >= lo:
                keys.append(lv["fence"][s].cpu().numpy())
        for k in range(int(self.l0_used[s])):
            if (self.l0_n[s, k] and self.l0_min[s, k] < hi
                    and self.l0_max[s, k] >= lo):
                keys.append(self.l0_fence[s, k].cpu().numpy())
        if not keys:
            return np.zeros(0, np.int64)
        cat = np.concatenate(keys).astype(np.int64)
        cat = cat[(cat >= lo) & (cat < hi) & (cat != I32_MAX)]
        cat.sort()
        return cat

    def fence_median(self, s: int, lo: int, hi: int) -> int:
        """Median resident fence key of shard ``s`` within ``[lo, hi)`` —
        a split point strictly interior to ``(lo, hi)``; the range midpoint
        when no fence lands inside."""
        ks = self.fence_keys(s, lo, hi)
        med = int(np.median(ks)) if len(ks) else (int(lo) + int(hi)) // 2
        return int(min(max(med, int(lo) + 1), int(hi) - 1))

    # --------------------------------------------------------- health view
    def refresh_health_gauges(self, bloom_probes: int = 0) -> None:
        """Derive the engine health gauges from host-side state: resident
        runs + compaction debt per shard, read and write amplification per
        table; ``bloom_probes > 0`` also measures the observed bloom fp
        rate with keys provably outside each run's row range."""
        reg = self._reg
        for s in range(self.S):
            reg.gauge("lsm_resident_runs", table=self.name, shard=s).set(
                self.resident_runs(s))
            u = int(self.l0_used[s])
            reg.gauge("lsm_compaction_debt_entries", table=self.name,
                      shard=s).set(int(self.l0_n[s, :u].sum()))
        c = self._ctr
        reads = int(c["fused_dispatches"].value
                    + c["perrun_dispatches"].value)
        probed = int(c["runs_probed"].value)
        reg.gauge("lsm_read_amplification", table=self.name).set(
            probed / reads if reads else 0.0)
        ingested = sum(int(x.value) for x in
                       reg.series("db_ingest_entries", table=self.name))
        written = int(self._c_flush_entries.value
                      + self._c_compact_entries.value)
        reg.gauge("lsm_write_amplification", table=self.name).set(
            written / ingested if ingested else 0.0)
        if bloom_probes:
            obs_fp, theo_fp = self._bloom_fp_probe(bloom_probes)
            reg.gauge("lsm_bloom_fp_observed", table=self.name).set(obs_fp)
            reg.gauge("lsm_bloom_fp_theoretical",
                      table=self.name).set(theo_fp)

    def _bloom_fp_probe(self, probes: int):
        """(observed, theoretical) bloom fp rate over the resident runs."""
        rng = np.random.default_rng(0xB100F)
        tot_probes = tot_fp = 0
        theo_w = 0.0
        for s in range(self.S):
            runs = [(lv["bloom"][s], lv["hashes"], lv["words"],
                     int(lv["n"][s]), int(lv["minr"][s]), int(lv["maxr"][s]))
                    for lv in self.levels if lv["n"][s]]
            runs += [(self.l0_bloom[s, k], self._h0, self._w0,
                      int(self.l0_n[s, k]), int(self.l0_min[s, k]),
                      int(self.l0_max[s, k]))
                     for k in range(int(self.l0_used[s]))
                     if self.l0_n[s, k]]
            for words, n_hashes, n_words, n_keys, minr, maxr in runs:
                cand = rng.integers(0, self.id_capacity, 4 * probes)
                cand = cand[(cand < minr) | (cand > maxr)][:probes]
                if len(cand) < probes:
                    continue  # run spans ~the whole id space: no negatives
                hits = bloom_maybe_contains(
                    words, torch.as_tensor(cand.astype(np.int32),
                                           device=self.device),
                    n_hashes=n_hashes)
                tot_fp += int(hits.sum())
                tot_probes += probes
                theo_w += probes * theoretical_fp_rate(n_keys, n_words,
                                                       n_hashes)
        if not tot_probes:
            return 0.0, 0.0
        return tot_fp / tot_probes, theo_w / tot_probes

    def _iter_runs_oldest_first(self, s: int):
        """Yield (rows, cols, vals, n) per resident run of shard ``s``,
        oldest (deepest level) to newest (latest L0 slot)."""
        for i in range(len(self.levels) - 1, -1, -1):
            lv = self.levels[i]
            if lv["n"][s]:
                yield lv["rows"][s], lv["cols"][s], lv["vals"][s], \
                    int(lv["n"][s])
        for k in range(int(self.l0_used[s])):
            if self.l0_n[s, k]:
                yield (self.l0_rows[s, k], self.l0_cols[s, k],
                       self.l0_vals[s, k], int(self.l0_n[s, k]))

    def _fused_views(self, s: int):
        """Per-shard views for the fused reads: the RESIDENT leveled runs
        (deepest first, with their fence-block/hash meta) plus the L0 stack
        sliced to the used slots. Cached until residency changes."""
        view = self._view_cache.get(s)
        if view is None:
            live = [i for i in range(len(self.levels) - 1, -1, -1)
                    if self.levels[i]["n"][s]]
            levels = tuple(
                (self.levels[i]["rows"][s], self.levels[i]["cols"][s],
                 self.levels[i]["vals"][s], self.levels[i]["fence"][s],
                 self.levels[i]["bloom"][s])
                for i in live)
            blocks = tuple(self.levels[i]["block"] for i in live)
            hashes = tuple(self.levels[i]["hashes"] for i in live)
            u = int(self.l0_used[s])
            l0 = (self.l0_rows[s, :u], self.l0_cols[s, :u],
                  self.l0_vals[s, :u], self.l0_fence[s, :u],
                  self.l0_bloom[s, :u])
            view = (levels, blocks, hashes, tuple(live), l0)
            self._view_cache[s] = view
        return view

    def _filter_dev(self, col_filter):
        """Sorted unique device copy of a column id set, padded with
        I32_MAX to a pow2 bucket; None when the set is empty."""
        cf = np.unique(np.asarray(col_filter, np.int32))
        if len(cf) == 0:
            return None
        cf_pad = np.full(_bucket(len(cf)), I32_MAX, np.int32)
        cf_pad[:len(cf)] = cf
        return torch.as_tensor(cf_pad, device=self.device)

    def query_shard_fused(self, s: int, q: np.ndarray,
                          mem_host: Optional[Tuple] = None,
                          max_return: int = 256,
                          mem_sorted: bool = False,
                          q_tile: Optional[int] = None,
                          col_filter: Optional[np.ndarray] = None):
        """Point row queries for one shard, fused: each tile searches the
        resident leveled runs, the used L0 slots, and the memtable tail and
        age-order combines on the device, with one host sync per tile.
        ``q`` must be sorted unique int32; ``mem_host`` is the shard's
        unflushed tail as numpy (rows, cols, vals) — pass ``mem_sorted``
        if it is already (row, col)-sorted and combiner-deduped. NO flush.

        With ``q_tile`` set, tiny batches (n_q <= 8) use the small bucket
        and larger ones split into ceil(n_q / tile) tiles of the tile
        size, each independently widen-retryable. ``col_filter`` (an int32
        id set) masks columns outside the set on the device."""
        n_q = len(q)
        filt_dev = None
        if col_filter is not None:
            filt_dev = self._filter_dev(col_filter)
            if filt_dev is None:  # empty filter: nothing can match
                z = np.zeros(0, np.int32)
                return z, z.copy(), np.zeros(0, np.float32)
        mem, mem_mode = _prep_mem(mem_host, mem_sorted, self.device)
        levels, blocks, hashes, live, l0 = self._fused_views(s)
        n_runs = len(levels) + int(l0[0].shape[0]) + (mem_mode != "none")
        # single-int32 (col, age) key packing needs col * age_pad headroom
        pack = self.id_capacity <= (1 << 24) and n_runs + 2 < 64
        # small initial per-run return width: cnt_max triggers the widen
        # retry when a row has more entries in some run
        r_ret = min(4, _bucket(max_return))
        tile = (_bucket(n_q) if q_tile is None or n_q <= 8
                else _bucket(q_tile))
        n_tiles = max(1, -(-n_q // tile))
        if n_tiles > 1:
            self._ctr["fused_tiles"].inc(n_tiles)

        def dispatch(q_dev, width):
            out = _fused_query(q_dev, levels, blocks, hashes, l0, self._b0,
                               self._h0, mem, mem_mode, filt_dev,
                               self.combiner, width, pack, self.use_pallas)
            return _to_host(out)

        tr = self._trace
        out_r, out_c, out_v = [], [], []
        hit_any = None
        with tr.span("query.fused", table=self.name, shard=s, n_q=n_q,
                     tiles=n_tiles):
            for t in range(n_tiles):
                q_blk = q[t * tile:(t + 1) * tile]
                nb = len(q_blk)
                q_pad = np.full(tile, -1, np.int32)  # -1: matches nothing
                q_pad[:nb] = q_blk
                q_dev = torch.as_tensor(q_pad, device=self.device)
                self._ctr["fused_dispatches"].inc()
                with tr.span("dispatch", tile=t):
                    cols_s, vals_s, keep, cnt_max, hits = dispatch(q_dev,
                                                                   r_ret)
                if int(cnt_max) > r_ret:  # widen + retry (scanner)
                    self._ctr["fused_widen_retries"].inc()
                    self._ctr["fused_dispatches"].inc()
                    with tr.span("widen_retry", width=int(cnt_max)):
                        cols_s, vals_s, keep, cnt_max, hits = dispatch(
                            q_dev, _bucket(int(cnt_max)))
                qi, ki = np.nonzero(keep[:nb])
                out_r.append(q_blk[qi])
                out_c.append(cols_s[:nb][qi, ki])
                out_v.append(vals_s[:nb][qi, ki])
                hit_any = hits if hit_any is None else (hit_any | hits)
        # a run counts as probed if ANY tile's query block hit its bloom;
        # hits = [resident levels deepest-first, used slots]
        probed, skipped = self._ctr["runs_probed"], self._ctr["runs_skipped"]
        for i in range(len(live)):
            (probed if hit_any[i] else skipped).inc()
        for k in range(int(self.l0_used[s])):
            if self.l0_n[s, k]:
                (probed if hit_any[len(live) + k] else skipped).inc()
        return (np.concatenate(out_r).astype(np.int32),
                np.concatenate(out_c).astype(np.int32),
                np.concatenate(out_v).astype(np.float32))

    def scan_shard_fused(self, s: int, lo: int, hi: int,
                         mem_host: Optional[Tuple] = None,
                         width: int = 64, mem_sorted: bool = False,
                         col_filter: Optional[np.ndarray] = None):
        """Row-range scan ``[lo, hi)`` of one shard in ONE fused pass + ONE
        host sync: every resident run and the memtable tail is
        fence-bracketed at both endpoints and the candidate windows are
        merged-deduped on the device. ``width`` is the initial per-run
        window; a run whose slice overflows it triggers ONE widen retry at
        the next pow2 >= the true max slice. Returns combined
        (rows, cols, vals) sorted lex by (row, col). NO flush happens."""
        lo, hi = int(lo), int(hi)
        empty = (np.zeros(0, np.int32), np.zeros(0, np.int32),
                 np.zeros(0, np.float32))
        filt_dev = None
        if col_filter is not None:
            filt_dev = self._filter_dev(col_filter)
            if filt_dev is None:  # empty filter: nothing can match
                return empty
        if hi <= lo:
            return empty
        mem, mem_mode = _prep_mem(mem_host, mem_sorted, self.device)
        # host run-range metadata: skip the dispatch when no resident run
        # (and no memtable tail) intersects [lo, hi)
        inter = mem_mode != "none" or any(
            lv["n"][s] and lv["minr"][s] < hi and lv["maxr"][s] >= lo
            for lv in self.levels) or any(
            self.l0_n[s, k] and self.l0_min[s, k] < hi
            and self.l0_max[s, k] >= lo
            for k in range(int(self.l0_used[s])))
        if not inter:
            return empty
        levels, blocks, hashes, live, l0 = self._fused_views(s)
        lohi = torch.as_tensor(np.asarray([lo, hi], np.int32),
                               device=self.device)

        def dispatch(w):
            out = _fused_scan(lohi, levels, blocks, l0, self._b0, mem,
                              mem_mode, filt_dev, self.combiner, w,
                              self.id_capacity, self.use_pallas)
            return _to_host(out)

        w = _bucket(width, lo=16)
        tr = self._trace
        self._ctr["scan_dispatches"].inc()
        with tr.span("scan.fused", table=self.name, shard=s, lo=lo, hi=hi):
            with tr.span("dispatch"):
                rows_s, cols_s, vals_s, keep, cnt_max = dispatch(w)
            if int(cnt_max) > w:  # widen + retry (batch-scanner semantics)
                self._ctr["scan_widen_retries"].inc()
                self._ctr["scan_dispatches"].inc()
                with tr.span("widen_retry", width=int(cnt_max)):
                    rows_s, cols_s, vals_s, keep, _ = dispatch(
                        _bucket(int(cnt_max)))
        ki = np.flatnonzero(keep)
        return (rows_s[ki].astype(np.int32), cols_s[ki].astype(np.int32),
                vals_s[ki].astype(np.float32))

    def scan_shard(self, s: int, mem_host: Optional[Tuple] = None):
        """All (row, col, val) of one shard, combined across runs + the
        memtable tail (host numpy arrays), sorted lex by (row, col). NO
        flush happens."""
        cand = []
        age = 0
        for rows, cols, vals, n in self._iter_runs_oldest_first(s):
            age += 1
            cand.append((rows[:n].cpu().numpy(), cols[:n].cpu().numpy(),
                         vals[:n].cpu().numpy(), np.full(n, age, np.int32)))
        if mem_host is not None and len(mem_host[0]):
            mr, mc, mv = mem_host
            cand.append((mr, mc, mv, np.full(len(mr), age + 1, np.int32)))
        if not cand:
            z = np.zeros(0, np.int32)
            return z, z.copy(), np.zeros(0, np.float32)
        r = np.concatenate([x[0] for x in cand]).astype(np.int32)
        c = np.concatenate([x[1] for x in cand]).astype(np.int32)
        v = np.concatenate([x[2] for x in cand]).astype(np.float32)
        a = np.concatenate([x[3] for x in cand])
        return combine_triples(r, c, v, a, self.combiner)

    # --------------------------------------------------------- persistence
    def state_arrays(self) -> dict:
        """Flat name -> np.ndarray map of all run state, in the JAX
        engine's format (its ``load_state`` accepts it as is)."""
        def host(t):  # a copy, also for a CPU tensor (runs update in place)
            return t.to("cpu", copy=True).numpy()

        out = {
            "l0_rows": host(self.l0_rows),
            "l0_cols": host(self.l0_cols),
            "l0_vals": host(self.l0_vals),
            "l0_n": self.l0_n.copy(),
            "l0_used": self.l0_used.copy(),
        }
        for i, lv in enumerate(self.levels):
            out[f"lvl{i}_rows"] = host(lv["rows"])
            out[f"lvl{i}_cols"] = host(lv["cols"])
            out[f"lvl{i}_vals"] = host(lv["vals"])
            out[f"lvl{i}_n"] = lv["n"].copy()
        return out

    def load_state(self, arrs: dict) -> None:
        """Restore from ``state_arrays`` output (either package's); blooms
        and fences are derived data and get rebuilt."""
        self._view_cache.clear()
        dev = self.device

        def tens(x, dtype):  # always a copy: never alias the caller's
            return torch.tensor(np.asarray(x), dtype=dtype, device=dev)

        l0_rows_np = np.asarray(arrs["l0_rows"])
        self.l0_rows = tens(l0_rows_np, torch.int32)
        self.l0_cols = tens(arrs["l0_cols"], torch.int32)
        self.l0_vals = tens(arrs["l0_vals"], torch.float32)
        self.l0_n = np.asarray(arrs["l0_n"]).astype(np.int64)
        lu = np.asarray(arrs["l0_used"])
        # one scalar (lockstep slot counter) in old snapshots: broadcast it
        self.l0_used = (np.full((self.S,), int(lu), np.int64)
                        if lu.ndim == 0 else lu.astype(np.int64))
        self.l0_bloom = bloom_build(self.l0_rows, self._w0, self._h0)
        self.l0_fence = fence_build(self.l0_rows, self._b0)
        self.l0_min = l0_rows_np[:, :, 0].astype(np.int64)
        last = np.maximum(self.l0_n - 1, 0)
        self.l0_max = np.take_along_axis(
            l0_rows_np, last[:, :, None].astype(np.int64), axis=2
        )[:, :, 0].astype(np.int64)
        for i, lv in enumerate(self.levels):
            rows_np = np.asarray(arrs[f"lvl{i}_rows"])
            lv["rows"] = tens(rows_np, torch.int32)
            lv["cols"] = tens(arrs[f"lvl{i}_cols"], torch.int32)
            lv["vals"] = tens(arrs[f"lvl{i}_vals"], torch.float32)
            lv["n"] = np.asarray(arrs[f"lvl{i}_n"]).astype(np.int64)
            lv["bloom"] = bloom_build(lv["rows"], lv["words"], lv["hashes"])
            lv["fence"] = fence_build(lv["rows"], lv["block"])
            lv["minr"] = rows_np[:, 0].astype(np.int64)
            last = np.maximum(lv["n"] - 1, 0).astype(np.int64)
            lv["maxr"] = rows_np[np.arange(self.S), last].astype(np.int64)


def load_jax_state(runs: LSMRuns, arrays: dict) -> None:
    """Load the dict of numpy arrays that the JAX engine's
    ``LSMRuns.state_arrays()`` returns into the port's ``runs``. The two
    engines must share a geometry (shards, L0 slots, memtable and level
    capacities); blooms and fences are rebuilt."""
    want = {"l0_rows": (runs.S, runs.K0, runs.mem_cap)}
    for i, cap in enumerate(runs.level_caps):
        want[f"lvl{i}_rows"] = (runs.S, cap)
    for key, shape in want.items():
        got = np.shape(arrays.get(key))
        if got != shape:
            raise ValueError(f"state {key!r} has shape {got}, this engine "
                             f"needs {shape}")
    if f"lvl{len(runs.level_caps)}_rows" in arrays:
        raise ValueError("state has more levels than this engine")
    runs.load_state(arrays)
