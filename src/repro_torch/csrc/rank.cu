// Rank search of queries in ONE sorted int32 table, and the compacting
// tablet read built on it, for Hopper (sm_90a).
//
// Replaces src/repro/kernels/sorted_search/kernel.py::rank_pallas (body
// _rank_kernel), the rank search under the legacy single-run engine's
// point reads: the left and the right rank of every queried row id in one
// shard's tablet. That TPU kernel counts `tab < q` (or `<=`) over whole
// VMEM tiles of the table: O(Q * N) vector compares.
//
//   out[i] = #{ j : tab[j] <  q[i] }   (side left)
//   out[i] = #{ j : tab[j] <= q[i] }   (side right)
//   both: out[0] the left ranks, out[1] the right ranks, one launch
//
// The table is one shard's whole tablet: its sorted valid prefix, then
// I32_MAX pads, so the array is sorted and the count is a lower / upper
// bound. What bounds it on the H100: not the bytes (a few probes a query)
// but latency. A one-thread binary search (rank_binary_kernel, kept as the
// yardstick) is a chain of ceil(log2 N) dependent loads, 20 at the single
// engine's 815,709-entry tablets, and one thread a query leaves the card
// nearly empty at the read path's Q (hundreds to a few thousand). Here a
// group of kGroup lanes owns one (query, side) pair and runs a kGroup-ary
// search: each level is ONE round trip of kGroup independent pivot loads,
// and a ballot narrows the interval kGroup-fold, so 815,709 entries take
// 3 levels and a last window of kGroup entries read with one coalesced
// load (4 round trips, the top levels L2 hits shared by every query). The
// pivots' predicate is monotone over the sorted table, so the ballot's
// popcount is the length of its true prefix however long a run of equal
// keys is; the trip count depends on N only, so every lane of a warp runs
// the same levels.
//
// tablet_gather_kernel then writes the read's result, compacted: for the
// entries of every queried row, in query order and then in run order, the
// query's row id, col and value at the entry's offset (the exclusive sum
// of the counts before it). Blocks take equal tiles of the OUTPUT, so one
// hub row of thousands of entries spreads over many blocks. A block stages
// the queries' end offsets, starts and ids in shared memory (all of them
// up to kStage queries; past that, those between the queries of the
// tile's first and last entry, which two warps find by the same 32-ary
// search over the end offsets), and each thread finds its entry's query
// there and copies the entry (coalesced stores; the loads are runs of
// consecutive entries). What bounds it: the bytes, 8 read and 12 written
// per entry; at the read path's few tens of thousands of entries, the
// launch and two dependent round trips (the stage, then the entries).
#include <cuda_runtime.h>

namespace {

constexpr int kGroup = 32;      // lanes per (query, side): the search's arity
constexpr int kThreads = 128;
constexpr int kGatherThreads = 256;
constexpr int kGatherItems = 4;  // entries per thread
constexpr int kGatherTile = kGatherThreads * kGatherItems;
constexpr int kStage = 2048;    // queries a gather block stages
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ bool before(int v, int x, bool strict) {
  return strict ? v < x : v <= x;
}

// #{ j < n : tab[j] before x } for sorted tab, by the G lanes of one group
// (lane: the lane's index in its group; shift: the group's first lane in
// its warp). Every lane of the warp calls it together: the levels depend
// on n only. Invariant: the rank lies in [lo, lo + len]; a pivot past n
// counts as not before x.
template <int G>
__device__ __forceinline__ int group_rank(const int* __restrict__ tab, int n,
                                          int x, bool strict, int lane,
                                          int shift) {
  constexpr unsigned kMask = G == 32 ? kFull : (1u << (G & 31)) - 1;
  long long len = G;
  while (len < n) len *= G;
  long long lo = 0;
  while (len > G) {
    const long long step = len / G;
    const long long p = lo + (lane + 1) * step - 1;
    const bool ok = p < n && before(__ldg(tab + p), x, strict);
    lo += __popc((__ballot_sync(kFull, ok) >> shift) & kMask) * step;
    len = step;
  }
  const long long p = lo + lane;  // the last window, one coalesced load
  const bool ok = p < n && before(__ldg(tab + p), x, strict);
  return static_cast<int>(lo) +
         __popc((__ballot_sync(kFull, ok) >> shift) & kMask);
}

// items are (query, side) pairs, side-minor: with kGroup = 16 one warp
// takes both sides of one query
__global__ void __launch_bounds__(kThreads)
rank_kernel(const int* __restrict__ tab, int n, const int* __restrict__ q,
            int n_q, int side0, int n_sides, int* __restrict__ out) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  const long long n_items = static_cast<long long>(n_q) * n_sides;
  if ((t & ~31ll) / kGroup >= n_items) return;  // whole warps leave together
  const long long g = t / kGroup;
  const long long item = g < n_items ? g : n_items - 1;
  const int i = static_cast<int>(item / n_sides);
  const int s = static_cast<int>(item % n_sides);
  const int r = group_rank<kGroup>(tab, n, __ldg(q + i), side0 + s == 0,
                                   threadIdx.x & (kGroup - 1),
                                   threadIdx.x & 31 & ~(kGroup - 1));
  if (g < n_items && (threadIdx.x & (kGroup - 1)) == 0) {
    out[static_cast<long long>(s) * n_q + i] = r;
  }
}

// the design before the k-ary search: one thread a query, a branch-free
// binary search per side
__global__ void rank_binary_kernel(const int* __restrict__ tab, int n,
                                   const int* __restrict__ q, int n_q,
                                   int side0, int n_sides,
                                   int* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_q) return;
  const int x = q[i];
  for (int s = 0; s < n_sides; ++s) {
    const bool strict = side0 + s == 0;
    int rank = 0;
    if (n > 0) {
      int base = 0;
      int len = n;
      while (len > 1) {
        const int half = len >> 1;
        base = before(__ldg(tab + base + half), x, strict) ? base + half
                                                           : base;
        len -= half;
      }
      rank = base + before(__ldg(tab + base), x, strict);
    }
    out[static_cast<long long>(s) * n_q + i] = rank;
  }
}

// #{ j < n : e[j] <= p } for non-decreasing e: the first j with e[j] > p
// when e[n - 1] > p. Branch-free, the trip count depends on n only, so a
// thread's searches interleave
__device__ __forceinline__ int upper(const int* e, int n, int p) {
  int base = 0;
  while (n > 1) {
    const int half = n >> 1;
    base = e[base + half] <= p ? base + half : base;
    n -= half;
  }
  return base + (e[base] <= p);
}

// out[p] for p in [0, total): query i holds the entries
// [ends[i] - (end rank - start rank), ends[i]) of the output, copied from
// [start[i], ...) of the tablet
__global__ void __launch_bounds__(kGatherThreads)
tablet_gather_kernel(const int* __restrict__ cols,
                     const float* __restrict__ vals,
                     const int* __restrict__ start,
                     const int* __restrict__ ends, const int* __restrict__ q,
                     int n_q, int total, int* __restrict__ out_r,
                     int* __restrict__ out_c, float* __restrict__ out_v) {
  __shared__ int s_end[kStage];
  __shared__ int s_start[kStage];
  __shared__ int s_q[kStage];
  __shared__ int s_range[2];
  const int p0 = blockIdx.x * kGatherTile;
  const int p1 = min(total, p0 + kGatherTile) - 1;
  int qa = 0;  // queries [qa, qa + n_s) cover the tile: all that fit
  int n_s = n_q;
  if (n_q > kStage) {  // else those of the tile's first and last entry
    const int warp = threadIdx.x >> 5;
    if (warp < 2) {
      const int r = group_rank<32>(ends, n_q, warp == 0 ? p0 : p1, false,
                                   threadIdx.x & 31, 0);
      if ((threadIdx.x & 31) == 0) s_range[warp] = r;
    }
    __syncthreads();
    qa = s_range[0];
    n_s = s_range[1] - qa + 1;
  }
  const int* e = ends + qa;
  const int* st = start + qa;
  const int* qq = q + qa;
  if (n_s <= kStage) {  // every load in flight before the first store
    constexpr int kLoads = kStage / kGatherThreads;
    int v[3][kLoads];
#pragma unroll
    for (int k = 0; k < kLoads; ++k) {
      const int j = threadIdx.x + k * kGatherThreads;
      if (j < n_s) {
        v[0][k] = __ldg(e + j);
        v[1][k] = __ldg(st + j);
        v[2][k] = __ldg(qq + j);
      }
    }
#pragma unroll
    for (int k = 0; k < kLoads; ++k) {
      const int j = threadIdx.x + k * kGatherThreads;
      if (j < n_s) {
        s_end[j] = v[0][k];
        s_start[j] = v[1][k];
        s_q[j] = v[2][k];
      }
    }
    e = s_end;
    st = s_start;
    qq = s_q;
  }
  const int off0 = qa > 0 ? __ldg(ends + qa - 1) : 0;
  __syncthreads();
  int src[kGatherItems], row[kGatherItems], col[kGatherItems];
  float val[kGatherItems];
#pragma unroll
  for (int k = 0; k < kGatherItems; ++k) {  // each entry's query, source
    const int p = p0 + k * kGatherThreads + threadIdx.x;
    if (p <= p1) {
      const int j = upper(e, n_s, p);
      src[k] = st[j] + (p - (j > 0 ? e[j - 1] : off0));
      row[k] = qq[j];
    }
  }
#pragma unroll
  for (int k = 0; k < kGatherItems; ++k) {  // the entries' loads together
    if (p0 + k * kGatherThreads + threadIdx.x <= p1) {
      col[k] = __ldg(cols + src[k]);
      val[k] = __ldg(vals + src[k]);
    }
  }
#pragma unroll
  for (int k = 0; k < kGatherItems; ++k) {
    const int p = p0 + k * kGatherThreads + threadIdx.x;
    if (p <= p1) {
      out_r[p] = row[k];
      out_c[p] = col[k];
      out_v[p] = val[k];
    }
  }
}

}  // namespace

// sides: 0 left, 1 right, 2 both ([2, n_q], left first); binary: the
// one-thread binary search in place of the k-ary search
extern "C" int rank(const int* tab, int n, const int* q, int n_q, int sides,
                    int binary, int* out, cudaStream_t stream) {
  const int side0 = sides == 1 ? 1 : 0;
  const int n_sides = sides == 2 ? 2 : 1;
  if (n_q > 0 && binary) {
    const int blocks = (n_q + 255) / 256;
    rank_binary_kernel<<<blocks, 256, 0, stream>>>(tab, n, q, n_q, side0,
                                                    n_sides, out);
  } else if (n_q > 0) {
    const long long threads = static_cast<long long>(n_q) * n_sides * kGroup;
    const int blocks = static_cast<int>((threads + kThreads - 1) / kThreads);
    rank_kernel<<<blocks, kThreads, 0, stream>>>(tab, n, q, n_q, side0,
                                                 n_sides, out);
  }
  return static_cast<int>(cudaGetLastError());
}

// ends: the inclusive sum of the queries' counts (end rank - start rank),
// total = ends[n_q - 1] > 0 entries written to out_r, out_c, out_v
extern "C" int tablet_gather(const int* cols, const float* vals,
                             const int* start, const int* ends, const int* q,
                             int n_q, int total, int* out_r, int* out_c,
                             float* out_v, cudaStream_t stream) {
  if (total > 0) {
    const int blocks = (total + kGatherTile - 1) / kGatherTile;
    tablet_gather_kernel<<<blocks, kGatherThreads, 0, stream>>>(
        cols, vals, start, ends, q, n_q, total, out_r, out_c, out_v);
  }
  return static_cast<int>(cudaGetLastError());
}
