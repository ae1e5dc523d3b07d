// Merge ranks of two sorted (row, col) runs by merge path, batched over
// shards, for Hopper (sm_90a).
//
// Replaces src/repro/kernels/merge_rank/kernel.py::pair_rank_pallas (body
// _merge_rank_kernel) on the merge path of major compaction and of the
// single engine's flush (merge_rank.ops.merge_sorted): the two calls
//
//   rank_a = pair_rank(B, A, strict)     #{ j : B[j] <  A[i] }
//   rank_b = pair_rank(A, B, not strict) #{ i : A[i] <= B[j] }
//
// for runs A = (ar, ac)[S, n_a] and B = (br, bc)[S, n_b], each sorted
// lexicographically over its whole width ((I32_MAX, I32_MAX) pads at the
// tail). Both are the ranks of one stable merge in which A comes first on
// equal keys: A[i] at merged position p has rank_a[i] = p - i, B[j] at p
// has rank_b[j] = p - j. The TPU kernel counts compares over whole tiles,
// O(n_a * n_b); a binary search per query (pair_rank.cu) is a chain of
// log2(n) dependent loads per entry.
//
// What bounds it on the H100: the bytes, 12 per entry of both runs (row and
// col read once, the rank written once): 78 MB, 23 us at 3.35 TB/s, for the
// single engine's [4, 815,709] x [4, 815,709] flush. The merge path (Green,
// McColl and Bader, "GPU Merge Path", ICS 2012) reads each run once,
// coalesced:
//   - partition_kernel: one warp per tile boundary d = t * kTile of each
//     shard's merged output finds the co-rank i(d), the number of A entries
//     among the first d outputs, by a 32-ary search along the diagonal:
//     each round the 32 lanes test 32 points at once (one coalesced round
//     trip) and a ballot narrows the range 32-fold, ~5 rounds at 10^6;
//   - merge_kernel: one block per (tile, shard) stages its A window and its
//     B window (kTile entries in all) into shared memory with cp.async,
//     each thread finds its own co-rank there at kItems outputs apart and
//     merges kItems entries sequentially; the ranks are staged in shared
//     memory and written back coalesced. No atomics: the same result on
//     every run.
// Both tests of "A first on equal keys" (the co-rank predicate and the
// sequential merge) are the one function a_first(), so an equal-key group
// (or the two runs' pads) split across tiles lands the same way on either
// side of the boundary.
#include <cuda_runtime.h>

#include "stage.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;                  // merged outputs per thread
constexpr int kTile = kThreads * kItems;   // merged outputs per block
constexpr int kWarps = kThreads / 32;

// A entry (ar, ac) precedes B entry (br, bc) in the merge
__device__ __forceinline__ bool a_first(int ar, int ac, int br, int bc) {
  return ar < br || (ar == br && ac <= bc);
}

// co-rank of diagonal d: lo + #{ i in (lo, hi] : A[i - 1] precedes
// B[d - i] }, a prefix of (lo, hi]; one warp, 32 probes per round
__global__ void __launch_bounds__(kThreads)
partition_kernel(const int* __restrict__ ar, const int* __restrict__ ac,
                 int n_a, const int* __restrict__ br,
                 const int* __restrict__ bc, int n_b, int n_bounds,
                 int* __restrict__ bounds) {
  const int lane = threadIdx.x & 31;
  const int t = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (t >= n_bounds) return;  // whole warps leave together
  const size_t s = blockIdx.y;
  const int* a_r = ar + s * n_a;
  const int* a_c = ac + s * n_a;
  const int* b_r = br + s * n_b;
  const int* b_c = bc + s * n_b;
  const int d = static_cast<int>(
      min(static_cast<long long>(t) * kTile,
          static_cast<long long>(n_a) + n_b));
  int lo = max(0, d - n_b);
  int hi = min(d, n_a);
  while (hi > lo) {  // warp-uniform
    const int len = hi - lo;
    const long long step = (len + 31) >> 5;
    const int p = lo + static_cast<int>(min((lane + 1) * step,
                                            static_cast<long long>(len)));
    const bool ok = a_first(__ldg(a_r + p - 1), __ldg(a_c + p - 1),
                            __ldg(b_r + d - p), __ldg(b_c + d - p));
    const int m = __popc(__ballot_sync(0xffffffffu, ok));
    if (m == 32) {
      lo = hi;
    } else {  // the co-rank is in [lo + m * step, lo + (m + 1) * step)
      hi = lo + static_cast<int>(min((m + 1) * step,
                                     static_cast<long long>(len))) - 1;
      lo = lo + static_cast<int>(min(m * step, static_cast<long long>(len)));
    }
  }
  if (lane == 0) bounds[s * n_bounds + t] = lo;
}

__global__ void __launch_bounds__(kThreads)
merge_kernel(const int* __restrict__ ar, const int* __restrict__ ac, int n_a,
             const int* __restrict__ br, const int* __restrict__ bc, int n_b,
             int n_bounds, const int* __restrict__ bounds,
             int* __restrict__ rank_a, int* __restrict__ rank_b) {
  __shared__ __align__(16) int s_ar[kTile + 4];
  __shared__ __align__(16) int s_ac[kTile + 4];
  __shared__ __align__(16) int s_br[kTile + 4];
  __shared__ __align__(16) int s_bc[kTile + 4];
  __shared__ int s_rank[kTile];
  const int t = blockIdx.x;
  const size_t s = blockIdx.y;
  const int total = n_a + n_b;
  const int d0 = t * kTile;
  const int d1 = total - d0 < kTile ? total : d0 + kTile;
  const int i0 = bounds[s * n_bounds + t];
  const int i1 = bounds[s * n_bounds + t + 1];
  const int j0 = d0 - i0;
  const int na = i1 - i0;
  const int nb = (d1 - i1) - j0;
  const int* A_r = s_ar + stage::stage_ints(s_ar, ar + s * n_a + i0, na);
  const int* A_c = s_ac + stage::stage_ints(s_ac, ac + s * n_a + i0, na);
  const int* B_r = s_br + stage::stage_ints(s_br, br + s * n_b + j0, nb);
  const int* B_c = s_bc + stage::stage_ints(s_bc, bc + s * n_b + j0, nb);
  stage::wait_all();
  __syncthreads();

  // this thread's co-rank at local diagonal dl (binary search in shared
  // memory, the same predicate as the partition)
  const int dl = min(static_cast<int>(threadIdx.x) * kItems, na + nb);
  int lo = max(0, dl - nb);
  int hi = min(dl, na);
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (a_first(A_r[mid - 1], A_c[mid - 1], B_r[dl - mid], B_c[dl - mid]))
      lo = mid;
    else
      hi = mid - 1;
  }
  int i = lo;
  int j = dl - lo;
  const int end = min(dl + kItems, na + nb);
  for (int p = dl; p < end; ++p) {
    if (j >= nb || (i < na && a_first(A_r[i], A_c[i], B_r[j], B_c[j]))) {
      s_rank[i] = j0 + j;  // p - i in global terms
      ++i;
    } else {
      s_rank[na + j] = i0 + i;
      ++j;
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < na; e += kThreads)
    rank_a[s * n_a + i0 + e] = s_rank[e];
  for (int e = threadIdx.x; e < nb; e += kThreads)
    rank_b[s * n_b + j0 + e] = s_rank[na + e];
}

}  // namespace

// bounds: scratch of batch * n_bounds ints, n_bounds = ceil((n_a + n_b) /
// kTile) + 1 (the wrapper allocates it); n_a + n_b < 2^31, batch <= 65535
extern "C" int merge_path_rank(const int* ar, const int* ac, int n_a,
                               const int* br, const int* bc, int n_b,
                               int batch, int* bounds, int n_bounds,
                               int* rank_a, int* rank_b,
                               cudaStream_t stream) {
  const long long total = static_cast<long long>(n_a) + n_b;
  const long long n_tiles = total > 0 ? (total - 1) / kTile + 1 : 0;
  if (n_a < 0 || n_b < 0 || total >= (1LL << 31) || batch > 65535 ||
      n_bounds != n_tiles + 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch > 0 && total > 0) {
    const dim3 pgrid((n_bounds + kWarps - 1) / kWarps, batch);
    partition_kernel<<<pgrid, kThreads, 0, stream>>>(ar, ac, n_a, br, bc,
                                                      n_b, n_bounds, bounds);
    const dim3 mgrid(static_cast<unsigned>(n_tiles), batch);
    merge_kernel<<<mgrid, kThreads, 0, stream>>>(ar, ac, n_a, br, bc, n_b,
                                                  n_bounds, bounds, rank_a,
                                                  rank_b);
  }
  return static_cast<int>(cudaGetLastError());
}
