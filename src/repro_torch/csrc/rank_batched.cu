// Batched rank search over K sorted int32 rows, for Hopper (sm_90a).
//
// Replaces src/repro/kernels/sorted_search/kernel.py::rank_pallas_batched
// (body _rank_batched_kernel). That TPU kernel counts `tabs[k, :] < q`
// (or `<=`) over whole VMEM tiles: O(K * Q * N) vector compares, which the
// TPU's wide vector unit absorbs at fence-array sizes.
//
//   out[k, i] = #{ j : tabs[k, j] <  q[i] }   (side left)
//   out[k, i] = #{ j : tabs[k, j] <= q[i] }   (side right)
//   both: out[0] the left ranks, out[1] the right ranks, one launch
//
// Every row is sorted (pads are I32_MAX at the tail), so the count is a
// lower / upper bound. What bounds it on the H100: not the bytes (a fence
// row of the fused read is at most a few KB, and the queries and ranks are
// touched once) but latency: a binary search from device memory is a chain
// of ceil(log2 N) dependent L2 loads per query. So a block owns one row k
// (blockIdx.y) and a tile of kThreads queries: it stages the row into
// shared memory with coalesced cp.async copies (one round trip), then each
// thread runs its branch-free search there. For `both` the right bound is
// searched from the left one, so the fused point read's two searches of
// the same fences and queries are one launch.
//
// A row longer than kStage entries stages every stride-th entry instead
// (stride = 32, doubled until the samples fit): the search over the
// samples brackets the rank to one stride of the row, which is narrowed in
// device memory to 32 entries and counted with 32 independent loads. So
// every row length is taken.
#include <cuda_runtime.h>

#include "stage.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kStage = 8192;   // entries a block stages (32 KB)
constexpr int kWindow = 32;    // entries the sampled search counts at last

__device__ __forceinline__ bool before(int v, int x, bool strict) {
  return strict ? v < x : v <= x;
}

// lo + #{ e in [lo, n) : s[e] before x } for sorted s (branch-free: the
// trip count depends on n - lo only)
__device__ __forceinline__ int search(const int* s, int lo, int n, int x,
                                      bool strict) {
  if (lo >= n) return lo;
  int base = lo;
  int len = n - lo;
  while (len > 1) {
    const int half = len >> 1;
    base = before(s[base + half], x, strict) ? base + half : base;
    len -= half;
  }
  return base + before(s[base], x, strict);
}

// the rank of x in row[0, n), given c = #{ samples row[m * stride] before
// x }: the rank lies in ((c - 1) * stride, c * stride]
__device__ __forceinline__ int finish(const int* __restrict__ row, int n,
                                      int stride, int c, int x, bool strict) {
  if (c == 0) return 0;
  int lo = (c - 1) * stride;  // row[lo] is before x
  int len = min(stride, n - lo);
  while (len > kWindow) {
    const int half = len >> 1;
    if (before(__ldg(row + lo + half), x, strict)) {
      lo += half;
      len -= half;
    } else {
      len = half;
    }
  }
  int cnt = 0;
#pragma unroll
  for (int e = 0; e < kWindow; ++e)
    cnt += (e < len) && before(__ldg(row + lo + e), x, strict);
  return lo + cnt;
}

// sides: 0 left, 1 right, 2 both; stride 1 stages the whole row
__global__ void __launch_bounds__(kThreads)
rank_batched_kernel(const int* __restrict__ tabs, int n_rows, int n,
                    const int* __restrict__ q, int n_q, int sides,
                    int stride, int* __restrict__ out) {
  extern __shared__ __align__(16) int s_tab[];
  const int k = blockIdx.y;
  const int* row = tabs + static_cast<size_t>(k) * n;
  int shift = 0;
  int n_s = n;
  if (stride == 1) {
    shift = stage::stage_ints(s_tab, row, n);
  } else {
    n_s = (n - 1) / stride + 1;
    for (int m = threadIdx.x; m < n_s; m += kThreads)
      stage::cp_async4(s_tab + m, row + static_cast<size_t>(m) * stride);
  }
  stage::wait_all();
  __syncthreads();
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_q) return;
  const int* s = s_tab + shift;
  const int x = q[i];
  const size_t o = static_cast<size_t>(k) * n_q + i;
  const bool strict = sides != 1;
  const int c = search(s, 0, n_s, x, strict);
  out[o] = stride == 1 ? c : finish(row, n, stride, c, x, strict);
  if (sides == 2) {  // the right bound, from the left one
    const int c2 = search(s, c, n_s, x, false);
    out[static_cast<size_t>(n_rows) * n_q + o] =
        stride == 1 ? c2 : finish(row, n, stride, c2, x, false);
  }
}

}  // namespace

extern "C" int rank_batched(const int* tabs, int n_rows, int n,
                            const int* q, int n_q, int sides, int* out,
                            cudaStream_t stream) {
  if (sides < 0 || sides > 2 || n < 0 || n_rows > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows > 0 && n_q > 0) {
    int stride = 1;
    if (n > kStage) {
      stride = kWindow;
      while ((n - 1) / stride + 1 > kStage) stride <<= 1;
    }
    const int n_s = stride == 1 ? n : (n - 1) / stride + 1;
    const size_t smem = static_cast<size_t>(n_s + 4) * sizeof(int);
    const dim3 grid((n_q + kThreads - 1) / kThreads, n_rows);
    rank_batched_kernel<<<grid, kThreads, smem, stream>>>(
        tabs, n_rows, n, q, n_q, sides, stride, out);
  }
  return static_cast<int>(cudaGetLastError());
}
