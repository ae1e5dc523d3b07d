// Batched rank search over K sorted int32 rows, for Hopper (sm_90a).
//
// Replaces src/repro/kernels/sorted_search/kernel.py::rank_pallas_batched
// (body _rank_batched_kernel). That TPU kernel counts `tabs[k, :] < q`
// (or `<=`) over whole VMEM tiles: O(K * Q * N) vector compares, which the
// TPU's wide vector unit absorbs at fence-array sizes.
//
//   out[k, i] = #{ j : tabs[k, j] <  q[i] }   (strict, side="left")
//   out[k, i] = #{ j : tabs[k, j] <= q[i] }   (side="right")
//
// Every row is sorted (pads are I32_MAX at the tail), so the count is a
// lower / upper bound. Here one thread owns one (k, i) pair and runs a
// branch-free binary search of row k: ceil(log2 N) dependent loads, the
// same trip count for every thread of a warp (it depends on N only), so
// the warp never diverges. What bounds it on the card: K * Q * log2(N)
// probes of 4 bytes, most of them L2 hits (a fence row of the fused read
// is a few KB and is shared by every query of the launch). The queries
// and the output are each touched once, coalesced.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void rank_batched_kernel(const int* __restrict__ tabs, int n_rows,
                                    int n, const int* __restrict__ q,
                                    int n_q, int strict,
                                    int* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int k = blockIdx.y;
  if (i >= n_q || k >= n_rows) return;
  const int* row = tabs + static_cast<size_t>(k) * n;
  const int x = q[i];
  int rank = 0;
  if (n > 0) {
    int base = 0;
    int len = n;
    while (len > 1) {
      const int half = len >> 1;
      const int v = __ldg(row + base + half);
      const bool take = strict ? (v < x) : (v <= x);
      base = take ? base + half : base;
      len -= half;
    }
    const int v = __ldg(row + base);
    rank = base + (strict ? (v < x) : (v <= x));
  }
  out[static_cast<size_t>(k) * n_q + i] = rank;
}

}  // namespace

extern "C" int rank_batched(const int* tabs, int n_rows, int n,
                            const int* q, int n_q, int strict, int* out,
                            cudaStream_t stream) {
  if (n_rows > 0 && n_q > 0) {
    dim3 grid((n_q + kThreads - 1) / kThreads, n_rows);
    rank_batched_kernel<<<grid, kThreads, 0, stream>>>(tabs, n_rows, n, q,
                                                        n_q, strict, out);
  }
  return static_cast<int>(cudaGetLastError());
}
