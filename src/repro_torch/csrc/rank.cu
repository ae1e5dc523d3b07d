// Rank search of queries in ONE sorted int32 table, for Hopper (sm_90a).
//
// Replaces src/repro/kernels/sorted_search/kernel.py::rank_pallas (body
// _rank_kernel), the rank search under the legacy single-run engine's
// point reads (tablet_query_rows: the left and the right rank of every
// queried row id in one shard's tablet). That TPU kernel counts
// `tab < q` (or `<=`) over whole VMEM tiles of the table: O(Q * N) vector
// compares.
//
//   out[i] = #{ j : tab[j] <  q[i] }   (strict, side="left")
//   out[i] = #{ j : tab[j] <= q[i] }   (side="right")
//
// The table is one shard's whole tablet: its sorted valid prefix, then
// I32_MAX pads. Real queries are < I32_MAX, so the pads never count and
// the count is a lower / upper bound. One thread owns one query and runs a
// branch-free binary search: ceil(log2 N) dependent loads, the same trip
// count for every thread (it depends on N only), so a warp never
// diverges. What bounds it on the card: Q * log2(N) probes of 4 bytes,
// latency-bound at the read path's Q (hundreds to a few thousand), the
// upper probes L2 hits shared by every query; the queries and the output
// are touched once, coalesced.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void rank_kernel(const int* __restrict__ tab, int n,
                            const int* __restrict__ q, int n_q, int strict,
                            int* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_q) return;
  const int x = q[i];
  int rank = 0;
  if (n > 0) {
    int base = 0;
    int len = n;
    while (len > 1) {
      const int half = len >> 1;
      const int v = __ldg(tab + base + half);
      const bool take = strict ? (v < x) : (v <= x);
      base = take ? base + half : base;
      len -= half;
    }
    const int v = __ldg(tab + base);
    rank = base + (strict ? (v < x) : (v <= x));
  }
  out[i] = rank;
}

}  // namespace

extern "C" int rank(const int* tab, int n, const int* q, int n_q, int strict,
                    int* out, cudaStream_t stream) {
  if (n_q > 0) {
    const int blocks = (n_q + kThreads - 1) / kThreads;
    rank_kernel<<<blocks, kThreads, 0, stream>>>(tab, n, q, n_q, strict, out);
  }
  return static_cast<int>(cudaGetLastError());
}
