// Lexicographic pair rank of one sorted (row, col) run in another, batched
// over shards, for Hopper (sm_90a).
//
// Replaces src/repro/kernels/merge_rank/kernel.py::pair_rank_pallas (body
// _merge_rank_kernel): for each query pair (qr, qc), the number of pairs
// (tr, tc) of the other run that precede it lexicographically, strictly
// (A ranked in B) or not (B ranked in A, so the older A side comes first on
// equal keys). The TPU kernel counts compares over whole tiles, O(n * m).
// Major compaction calls it at a level's capacity (hundreds of thousands
// of entries per shard), where a quadratic count is ~1e11 compares.
//
// Both runs are sorted by contract (pads are (I32_MAX, I32_MAX) at the
// tail), so the count is a bound: one thread per query runs a branch-free
// binary search over the other run of its shard (blockIdx.y), with a trip
// count that depends only on the run length. What bounds it on the card:
// n * log2(m) dependent 8-byte probes (row and col), the upper levels of
// the search tree staying in L2; queries and output are read and written
// once, coalesced. The scatter into merged positions stays in PyTorch.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ bool precedes(int r, int c, int xr, int xc,
                                         int strict) {
  return (r < xr) || (r == xr && (strict ? (c < xc) : (c <= xc)));
}

__global__ void pair_rank_kernel(const int* __restrict__ tr,
                                 const int* __restrict__ tc, int n_t,
                                 const int* __restrict__ qr,
                                 const int* __restrict__ qc, int n_q,
                                 int strict, int* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_q) return;
  const size_t s = blockIdx.y;
  const int* rows = tr + s * n_t;
  const int* cols = tc + s * n_t;
  const int xr = qr[s * n_q + i];
  const int xc = qc[s * n_q + i];
  int rank = 0;
  if (n_t > 0) {
    int base = 0;
    int len = n_t;
    while (len > 1) {
      const int half = len >> 1;
      const int m = base + half;
      const bool take = precedes(__ldg(rows + m), __ldg(cols + m), xr, xc,
                                 strict);
      base = take ? m : base;
      len -= half;
    }
    rank = base + precedes(__ldg(rows + base), __ldg(cols + base), xr, xc,
                           strict);
  }
  out[s * n_q + i] = rank;
}

}  // namespace

extern "C" int pair_rank(const int* tr, const int* tc, int n_t,
                         const int* qr, const int* qc, int n_q, int batch,
                         int strict, int* out, cudaStream_t stream) {
  if (batch > 0 && n_q > 0) {
    dim3 grid((n_q + kThreads - 1) / kThreads, batch);
    pair_rank_kernel<<<grid, kThreads, 0, stream>>>(tr, tc, n_t, qr, qc,
                                                     n_q, strict, out);
  }
  return static_cast<int>(cudaGetLastError());
}
