// Per-row strict self-rank, for Hopper (sm_90a).
//
// Replaces src/repro/kernels/merge_rank/kernel.py::row_rank_pallas (body
// _row_rank_kernel):
//
//   o[i, j] = #{ k : keys[i, k] < keys[i, j] }
//
// A row is the concatenation of K sorted candidate segments of the fused
// point read, so it is NOT sorted and the quadratic count is the right
// algorithm: with valid keys unique per row, the count is the element's
// position in the merged row (all I32_MAX pads rank at n_valid).
//
// One block per row. The row is staged through shared memory in tiles;
// every thread keeps its own key in a register and counts the tile against
// it, so each shared-memory read is a broadcast to the whole warp. What
// bounds it on the card: Q * W^2 integer compares (W <= 256 on the read
// path: ~3.4e7 for a 512-query tile) against Q * W * 8 bytes of traffic,
// so the compare rate, not memory, is the limit at these widths.
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 1024;
constexpr int kMaxThreads = 256;

__global__ void row_rank_kernel(const int* __restrict__ keys, int width,
                                int* __restrict__ out) {
  __shared__ int tile[kTile];
  const int* row = keys + static_cast<size_t>(blockIdx.x) * width;
  int* orow = out + static_cast<size_t>(blockIdx.x) * width;
  // every loop bound below is uniform across the block, so the barriers
  // are reached by all threads
  for (int j0 = 0; j0 < width; j0 += blockDim.x) {
    const int j = j0 + threadIdx.x;
    const int mine = j < width ? row[j] : 0;
    int count = 0;
    for (int t0 = 0; t0 < width; t0 += kTile) {
      const int n = min(kTile, width - t0);
      __syncthreads();
      for (int t = threadIdx.x; t < n; t += blockDim.x) tile[t] = row[t0 + t];
      __syncthreads();
#pragma unroll 8
      for (int t = 0; t < n; ++t) count += tile[t] < mine;
    }
    if (j < width) orow[j] = count;
  }
}

}  // namespace

extern "C" int row_rank(const int* keys, int n_rows, int width, int* out,
                        cudaStream_t stream) {
  if (n_rows > 0 && width > 0) {
    int threads = ((width + 31) / 32) * 32;
    if (threads > kMaxThreads) threads = kMaxThreads;
    row_rank_kernel<<<n_rows, threads, 0, stream>>>(keys, width, out);
  }
  return static_cast<int>(cudaGetLastError());
}
