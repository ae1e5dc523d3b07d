// Segment sum (scatter-add) of float32 values by int32 segment id, for
// Hopper (sm_90a).
//
// Replaces src/repro/kernels/segment_reduce/kernel.py::segment_sum_pallas
// (body _segsum_kernel), the combiner iterator that keeps the D4M 2.0
// degree table (schema.DegreeTable.update -> kvstore.degree_update).
//
//   out[s] = sum of vals[i] over ids[i] == s;  ids < 0 or >= n_segments
//            are dropped
//
// The TPU kernel reduces each block with a one-hot (block_n x block_s)
// matrix product on the MXU: O(N * S) work, because a TPU scatters poorly.
// At a degree update's shape (1M ids into 65,536 segments) that is ~7e10
// multiply-adds, the wrong shape for this card. Here one thread owns one
// entry and adds it with an atomicAdd (compiled to a fire-and-forget RED)
// into the output, which the wrapper zeroes. What bounds it: the 8 bytes
// read per entry, and the L2 atomic units where many entries hit one
// address. Graph500 ids are power-law, so a hub vertex takes thousands of
// atomics on one address; privatising the hot segments in shared memory is
// left for later. Float atomics add in no fixed order: the sum is exact
// for integer-valued inputs below 2^24 (degree counts), and within float32
// rounding of the ordered sum otherwise.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void segment_sum_kernel(const int* __restrict__ ids,
                                   const float* __restrict__ vals, int n,
                                   int n_segments, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int s = ids[i];
  if (s >= 0 && s < n_segments) atomicAdd(out + s, vals[i]);
}

}  // namespace

extern "C" int segment_sum(const int* ids, const float* vals, int n,
                           int n_segments, float* out, cudaStream_t stream) {
  if (n > 0 && n_segments > 0) {
    const int blocks = (n + kThreads - 1) / kThreads;
    segment_sum_kernel<<<blocks, kThreads, 0, stream>>>(ids, vals, n,
                                                        n_segments, out);
  }
  return static_cast<int>(cudaGetLastError());
}
