// An empty kernel: the floor under every launch on this card. Timed by
// CUDA-graph replay beside the kernels (chip_smoke.py phase 5), it shows
// how much of a latency-bound kernel's time is the launch itself. No path
// runs it.
#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

}  // namespace

extern "C" int launch_floor(cudaStream_t stream) {
  empty_kernel<<<1, 32, 0, stream>>>();
  return static_cast<int>(cudaGetLastError());
}
