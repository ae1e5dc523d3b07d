// Staging of int32 arrays from device memory into shared memory with
// cp.async, for the search and merge kernels (rank_batched.cu,
// merge_path.cu). The copies bypass the registers; the body of an array
// moves in 16-byte copies, its unaligned head and tail in 4-byte ones.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace stage {

__device__ __forceinline__ void cp_async4(int* dst, const int* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async16(int* dst, const int* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Copies src[0, n) to dst[shift, shift + n), where shift = (src / 4) % 4,
// so that src + e and dst + shift + e agree modulo 16 bytes: dst must be
// 16-byte aligned with room for n + 3 ints. Every thread of the block
// calls it; the caller then runs wait_all() and __syncthreads(). Returns
// shift.
__device__ __forceinline__ int stage_ints(int* dst, const int* src, int n) {
  const int shift =
      static_cast<int>((reinterpret_cast<uintptr_t>(src) >> 2) & 3);
  const int head = min(n, (4 - shift) & 3);  // ints before the first 16 B
  const int chunks = (n - head) >> 2;
  const int tail = head + 4 * chunks;
  int* d = dst + shift;
  for (int e = threadIdx.x; e < head; e += blockDim.x)
    cp_async4(d + e, src + e);
  for (int b = threadIdx.x; b < chunks; b += blockDim.x)
    cp_async16(d + head + 4 * b, src + head + 4 * b);
  for (int e = tail + threadIdx.x; e < n; e += blockDim.x)
    cp_async4(d + e, src + e);
  return shift;
}

}  // namespace stage
