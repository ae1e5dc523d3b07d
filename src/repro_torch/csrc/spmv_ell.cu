// Sparse matrix-vector product over ELL rows, for Hopper (sm_90a).
//
// Replaces src/repro/kernels/spmv/kernel.py::spmv_ell_pallas (body
// _spmv_kernel), the SpMV under graphulo.table_spmv (one BFS / PageRank
// step over a table's adjacency).
//
//   y[r] = sum_k vals[r, k] * x[cols[r, k]];  a column < 0 (the ELL pad)
//          or >= len(x) adds 0
//
// The TPU kernel tiles x into VMEM (block_c wide) and accumulates each row
// block over the x tiles with masked gathers, so a column past the padded
// width of x matches no tile; the port keeps that meaning (any column
// >= len(x) adds 0). Here one warp owns one row: its lanes stride over the
// row's K slots of the row-major [R, K] arrays, so the loads of cols and
// vals coalesce; each lane gathers x[col] (x is small and stays in L2) and
// the warp sums its lanes with shuffles. What bounds it: the 8 bytes per
// slot of cols and vals, read once. A power-law graph pads every row to
// the largest degree, so most slots are pads: the ELL format, not the
// kernel, sets the byte count.
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;  // rows per block of 256 threads

__global__ void spmv_ell_kernel(const int* __restrict__ cols,
                                const float* __restrict__ vals, int n_rows,
                                int k, const float* __restrict__ x, int n_x,
                                float* __restrict__ y) {
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= n_rows) return;  // the whole warp leaves together
  const int* c = cols + row * k;
  const float* v = vals + row * k;
  float acc = 0.0f;
  for (int j = lane; j < k; j += 32) {
    const int col = __ldg(c + j);
    if (col >= 0 && col < n_x) acc += __ldg(v + j) * __ldg(x + col);
  }
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  if (lane == 0) y[row] = acc;
}

}  // namespace

extern "C" int spmv_ell(const int* cols, const float* vals, int n_rows, int k,
                        const float* x, int n_x, float* y,
                        cudaStream_t stream) {
  if (n_rows > 0) {
    const int blocks = (n_rows + kWarps - 1) / kWarps;
    spmv_ell_kernel<<<blocks, kWarps * 32, 0, stream>>>(cols, vals, n_rows, k,
                                                        x, n_x, y);
  }
  return static_cast<int>(cudaGetLastError());
}
