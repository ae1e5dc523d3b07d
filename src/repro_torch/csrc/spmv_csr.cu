// Sparse matrix-vector product over CSR rows, for Hopper (sm_90a).
//
// Replaces src/repro/kernels/spmv/kernel.py::spmv_ell_pallas (body
// _spmv_kernel) on Graphulo's path (graphulo.table_spmv): the TPU kernel
// pads every row to the largest degree (ELL) so that its blocks have fixed
// shapes; on this card CSR is the native format, and the table's scan
// gives it directly.
//
//   y[r] = sum_{e in [indptr[r], indptr[r+1])} vals[e] * x[cols[e]];
//          a column < 0 or >= len(x) adds 0, duplicate columns accumulate
//
// What bounds it on the H100: the bytes of indptr, cols, vals, x and y,
// each read or written once (about 8 MB for Graphulo's scale-16 graph,
// 2.5 us at 3.35 TB/s); x (187 KB there) stays in L2. The degrees follow a
// power law (about 20 entries per row, 6,291 at the hub), so the work is cut
// by entries, not rows: block b owns the entries [b * kE, (b + 1) * kE), and
// no row, however long, costs one block more than kE entries.
//
// Kernel 1 (one block of 256 threads per kE = 1,024 entries): the threads
// load cols and vals coalesced, form the products in shared memory, and
// mark where each row starting in the block begins; a segmented inclusive
// scan (per thread over 4 entries, then across lanes by shuffles, then
// across the 8 warps) gives each row's sum within the block at its last
// entry. The block writes y for the rows whose first entry it holds (the
// rows [lo, hi) found by two binary searches of indptr, empty rows
// included: they get 0) and, into `carry[b]`, the sum of its leading
// entries that continue a row begun in an earlier block; `cross[b]` names
// its last row if that row runs on past the block (else -1).
// Kernel 2 (one thread per block): for each row that crosses, adds the
// carries of the blocks it runs through, in block order, to its y.
// No atomics: every sum is taken in a fixed order, so the result is the
// same from run to run.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 4;                 // entries per thread
constexpr int kE = kThreads * kPer;     // entries per block
constexpr int kWarps = kThreads / 32;

// first r in [0, n) with a[r] >= v (n when none)
__device__ __forceinline__ int lower_bound(const int* __restrict__ a, int n,
                                           int v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(a + mid) < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// (flag, value) segmented-sum operator: b after a
__device__ __forceinline__ void seg_add(bool fa, float va, bool& fb,
                                        float& vb) {
  if (!fb) vb += va;
  fb = fb || fa;  // b's flags now cover a's too
}

__global__ void __launch_bounds__(kThreads)
    spmv_csr_blocks(const int* __restrict__ indptr, int n_rows,
                    const int* __restrict__ cols,
                    const float* __restrict__ vals, int nnz,
                    const float* __restrict__ x, int n_x,
                    float* __restrict__ y, float* __restrict__ carry,
                    int* __restrict__ cross) {
  __shared__ __align__(16) float s_val[kE];
  __shared__ __align__(16) unsigned char s_head[kE];
  __shared__ int s_rows[2];
  __shared__ bool s_wf[kWarps];
  __shared__ float s_wv[kWarps];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int e0 = blockIdx.x * kE;
  const int e_end = min(nnz, e0 + kE);
  const bool last_block = blockIdx.x == gridDim.x - 1;

  // coalesced loads, all issued before any is used
  int c[kPer];
  float v[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int e = e0 + j * kThreads + tid;
    c[j] = e < e_end ? __ldg(cols + e) : -1;
    v[j] = e < e_end ? __ldg(vals + e) : 0.0f;
  }
  // the rows [lo, hi) whose first entry lies in the block (the last block
  // also owns the rows that start at nnz: empty rows at the end)
  if (tid == 0) s_rows[0] = lower_bound(indptr, n_rows, e0);
  if (tid == 32)
    s_rows[1] = last_block ? n_rows : lower_bound(indptr, n_rows, e_end);
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int k = j * kThreads + tid;
    s_val[k] = (c[j] >= 0 && c[j] < n_x) ? v[j] * __ldg(x + c[j]) : 0.0f;
    s_head[k] = k == 0;  // the block's first entry starts a segment
  }
  __syncthreads();
  const int lo = s_rows[0], hi = s_rows[1];
  for (int r = lo + tid; r < hi; r += kThreads) {
    const int start = __ldg(indptr + r);
    if (start < e_end) s_head[start - e0] = 1;
  }
  __syncthreads();

  // segmented inclusive scan; thread t owns entries 4t .. 4t + 3
  const float4 v4 = reinterpret_cast<const float4*>(s_val)[tid];
  const uchar4 h4 = reinterpret_cast<const uchar4*>(s_head)[tid];
  float sv[kPer] = {v4.x, v4.y, v4.z, v4.w};
  bool sf[kPer] = {h4.x != 0, h4.y != 0, h4.z != 0, h4.w != 0};
#pragma unroll
  for (int j = 1; j < kPer; ++j) seg_add(sf[j - 1], sv[j - 1], sf[j], sv[j]);
  bool f = sf[kPer - 1];
  float a = sv[kPer - 1];
  for (int off = 1; off < 32; off <<= 1) {
    const bool fo = __shfl_up_sync(0xffffffffu, f, off);
    const float ao = __shfl_up_sync(0xffffffffu, a, off);
    if (lane >= off) seg_add(fo, ao, f, a);
  }
  if (lane == 31) {
    s_wf[warp] = f;
    s_wv[warp] = a;
  }
  // the thread's exclusive prefix: the lane before it, then the warps before
  bool pf = __shfl_up_sync(0xffffffffu, f, 1);
  float pv = __shfl_up_sync(0xffffffffu, a, 1);
  if (lane == 0) {
    pf = false;
    pv = 0.0f;
  }
  __syncthreads();
  bool wf = false;
  float wv = 0.0f;
  for (int w = 0; w < warp; ++w) {  // warps 0 .. warp - 1, in order
    bool fw = s_wf[w];
    float vw = s_wv[w];
    seg_add(wf, wv, fw, vw);
    wf = fw;
    wv = vw;
  }
  seg_add(wf, wv, pf, pv);
#pragma unroll
  for (int j = 0; j < kPer; ++j) seg_add(pf, pv, sf[j], sv[j]);
  reinterpret_cast<float4*>(s_val)[tid] =
      make_float4(sv[0], sv[1], sv[2], sv[3]);
  __syncthreads();

  // y of the rows the block owns: the scan at each row's last entry here
  for (int r = lo + tid; r < hi; r += kThreads) {
    const int start = __ldg(indptr + r), end = __ldg(indptr + r + 1);
    const int stop = min(end, e_end);
    y[r] = stop > start ? s_val[stop - 1 - e0] : 0.0f;
    if (end > e_end) cross[blockIdx.x] = r;  // only the last row can
  }
  if (tid == 0) {
    // entries before the first row that starts here continue a row that
    // an earlier block owns
    const int head_end =
        lo < n_rows ? min(__ldg(indptr + lo), e_end) : e_end;
    carry[blockIdx.x] = head_end > e0 ? s_val[head_end - 1 - e0] : 0.0f;
    const bool crosses =
        hi > lo && __ldg(indptr + hi) > e_end && e_end < nnz;
    if (!crosses) cross[blockIdx.x] = -1;
  }
}

__global__ void spmv_csr_fixup(const int* __restrict__ indptr,
                               const float* __restrict__ carry,
                               const int* __restrict__ cross, int n_blocks,
                               float* __restrict__ y) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= n_blocks) return;
  const int r = cross[b];
  if (r < 0) return;
  const int end = __ldg(indptr + r + 1);
  float acc = y[r];
  for (int b2 = b + 1; b2 < n_blocks && b2 * kE < end; ++b2) acc += carry[b2];
  y[r] = acc;
}

}  // namespace

// indptr [n_rows + 1] (non-decreasing, indptr[n_rows] = nnz), cols and vals
// [nnz], x [n_x], y [n_rows]; carry (float) and cross (int) scratch of one
// word per 1,024 entries (at least one).
extern "C" int spmv_csr(const int* indptr, int n_rows, const int* cols,
                        const float* vals, int nnz, const float* x, int n_x,
                        float* y, float* carry, int* cross,
                        cudaStream_t stream) {
  if (n_rows > 0) {
    const int blocks = nnz > 0 ? (nnz + kE - 1) / kE : 1;
    spmv_csr_blocks<<<blocks, kThreads, 0, stream>>>(
        indptr, n_rows, cols, vals, nnz, x, n_x, y, carry, cross);
    if (blocks > 1)
      spmv_csr_fixup<<<(blocks + 255) / 256, 256, 0, stream>>>(
          indptr, carry, cross, blocks, y);
  }
  return static_cast<int>(cudaGetLastError());
}
