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
// multiply-adds, the wrong shape for this card. What bounds a scatter-add
// here: the 8 bytes read per entry, and the L2 atomic units where many
// entries hit one address. Graph500 ids are power-law: the hottest vertex
// of a scale-16 graph takes ~13k of 1M entries, and one global atomicAdd
// per entry (the direct kernel below, kept as the yardstick) serialises
// them all on one address.
//
// The privatised kernel: the segments are cut into slabs that fit a block's
// shared memory (at most 32,768 bins, 128 KB), and the entries into one
// chunk per resident block and slab. A block zeroes its slab, reads its
// chunk (16-byte loads where both arrays are aligned, 16 entries a thread in
// flight), adds the entries that fall in its slab with shared-memory
// atomics, and after a barrier adds each bin it holds a non-zero sum for to
// the output with one global atomic. The hottest address then takes at most
// one global atomic per chunk; each slab past the first reads the chunk
// again, from L2. Hopper has no native float atomic add on shared memory (it
// loops on compare-and-swap, and a run of equal ids retries it up to
// 32-fold: on an H100, 1M sorted Graph500 ids took 0.33 ms this way, 0.015
// ms with int32 atomics), while its int32 shared atomics are native. So
// while a block's values are integers small enough that its sums cannot
// wrap (degree counts), it sums them as int32, exactly, and converts each
// bin once at the flush; from the first tile with a value that is not, it
// sums float32. A bin whose sum is exactly 0 is skipped: that changes at
// most the sign of a zero. Sums reach the output in no fixed order: exact
// for integer-valued inputs below 2^24, and within float32 rounding of the
// ordered sum otherwise.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kDirectThreads = 256;
constexpr int kThreads = 1024;
constexpr int kSlabMax = 32768;          // bins per slab: 128 KB of float32
constexpr int kGroups = 4;               // 4-entry groups a thread loads
constexpr int kMinChunk = 4 * kThreads;  // entries per block, at least

// One thread per entry, one global atomicAdd (a fire-and-forget RED) each.
__global__ void segment_sum_direct_kernel(const int* __restrict__ ids,
                                          const float* __restrict__ vals,
                                          int n, int n_segments,
                                          float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int s = ids[i];
  if (s >= 0 && s < n_segments) atomicAdd(out + s, vals[i]);
}

// Adds v to the slab's bin of id, if id falls in [s0, s0 + width): the
// unsigned difference also sends every negative id past the slab. kInt adds
// v as an int32 into bins that hold int32 sums.
template <bool kInt>
__device__ __forceinline__ void add_local(float* bins, int id, float v,
                                          int s0, int width) {
  const unsigned local = static_cast<unsigned>(id) - static_cast<unsigned>(s0);
  if (local < static_cast<unsigned>(width)) {
    if (kInt)
      atomicAdd(reinterpret_cast<int*>(bins) + local, static_cast<int>(v));
    else
      atomicAdd(bins + local, v);
  }
}

// Loads the 4 entries at e (ids past end read as -1: dropped); with kVec,
// e is a multiple of 4 and both arrays are 16-byte aligned.
template <bool kVec>
__device__ __forceinline__ void load4(const int* __restrict__ ids,
                                      const float* __restrict__ vals, int e,
                                      int end, int4& i, float4& v) {
  if (kVec && e + 4 <= end) {
    i = *reinterpret_cast<const int4*>(ids + e);
    v = *reinterpret_cast<const float4*>(vals + e);
    return;
  }
  i = make_int4(-1, -1, -1, -1);
  v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (e < end) i.x = ids[e], v.x = vals[e];
  if (e + 1 < end) i.y = ids[e + 1], v.y = vals[e + 1];
  if (e + 2 < end) i.z = ids[e + 2], v.z = vals[e + 2];
  if (e + 3 < end) i.w = ids[e + 3], v.w = vals[e + 3];
}

__device__ __forceinline__ bool integral(float v, float limit) {
  return v == truncf(v) && fabsf(v) <= limit;  // false for NaN and inf
}

template <bool kInt>
__device__ __forceinline__ void add4(float* bins, const int4& i,
                                     const float4& v, int s0, int width) {
  add_local<kInt>(bins, i.x, v.x, s0, width);
  add_local<kInt>(bins, i.y, v.y, s0, width);
  add_local<kInt>(bins, i.z, v.z, s0, width);
  add_local<kInt>(bins, i.w, v.w, s0, width);
}

// Block b takes chunk b / slabs of the entries and slab b % slabs of the
// segments, so the blocks that read one chunk run side by side and all but
// the first find it in L2. The chunk goes through in tiles of kGroups x 4
// entries a thread, all loaded before any is added. The bins hold int32
// sums while every value so far is an integer of at most int_limit in
// magnitude (exact: int_limit * chunk < 2^31); at the first tile that
// breaks this, the block converts its bins to float32 and goes on in
// float32.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    segment_sum_slab_kernel(const int* __restrict__ ids,
                            const float* __restrict__ vals, int n,
                            int n_segments, int slabs, int slab, int chunk,
                            int int_limit, float* __restrict__ out) {
  extern __shared__ float bins[];
  int* const ibins = reinterpret_cast<int*>(bins);
  const int s0 = (blockIdx.x % slabs) * slab;
  const int width = min(slab, n_segments - s0);
  for (int b = threadIdx.x; b < width; b += kThreads) ibins[b] = 0;
  const int begin = (blockIdx.x / slabs) * chunk;  // < n: chunks cover n
  const int end = static_cast<int>(
      min(static_cast<long long>(n), static_cast<long long>(begin) + chunk));
  const float limit = static_cast<float>(int_limit);
  bool as_int = true;  // uniform across the block
  for (int t0 = begin; t0 < end; t0 += kThreads * 4 * kGroups) {
    int4 i[kGroups];
    float4 v[kGroups];
    bool ok = true;
#pragma unroll
    for (int k = 0; k < kGroups; ++k) {
      load4<kVec>(ids, vals, t0 + 4 * (threadIdx.x + k * kThreads), end,
                  i[k], v[k]);
      ok = ok && integral(v[k].x, limit) && integral(v[k].y, limit) &&
           integral(v[k].z, limit) && integral(v[k].w, limit);
    }
    if (as_int) {
      // a barrier either way: the zeroing, or the last tile's adds, are done
      as_int = __syncthreads_and(ok);
      if (!as_int) {
        for (int b = threadIdx.x; b < width; b += kThreads)
          bins[b] = static_cast<float>(ibins[b]);
        __syncthreads();
      }
    }
    if (as_int) {
#pragma unroll
      for (int k = 0; k < kGroups; ++k) add4<true>(bins, i[k], v[k], s0, width);
    } else {
#pragma unroll
      for (int k = 0; k < kGroups; ++k)
        add4<false>(bins, i[k], v[k], s0, width);
    }
  }
  __syncthreads();
  for (int b = threadIdx.x; b < width; b += kThreads) {
    const float x = as_int ? static_cast<float>(ibins[b]) : bins[b];
    if (x != 0.f) atomicAdd(out + s0 + b, x);
  }
}

void launch_privatised(const int* ids, const float* vals, int n,
                       int n_segments, float* out, cudaStream_t stream) {
  const int slabs = (n_segments + kSlabMax - 1) / kSlabMax;
  const int slab = (n_segments + slabs - 1) / slabs;
  const int smem = slab * static_cast<int>(sizeof(float));
  const bool vec = ((reinterpret_cast<std::uintptr_t>(ids) |
                     reinterpret_cast<std::uintptr_t>(vals)) & 15) == 0;
  auto kernel = vec ? segment_sum_slab_kernel<true>
                    : segment_sum_slab_kernel<false>;
  if (smem > 48 * 1024)  // idempotent: a race only repeats it
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem);
  // one chunk per resident block and slab: a single wave over the card
  int dev = 0, sms = 1, per_sm = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                smem);
  const long long resident = static_cast<long long>(per_sm > 0 ? per_sm : 1)
                             * sms;
  long long chunks = resident / slabs;
  const long long most = (static_cast<long long>(n) + kMinChunk - 1)
                         / kMinChunk;
  if (chunks > most) chunks = most;
  if (chunks < 1) chunks = 1;
  // chunks start on multiples of 4 entries (the 16-byte loads)
  const long long chunk = ((n + chunks - 1) / chunks + 3) / 4 * 4;
  chunks = (n + chunk - 1) / chunk;
  const long long int_limit = 2147483647LL / chunk;  // int32 sums can't wrap
  kernel<<<static_cast<unsigned>(chunks * slabs), kThreads, smem, stream>>>(
      ids, vals, n, n_segments, slabs, slab, static_cast<int>(chunk),
      static_cast<int>(int_limit < (1 << 24) ? int_limit : (1 << 24)), out);
}

}  // namespace

// direct != 0 runs the one-atomic-per-entry kernel (the design before the
// privatised one, kept as its yardstick); out must hold zeros.
extern "C" int segment_sum(const int* ids, const float* vals, int n,
                           int n_segments, int direct, float* out,
                           cudaStream_t stream) {
  if (n > 0 && n_segments > 0) {
    if (direct) {
      const int blocks = (n + kDirectThreads - 1) / kDirectThreads;
      segment_sum_direct_kernel<<<blocks, kDirectThreads, 0, stream>>>(
          ids, vals, n, n_segments, out);
    } else {
      launch_privatised(ids, vals, n, n_segments, out, stream);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
