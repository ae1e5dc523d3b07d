// Per-row strict self-rank, and the row merge the fused point read applies
// it as, for Hopper (sm_90a).
//
// Replaces src/repro/kernels/merge_rank/kernel.py::row_rank_pallas (body
// _row_rank_kernel):
//
//   row_rank:   o[i, j] = #{ k : keys[i, k] < keys[i, j] }
//
// and the function that rank serves there, merge_combine_rows
// (src/repro/kernels/merge_rank/ops.py), which applies it to the row as a
// one-hot contraction:
//
//   row_merge:  out_k[i, o[i, j]] = keys[i, j], out_v[i, o[i, j]] = vals[i, j]
//               for every valid key (!= I32_MAX); I32_MAX and a zero value
//               in slots [n_valid, W)
//
// A row is the concatenation of K sorted candidate segments of the fused
// point read, so it is NOT sorted and the quadratic count is the right
// algorithm. row_merge's precondition: valid keys are unique within a row,
// so their ranks are a permutation of [0, n_valid) (pads may sit anywhere,
// also inside a segment).
//
// What bounds it on the card: Q * W^2 integer compares (W <= 256 on the
// read path) against Q * W * 8 bytes of traffic (16 for the merge, which
// moves float32 or int32 values); at the read path's
// shapes ([512, 8..128], [8, 16..256]) every launch is latency. So the
// launch fits the shape: a row of W <= 32 keys goes to one warp, eight rows
// to a block, and counts by shuffles; a wider row goes to one block that
// stages it in shared memory, one thread per key reading 4 keys to a
// shared-memory load. (Splitting a key's compares over 4 to 8 threads with a
// shuffle reduce measured no faster at [8, 128..256] on an H100, and 20%
// slower at [512, 128]: the blocks' fixed latency, not the compares, sets
// the time.) Both entry points share the counting; they differ only in the
// write-out, and the merge loads each key's value before it counts.
#include <cuda_runtime.h>

namespace {

constexpr int kI32Max = 0x7fffffff;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpRows = 8;   // rows per block on the warp route
constexpr int kTile = 2048;    // keys staged in shared memory per round
constexpr int kMaxThreads = 1024;

// The write-out of key j of a row: its rank (row_rank), or the key and its
// value at slot `rank` of the merged row (row_merge; pads write nothing
// here: fill_slot writes slots [n_valid, W)).
template <bool kMerge, typename V>
__device__ __forceinline__ void emit(int j, int key, int rank, V val,
                                     int* orow, V* ovrow) {
  if (!kMerge) {
    orow[j] = rank;
  } else if (key != kI32Max) {
    orow[rank] = key;
    ovrow[rank] = val;
  }
}

template <bool kMerge, typename V>
__device__ __forceinline__ void fill_slot(int s, int* orow, V* ovrow) {
  if (kMerge) {
    orow[s] = kI32Max;
    ovrow[s] = V(0);
  }
}

// W <= 32: one warp per row, lane j holds key j.
template <bool kMerge, typename V>
__global__ void __launch_bounds__(32 * kWarpRows)
    row_warp_kernel(const int* __restrict__ keys, const V* __restrict__ vals,
                    int n_rows, int width, int* __restrict__ out,
                    V* __restrict__ out_v) {
  const int row = blockIdx.x * kWarpRows + threadIdx.x / 32;
  if (row >= n_rows) return;  // the whole warp
  const int lane = threadIdx.x & 31;
  const size_t base = static_cast<size_t>(row) * width;
  const bool in = lane < width;
  const int mine = in ? keys[base + lane] : kI32Max;
  const V val = kMerge && in ? vals[base + lane] : V(0);
  int rank = 0;
  for (int t = 0; t < width; ++t) rank += __shfl_sync(kFull, mine, t) < mine;
  const int n_valid = __popc(__ballot_sync(kFull, in && mine != kI32Max));
  V* const ovrow = kMerge ? out_v + base : out_v;
  if (in) {
    emit<kMerge>(lane, mine, rank, val, out + base, ovrow);
    if (lane >= n_valid) fill_slot<kMerge>(lane, out + base, ovrow);
  }
}

// Stages keys [t0, t0 + n) of the row into the tile, padded with I32_MAX
// (which no key counts) to a multiple of 4, and returns how many of the n
// are valid. Every thread of the block calls it; it ends on a barrier.
__device__ int stage(int* tile, const int* row, int t0, int n) {
  const int padded = (n + 3) & ~3;
  int valid = 0;
  for (int s0 = 0; s0 < padded; s0 += blockDim.x) {
    const int s = s0 + threadIdx.x;
    const int k = s < n ? row[t0 + s] : kI32Max;
    if (s < padded) tile[s] = k;
    valid += __syncthreads_count(s < n && k != kI32Max);
  }
  return valid;
}

// W > 32: one block per row, one thread per key (in passes of up to 1,024
// keys); a thread counts the staged keys 4 at a time, one 16-byte
// shared-memory load each, a broadcast to the whole warp. Every loop bound
// is uniform across the block, so all threads reach the barriers.
template <bool kMerge, typename V>
__global__ void __launch_bounds__(kMaxThreads)
    row_block_kernel(const int* __restrict__ keys, const V* __restrict__ vals,
                     int width, int* __restrict__ out,
                     V* __restrict__ out_v) {
  __shared__ int4 tile4[kTile / 4];
  int* const tile = reinterpret_cast<int*>(tile4);
  const size_t base = static_cast<size_t>(blockIdx.x) * width;
  const int* row = keys + base;
  V* const ovrow = kMerge ? out_v + base : out_v;
  const bool staged = width <= kTile;  // the whole row in one stage
  // the first pass's values are loaded before the stage, beside its keys
  int j = threadIdx.x;
  V val = kMerge && j < width ? vals[base + j] : V(0);
  int n_valid = staged ? stage(tile, row, 0, width) : 0;
  for (int j0 = 0; j0 < width; j0 += blockDim.x) {
    j = j0 + threadIdx.x;
    if (j0 > 0 && kMerge && j < width) val = vals[base + j];
    const int mine = j < width ? (staged ? tile[j] : row[j]) : 0;
    int r0 = 0, r1 = 0, r2 = 0, r3 = 0;  // four short add chains, not one
    for (int t0 = 0; t0 < width; t0 += kTile) {
      const int n = min(kTile, width - t0);
      if (!staged) {
        __syncthreads();  // the previous tile's readers are done
        const int valid = stage(tile, row, t0, n);
        if (j0 == 0) n_valid += valid;
      }
      const int n4 = (n + 3) >> 2;
#pragma unroll 4
      for (int t = 0; t < n4; ++t) {
        const int4 k = tile4[t];
        r0 += k.x < mine;
        r1 += k.y < mine;
        r2 += k.z < mine;
        r3 += k.w < mine;
      }
    }
    if (j < width)
      emit<kMerge>(j, mine, r0 + r1 + r2 + r3, val, out + base, ovrow);
  }
  if (kMerge)
    for (int s = n_valid + threadIdx.x; s < width; s += blockDim.x)
      fill_slot<kMerge>(s, out + base, ovrow);
}

template <bool kMerge, typename V>
void launch_rows(const int* keys, const V* vals, int n_rows, int width,
                 int* out, V* out_v, cudaStream_t stream) {
  if (width <= 32) {
    const int blocks = (n_rows + kWarpRows - 1) / kWarpRows;
    row_warp_kernel<kMerge, V><<<blocks, 32 * kWarpRows, 0, stream>>>(
        keys, vals, n_rows, width, out, out_v);
    return;
  }
  const int threads =
      width >= kMaxThreads ? kMaxThreads : (width + 31) / 32 * 32;
  row_block_kernel<kMerge, V><<<n_rows, threads, 0, stream>>>(
      keys, vals, width, out, out_v);
}

}  // namespace

extern "C" int row_rank(const int* keys, int n_rows, int width, int* out,
                        cudaStream_t stream) {
  if (n_rows > 0 && width > 0)
    launch_rows<false, int>(keys, nullptr, n_rows, width, out, nullptr,
                            stream);
  return static_cast<int>(cudaGetLastError());
}

// vals and out_v hold 4-byte values (float32 or int32), moved as bits.
extern "C" int row_merge(const int* keys, const void* vals, int n_rows,
                         int width, int* out_k, void* out_v,
                         cudaStream_t stream) {
  if (n_rows > 0 && width > 0)
    launch_rows<true, unsigned>(keys, static_cast<const unsigned*>(vals),
                                n_rows, width, out_k,
                                static_cast<unsigned*>(out_v), stream);
  return static_cast<int>(cudaGetLastError());
}
