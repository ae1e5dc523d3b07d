// Flash attention (forward), grouped-query, for Hopper (sm_90a).
//
// Replaces src/repro/kernels/flash_attention/kernel.py::flash_attention_pallas
// (body _flash_kernel), the self-attention of the dense LM's prefill and
// decode steps:
//
//   o[b, i, h] = sum_j softmax_j(s_ij) v[b, j, g],  g = h / (H / KV),
//   s_ij = (q[b, i, h] . k[b, j, g]) * hd^-0.5, set to -1e30 where causal
//          and q_offset + i < j
//
// all in float32 with the online softmax (running max m, running sum l,
// rescaled accumulator) and o = acc / max(l, 1e-30), as the TPU kernel
// does. The TPU kernel walks the kv blocks as its sequential innermost grid
// axis and keeps m, l and acc in its output blocks; here the walk over keys
// is a loop inside the block, and the state lives in registers.
//
// Layout: a block of 8 warps owns one (batch, head) and `rows` query rows;
// each row is served by `splits` = 8 / rows warps, warp (r, s) taking the
// 32-key tiles s, s + splits, ... of each staged key block. The block
// stages 32 * splits keys of K (transposed) and V of the head's KV group in
// shared memory as float32, so each key tile is read from device memory
// once per block and served to all its warps; every thread issues all its
// 16-byte loads of a block before it converts and stores any, so a block
// costs one round trip to memory, not one per element. In a warp, lane j
// scores key j of the tile (the K^T row stride is odd, so the 32 lanes hit
// 32 banks), then the lanes own hd / 32 output dims each and add p_j * v_j
// with p_j
// broadcast by a shuffle. Prefill (Sq >= 8) takes 8 rows x 1 split: a
// staged tile serves 8 rows. Decode (Sq < 8) takes 1 row x 8 splits (hd 64)
// or 2 x 4 (hd 128), so B * H blocks of 8 busy warps cover the cache; the
// splits' (m, l, acc) are merged in shared memory at the end. GQA reads the
// KV head in place (no repeated K/V). Key blocks past the causal limit of
// the block's last row are never staged, tiles past a row's own limit never
// scored: their weights would be exp(-1e30 - m) = 0 exactly.
//
// What bounds it on this card: prefill is 4 * B * H * Sq * Sk * hd flops
// (about half of them past the causal limit and skipped), run here on the
// float32 CUDA cores, not the tensor cores, so the operation rate bounds
// it; decode reads the whole cache once (B * Sk * KV * hd * 2 tensors) for
// a few flops per byte, so bytes bound it. Tensor-core products (mma.sync /
// wgmma), TMA staging and a split-K decode across blocks are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 32;  // keys per warp tile: one per lane

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// the 16 / sizeof(T) values of one 16-byte load, as float32
__device__ __forceinline__ void unpack(const uint4& u, float* f, float) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float* f,
                                       __nv_bfloat16) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // little-endian: element 2i is the low half
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ float warp_max(float x) {
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// float32 words of shared memory for one launch: the query rows, K^T
// [HD][nb + 1] and V [nb][HD] of one staged block of nb = 32 * splits keys.
// The end-of-loop merge reuses the space (8 * (HD + 2) words, always less).
__host__ __device__ constexpr int smem_words(int hd, int splits) {
  return (kWarps / splits) * hd + hd * (kTile * splits + 1) +
         kTile * splits * hd;
}

template <typename T, int HD, int SPLITS>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o, int sq,
                           int sk, int n_heads, int n_kv, int causal,
                           int q_offset, float scale) {
  constexpr int kPer = HD / 32;  // output dims per lane
  constexpr int kRows = kWarps / SPLITS;
  constexpr int kNb = kTile * SPLITS;
  constexpr int kLdk = kNb + 1;  // odd: a column of K^T spans the banks
  // staging: 16-byte loads, all of a thread's issued before any is used,
  // so one block of keys costs one round trip to memory
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kRowVecs = HD / kVec;
  constexpr int kLoads = kNb * kRowVecs / kThreads;
  static_assert(kNb * kRowVecs % kThreads == 0, "staging tiles the block");
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* qs = smem;              // [kRows][HD]
  float* kt = qs + kRows * HD;   // [HD][kLdk]
  float* vs = kt + HD * kLdk;    // [kNb][HD]

  const int bh = blockIdx.x;
  const int b = bh / n_heads, h = bh % n_heads;
  const int g = h / (n_heads / n_kv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = warp / SPLITS, split = warp % SPLITS;
  const int i0 = blockIdx.y * kRows;
  const int i = i0 + r;
  const bool active = i < sq;
  const int q_pos = q_offset + i;

  for (int e = threadIdx.x; e < kRows * HD; e += kThreads) {
    const int ii = i0 + e / HD;
    qs[e] = ii < sq ? to_f32(q[(static_cast<size_t>(b) * sq + ii) * n_heads *
                                   HD + static_cast<size_t>(h) * HD + e % HD])
                    : 0.0f;
  }
  // keys any row of the block can see
  const int k_end =
      causal ? min(sk, q_offset + min(i0 + kRows, sq)) : sk;
  const size_t kv_row = static_cast<size_t>(n_kv) * HD;  // stride of a key
  const T* kb = k + static_cast<size_t>(b) * sk * kv_row +
                static_cast<size_t>(g) * HD;
  const T* vb = v + static_cast<size_t>(b) * sk * kv_row +
                static_cast<size_t>(g) * HD;
  const float4* q4 = reinterpret_cast<const float4*>(qs + r * HD);

  float m = -INFINITY, l = 0.0f, acc[kPer];
#pragma unroll
  for (int t = 0; t < kPer; ++t) acc[t] = 0.0f;

  // k_end is uniform over the block, so every thread reaches each barrier
  for (int k0 = 0; k0 < k_end; k0 += kNb) {
    uint4 kr[kLoads], vr[kLoads];
#pragma unroll
    for (int c = 0; c < kLoads; ++c) {
      const int e = threadIdx.x + c * kThreads;
      const int key = k0 + e / kRowVecs;
      const size_t off = key * kv_row + (e % kRowVecs) * kVec;
      const bool in = key < sk;
      kr[c] = in ? __ldg(reinterpret_cast<const uint4*>(kb + off))
                 : make_uint4(0, 0, 0, 0);
      vr[c] = in ? __ldg(reinterpret_cast<const uint4*>(vb + off))
                 : make_uint4(0, 0, 0, 0);
    }
    __syncthreads();  // the previous block's tiles are consumed
#pragma unroll
    for (int c = 0; c < kLoads; ++c) {
      const int e = threadIdx.x + c * kThreads;
      const int j = e / kRowVecs, d0 = (e % kRowVecs) * kVec;
      float f[kVec];
      unpack(kr[c], f, T());
#pragma unroll
      for (int x = 0; x < kVec; ++x) kt[(d0 + x) * kLdk + j] = f[x];
      unpack(vr[c], f, T());
#pragma unroll
      for (int x = 0; x < kVec; x += 4)
        *reinterpret_cast<float4*>(vs + j * HD + d0 + x) =
            make_float4(f[x], f[x + 1], f[x + 2], f[x + 3]);
    }
    __syncthreads();
    const int t0 = k0 + split * kTile;  // the warp's first key in the block
    // warp-uniform: a whole tile past the row's causal limit, or the keys
    if (!active || t0 >= sk || (causal && t0 > q_pos)) continue;
    const int jj = split * kTile + lane;
    const int key = t0 + lane;
    float s = 0.0f;
#pragma unroll 8
    for (int d4 = 0; d4 < HD / 4; ++d4) {
      const float4 qv = q4[d4];
      const float* kc = kt + 4 * d4 * kLdk + jj;
      s = fmaf(qv.x, kc[0], s);
      s = fmaf(qv.y, kc[kLdk], s);
      s = fmaf(qv.z, kc[2 * kLdk], s);
      s = fmaf(qv.w, kc[3 * kLdk], s);
    }
    s *= scale;
    if (causal && key > q_pos) s = -1e30f;
    const bool valid = key < sk;
    const float m_new = fmaxf(m, warp_max(valid ? s : -INFINITY));
    const float corr = expf(m - m_new);  // 0 on the first tile (m = -inf)
    const float p = valid ? expf(s - m_new) : 0.0f;
    l = l * corr + warp_sum(p);
    m = m_new;
#pragma unroll
    for (int t = 0; t < kPer; ++t) acc[t] *= corr;
    const int n = min(kTile, sk - t0);
    const float* vrow = vs + (split * kTile) * HD + lane;
    for (int j = 0; j < n; ++j) {
      const float pj = __shfl_sync(0xffffffffu, p, j);
#pragma unroll
      for (int t = 0; t < kPer; ++t)
        acc[t] = fmaf(pj, vrow[j * HD + 32 * t], acc[t]);
    }
  }

  if (SPLITS > 1) {  // merge the splits of each row
    __syncthreads();
    float* mine = smem + warp * (HD + 2);
#pragma unroll
    for (int t = 0; t < kPer; ++t) mine[lane + 32 * t] = acc[t];
    if (lane == 0) {
      mine[HD] = m;
      mine[HD + 1] = l;
    }
    __syncthreads();
    if (split != 0) return;
    // split 0 scored key 0, which every row sees: mx is finite
    float mx = -INFINITY;
    for (int s2 = 0; s2 < SPLITS; ++s2)
      mx = fmaxf(mx, smem[(warp + s2) * (HD + 2) + HD]);
    l = 0.0f;
#pragma unroll
    for (int t = 0; t < kPer; ++t) acc[t] = 0.0f;
    for (int s2 = 0; s2 < SPLITS; ++s2) {
      const float* st = smem + (warp + s2) * (HD + 2);
      const float w = expf(st[HD] - mx);  // 0 for a split that saw no key
      l += st[HD + 1] * w;
#pragma unroll
      for (int t = 0; t < kPer; ++t) acc[t] += st[lane + 32 * t] * w;
    }
  }
  if (!active) return;
  const float inv = 1.0f / fmaxf(l, 1e-30f);
  T* orow = o + (static_cast<size_t>(b) * sq + i) * n_heads * HD +
            static_cast<size_t>(h) * HD;
#pragma unroll
  for (int t = 0; t < kPer; ++t)
    orow[lane + 32 * t] = from_f32<T>(acc[t] * inv);
}

template <typename T, int HD, int SPLITS>
void launch_splits(const void* q, const void* k, const void* v, void* o,
                   int b, int sq, int sk, int n_heads, int n_kv, int causal,
                   int q_offset, cudaStream_t stream) {
  constexpr int kSmem = smem_words(HD, SPLITS) * 4;
  if (kSmem > 48 * 1024) {
    static bool attr_set = false;  // idempotent: a race only repeats it
    if (!attr_set) {
      cudaFuncSetAttribute(flash_attention_kernel<T, HD, SPLITS>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
      attr_set = true;
    }
  }
  constexpr int kRows = kWarps / SPLITS;
  const dim3 grid(b * n_heads, (sq + kRows - 1) / kRows);
  flash_attention_kernel<T, HD, SPLITS><<<grid, kThreads, kSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), sq, sk, n_heads, n_kv,
      causal, q_offset,
      static_cast<float>(1.0 / sqrt(static_cast<double>(HD))));
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int sq, int sk, int n_heads, int n_kv, int causal, int q_offset,
           cudaStream_t stream) {
  constexpr int kMaxSplits = HD <= 64 ? 8 : 4;  // shared memory <= 133 KB
  if (sq < kWarps)
    launch_splits<T, HD, kMaxSplits>(q, k, v, o, b, sq, sk, n_heads, n_kv,
                                     causal, q_offset, stream);
  else
    launch_splits<T, HD, 1>(q, k, v, o, b, sq, sk, n_heads, n_kv, causal,
                            q_offset, stream);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [b, sq, n_heads, hd], k and v [b, sk, n_kv, hd], o like q; contiguous,
// one dtype: bf16 (is_bf16 = 1) or float32. hd is 64 or 128 (anything else
// returns cudaErrorInvalidValue; the wrapper refuses it first).
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, int b, int sq, int sk, int n_heads,
                               int n_kv, int hd, int causal, int q_offset,
                               int is_bf16, cudaStream_t stream) {
  if (b == 0 || sq == 0) return static_cast<int>(cudaGetLastError());
  if (hd == 64)
    return is_bf16 ? launch<__nv_bfloat16, 64>(q, k, v, o, b, sq, sk, n_heads,
                                               n_kv, causal, q_offset, stream)
                   : launch<float, 64>(q, k, v, o, b, sq, sk, n_heads, n_kv,
                                       causal, q_offset, stream);
  if (hd == 128)
    return is_bf16 ? launch<__nv_bfloat16, 128>(q, k, v, o, b, sq, sk,
                                                n_heads, n_kv, causal,
                                                q_offset, stream)
                   : launch<float, 128>(q, k, v, o, b, sq, sk, n_heads, n_kv,
                                        causal, q_offset, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
