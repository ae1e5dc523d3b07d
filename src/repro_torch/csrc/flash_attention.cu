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
// is a loop inside a block (or, in decode, spread over blocks and merged),
// and the state lives in registers. GQA reads the KV head in place; key
// tiles past the causal limit of a block's last row are never staged (their
// weights would be exp(-1e30 - m) = 0 exactly). Three bodies:
//
// 1. bf16 prefill (Sq >= 16), tensor cores. Bounded by operations: 4 * hd
//    flops per (row, key) pair the mask keeps, at the bf16 tensor rate. A
//    block of 4 warps owns 64 rows of one KV group: the rep = H / KV query
//    heads of the group stacked position-major (row = i * rep + r), so one
//    staged K/V tile serves every head that reads it. Each warp owns 16 rows
//    and walks 64-key tiles: S = Q K^T with mma.sync m16n8k16 (bf16 in, f32
//    sums; operands by ldmatrix from rows padded by 16 bytes, so the 8 rows
//    of a matrix hit 8 different bank groups), the online softmax on the
//    f32 accumulator (the causal mask only on the tiles that reach past the
//    warp's first row), then O += P V. The TPU kernel keeps P in float32,
//    and a single bf16 P would round it to 8 bits; so P is split as
//    P_hi = bf16(P), P_lo = bf16(P - P_hi) and both go through the tensor
//    cores into the same f32 accumulator (about 16 bits of P kept, 1.5x the
//    tensor work of a bf16 P). K and V tiles are staged with cp.async into
//    two buffers: the next tile loads while this one is used. Blocks of
//    later rows (more keys under the causal mask) are scheduled first. On
//    the H100 the staging itself costs about half the time at the serving
//    prefill: every 64-row block reads each K/V tile from L2 again.
// 2. decode (Sq < 16), both dtypes, split-K: bounded by bytes (the cache
//    is read once for a few flops per byte), and one block per (batch,
//    head) would leave most of the 132 SMs idle. The grid is (groups x row
//    blocks of 16, splits): a block takes all rep heads' rows of a KV group
//    (so each K/V element is read from memory once, not rep times) and a
//    run of 64-key tiles up to the causal limit, the next tile's loads in
//    flight while this one is used; a warp takes a row, lane j scores keys
//    j and j + 32 against K^T in shared memory and owns hd / 32 output
//    dims, the weights shared through shared memory. The wrapper picks the
//    splits: one per tile until the grid has ~512 blocks, none for a cache
//    of at most 4 tiles. Each split writes its f32 (acc[hd], m, l) per row
//    to a scratch the wrapper allocates, and a second small kernel merges
//    them, all its loads issued at once: m = max m_s,
//    l = sum l_s e^(m_s - m), o = sum acc_s e^(m_s - m) / max(l, 1e-30).
//    Both kernels launch from the one entry point below.
// 3. float32 prefill (Sq >= 16) on the CUDA cores (TF32 would be another
//    result): a block of 8 warps owns one (batch, head) and 8 query rows;
//    32-key tiles of K (transposed) and V staged as float32, lane j scores
//    key j, lanes own hd / 32 output dims each.
// wgmma and TMA (bigger row blocks, tiles multicast to a cluster) are the
// next redesign of body 1.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16(x);
}

// the 16 / sizeof(T) values of one 16-byte load, as float32
__device__ __forceinline__ void unpack(const uint4& u, float* f, float) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float* f, bf16) {
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

template <typename Kernel>
void allow_smem(Kernel kernel, int bytes) {
  if (bytes > 48 * 1024)  // idempotent: a race only repeats it
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         bytes);
}

// ------------------------------------------- 1. bf16 prefill, tensor cores
constexpr int kTcKeys = 64;      // keys per staged tile
constexpr int kTcRows = 64;      // query rows per block: 16 per warp
constexpr int kTcThreads = 128;

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = in ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// c (16 x 8, f32) += a (16 x 16, bf16, row-major) * b (16 x 8, bf16)
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm(  // not volatile: the compiler may interleave independent products
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

__device__ __forceinline__ float ex2(float x) {  // 2^x; 2^-inf = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int HD>  // bf16 elements of one smem row, padded by 16 bytes
__host__ __device__ constexpr int tc_ld() { return HD + 8; }
template <int HD>  // Q [64], K [2][64] and V [2][64] padded rows of bf16
__host__ __device__ constexpr int tc_smem_bytes() {
  return (kTcRows + 4 * kTcKeys) * tc_ld<HD>() * 2;
}

template <int HD>
__global__ void __launch_bounds__(kTcThreads)
    flash_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ o, int sq,
                    int sk, int n_heads, int n_kv, int causal, int q_offset,
                    float scale_log2) {
  constexpr int kLd = tc_ld<HD>();
  constexpr int kChunks = HD / 8;  // 16-byte chunks of a row
  constexpr int kD = HD / 16;      // k-steps of Q K^T, and dim pairs of P V
  constexpr int kN = kTcKeys / 8;  // 8-key column tiles of S
  extern __shared__ uint4 smem_tc[];
  bf16* qs = reinterpret_cast<bf16*>(smem_tc);  // [64][kLd]
  bf16* ks = qs + kTcRows * kLd;                // [2][64][kLd]
  bf16* vs = ks + 2 * kTcKeys * kLd;            // [2][64][kLd]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rep = n_heads / n_kv;
  const int n_rows = sq * rep;
  const int rho0 = (gridDim.x - 1 - blockIdx.x) * kTcRows;  // late rows first
  const int b = blockIdx.y / n_kv, g = blockIdx.y % n_kv;
  const size_t kv_row = static_cast<size_t>(n_kv) * HD;  // stride of a key
  const bf16* kb = k + static_cast<size_t>(b) * sk * kv_row + g * HD;
  const bf16* vb = v + static_cast<size_t>(b) * sk * kv_row + g * HD;

  for (int c = tid; c < kTcRows * kChunks; c += kTcThreads) {
    const int rr = c / kChunks, ch = c % kChunks, rho = rho0 + rr;
    const bool in = rho < n_rows;
    const bf16* src =
        in ? q + (static_cast<size_t>(b) * sq + rho / rep) * n_heads * HD +
                 static_cast<size_t>(g * rep + rho % rep) * HD + ch * 8
           : q;
    cp_async16(qs + rr * kLd + ch * 8, src, in);
  }
  const int last_row = min(rho0 + kTcRows, n_rows) - 1;
  const int key_end = causal ? min(sk, q_offset + last_row / rep + 1) : sk;
  const int n_tiles = (key_end + kTcKeys - 1) / kTcKeys;
  auto stage = [&](int t, int buf) {
    for (int c = tid; c < kTcKeys * kChunks; c += kTcThreads) {
      const int j = c / kChunks, ch = c % kChunks, key = t * kTcKeys + j;
      const bool in = key < sk;
      const size_t off = in ? key * kv_row + ch * 8 : 0;
      const int dst = (buf * kTcKeys + j) * kLd + ch * 8;
      cp_async16(ks + dst, kb + off, in);
      cp_async16(vs + dst, vb + off, in);
    }
  };
  stage(0, 0);
  cp_async_commit();

  // the thread's rows: w0 + lane / 4 (h = 0) and + 8 (h = 1)
  const int w0 = rho0 + warp * 16;
  const int pos[2] = {q_offset + (w0 + (lane >> 2)) / rep,
                      q_offset + (w0 + (lane >> 2) + 8) / rep};
  const int warp_first = q_offset + min(w0, n_rows - 1) / rep;
  const int warp_last =  // the warp's last position: later tiles are unseen
      q_offset + (min(w0 + 16, n_rows) - 1) / rep;
  uint32_t qf[kD][4];
  float acc[2 * kD][4];
#pragma unroll
  for (int n = 0; n < 2 * kD; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) stage(t + 1, (t + 1) & 1);
    cp_async_commit();  // (empty past the last tile)
    cp_async_wait<1>();  // Q and tile t have landed
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int d = 0; d < kD; ++d)
        ldmatrix_x4(qf[d], qs + (warp * 16 + (lane & 7) +
                                 8 * ((lane >> 3) & 1)) * kLd +
                               d * 16 + 8 * (lane >> 4));
    }
    const int k0 = t * kTcKeys;
    // warp-uniform: a tile wholly past the warp's causal limit adds 0
    if (!causal || k0 <= warp_last) {
      const bf16* kt = ks + (t & 1) * kTcKeys * kLd;
      const bf16* vt = vs + (t & 1) * kTcKeys * kLd;
      float s[kN][4];
#pragma unroll
      for (int n = 0; n < kN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
#pragma unroll
      for (int d = 0; d < kD; ++d)
#pragma unroll
        for (int np = 0; np < kN / 2; ++np) {
          uint32_t bk[4];
          ldmatrix_x4(bk, kt + (np * 16 + (lane & 7) + 8 * (lane >> 4)) * kLd +
                              d * 16 + 8 * ((lane >> 3) & 1));
          mma_bf16(s[2 * np], qf[d], bk[0], bk[1]);
          mma_bf16(s[2 * np + 1], qf[d], bk[2], bk[3]);
        }
      // the online softmax of both rows on the raw scores q . k (a masked
      // key weighs 2^-inf = 0, as exp(-1e30 - m) does; key 0 is never
      // masked, so m is finite from the first tile on), with
      // p = 2^((s - m) * scale * log2 e) as one fused multiply-add. The
      // mask is needed only where the tile reaches past the warp's first
      // position or past the cache (warp-uniform).
      const bool masked = (causal && k0 + kTcKeys - 1 > warp_first) ||
                          k0 + kTcKeys > sk;
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int n = 0; n < kN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (masked) {
            const int key = k0 + n * 8 + 2 * (lane & 3) + (e & 1);
            if ((causal && key > pos[e >> 1]) || key >= sk)
              s[n][e] = -INFINITY;
          }
          mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
        }
      float corr[2], ms[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        corr[h] = ex2((m[h] - mx[h]) * scale_log2);  // 0 on the first tile
        m[h] = mx[h];
        ms[h] = -mx[h] * scale_log2;
        l[h] *= corr[h];
      }
#pragma unroll
      for (int n = 0; n < 2 * kD; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] *= corr[e >> 1];
#pragma unroll
      for (int n = 0; n < kN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[n][e] = ex2(fmaf(s[n][e], scale_log2, ms[e >> 1]));
          l[e >> 1] += s[n][e];
        }
      // O += P V over 16-key steps, P as hi + lo bf16 parts
#pragma unroll
      for (int kk = 0; kk < kN / 2; ++kk) {
        uint32_t ph[4], pl[4];
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          // A fragment order: (row a, keys 2c..), (row b, ..), (row a,
          // keys 8 + 2c..), (row b, ..)
          const float* p = s[2 * kk + (x >> 1)];
          const float lo = p[(x & 1) * 2], hi = p[(x & 1) * 2 + 1];
          ph[x] = pack_bf16(lo, hi);
          const __nv_bfloat162 hb =
              *reinterpret_cast<const __nv_bfloat162*>(&ph[x]);
          pl[x] = pack_bf16(lo - __low2float(hb), hi - __high2float(hb));
        }
        uint32_t bv[kD][4];
#pragma unroll
        for (int dn = 0; dn < kD; ++dn)
          ldmatrix_x4_trans(bv[dn], vt + (kk * 16 + (lane & 7) +
                                          8 * ((lane >> 3) & 1)) * kLd +
                                        dn * 16 + 8 * (lane >> 4));
        // the hi products of every dim tile, then the lo ones: the two
        // products into one accumulator are 2 * kD products apart
#pragma unroll
        for (int part = 0; part < 2; ++part)
#pragma unroll
          for (int dn = 0; dn < kD; ++dn) {
            const uint32_t* pa = part ? pl : ph;
            mma_bf16(acc[2 * dn], pa, bv[dn][0], bv[dn][1]);
            mma_bf16(acc[2 * dn + 1], pa, bv[dn][2], bv[dn][3]);
          }
      }
    }
    __syncthreads();  // tile t's buffers are free for tile t + 2
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float lh = l[h];
    lh += __shfl_xor_sync(0xffffffffu, lh, 1);
    lh += __shfl_xor_sync(0xffffffffu, lh, 2);
    const float inv = 1.0f / fmaxf(lh, 1e-30f);
    const int rho = w0 + (lane >> 2) + 8 * h;
    if (rho >= n_rows) continue;
    bf16* orow = o + (static_cast<size_t>(b) * sq + rho / rep) * n_heads * HD +
                 static_cast<size_t>(g * rep + rho % rep) * HD + 2 * (lane & 3);
#pragma unroll
    for (int n = 0; n < 2 * kD; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8) = __floats2bfloat162_rn(
          acc[n][2 * h] * inv, acc[n][2 * h + 1] * inv);
  }
}

// ------------------------------------------------- 2. decode, split-K
constexpr int kDecThreads = 256;
constexpr int kDecWarps = kDecThreads / 32;
constexpr int kDecRows = 16;  // rows per block: 2 per warp
constexpr int kDecKeys = 64;  // keys per staged tile: 2 per lane

// float32 words of shared memory: the rows' queries, K^T [HD][65], V [64][HD]
// and each warp's 64 weights
__host__ __device__ constexpr int dec_smem_words(int hd) {
  return kDecRows * hd + hd * (kDecKeys + 1) + kDecKeys * hd +
         kDecWarps * kDecKeys;
}

// grid (groups x row blocks, splits). Split s takes the 64-key tiles
// [s * per, (s + 1) * per) below key_end and writes, for each of its rows,
// acc[HD], m, l to ws[((group * splits + s) * n_rows + row) * (HD + 2)];
// with one split it writes o itself.
template <typename T, int HD>
__global__ void __launch_bounds__(kDecThreads)
    flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, T* __restrict__ o,
                        float* __restrict__ ws, int sq, int sk, int n_heads,
                        int n_kv, int causal, int q_offset, float scale,
                        int key_end, int per) {
  constexpr int kPer = HD / 32;  // output dims per lane
  constexpr int kLdk = kDecKeys + 1;  // odd: a column of K^T spans the banks
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kRowVecs = HD / kVec;
  constexpr int kLoads = kDecKeys * kRowVecs / kDecThreads;
  static_assert(kDecKeys * kRowVecs % kDecThreads == 0, "staging tiles");
  extern __shared__ float4 smem_dec[];
  float* qs = reinterpret_cast<float*>(smem_dec);  // [16][HD]
  float* kt = qs + kDecRows * HD;                  // [HD][kLdk]
  float* vs = kt + HD * kLdk;                      // [64][HD]
  float* ps = vs + kDecKeys * HD;                  // [warps][64]

  const int rep = n_heads / n_kv;
  const int n_rows = sq * rep;
  const int row_blocks = (n_rows + kDecRows - 1) / kDecRows;
  const int group = blockIdx.x / row_blocks;
  const int rho0 = (blockIdx.x % row_blocks) * kDecRows;
  const int b = group / n_kv, g = group % n_kv;
  const int split = blockIdx.y, splits = gridDim.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* pw = ps + warp * kDecKeys;

  const size_t kv_row = static_cast<size_t>(n_kv) * HD;
  const T* kb = k + static_cast<size_t>(b) * sk * kv_row + g * HD;
  const T* vb = v + static_cast<size_t>(b) * sk * kv_row + g * HD;
  uint4 kr[kLoads], vr[kLoads];
  auto fetch = [&](int k0) {  // one tile's 16-byte loads, all issued at once
#pragma unroll
    for (int c = 0; c < kLoads; ++c) {
      const int e = threadIdx.x + c * kDecThreads;
      const int key = k0 + e / kRowVecs;
      const size_t off = key * kv_row + (e % kRowVecs) * kVec;
      const bool in = key < sk;
      kr[c] = in ? __ldg(reinterpret_cast<const uint4*>(kb + off))
                 : make_uint4(0, 0, 0, 0);
      vr[c] = in ? __ldg(reinterpret_cast<const uint4*>(vb + off))
                 : make_uint4(0, 0, 0, 0);
    }
  };
  const int k_lo = split * per * kDecKeys;
  const int k_hi = min(key_end, k_lo + per * kDecKeys);
  if (k_lo < k_hi) fetch(k_lo);

  for (int e = threadIdx.x; e < kDecRows * HD; e += kDecThreads) {
    const int rho = rho0 + e / HD;
    qs[e] = rho < n_rows
                ? to_f32(q[(static_cast<size_t>(b) * sq + rho / rep) *
                               n_heads * HD +
                           static_cast<size_t>(g * rep + rho % rep) * HD +
                           e % HD])
                : 0.0f;
  }
  float m[2], l[2], acc[2][kPer];
  int pos[2];
  bool live[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int rho = rho0 + warp + kDecWarps * u;
    live[u] = rho < n_rows;
    pos[u] = q_offset + rho / rep;
    m[u] = -INFINITY;
    l[u] = 0.0f;
#pragma unroll
    for (int t = 0; t < kPer; ++t) acc[u][t] = 0.0f;
  }
  for (int k0 = k_lo; k0 < k_hi; k0 += kDecKeys) {  // uniform over the block
    __syncthreads();  // the previous tile is consumed
#pragma unroll
    for (int c = 0; c < kLoads; ++c) {
      const int e = threadIdx.x + c * kDecThreads;
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
    if (k0 + kDecKeys < k_hi) fetch(k0 + kDecKeys);  // lands during the math
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      // warp-uniform: the row, or a tile wholly past its causal limit
      if (!live[u] || (causal && k0 > pos[u])) continue;
      const float* qrow = qs + (warp + kDecWarps * u) * HD;
      float s[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};  // two chains per key
#pragma unroll 8
      for (int d = 0; d < HD; d += 2) {
        const float q0 = qrow[d], q1 = qrow[d + 1];
        s[0][0] = fmaf(q0, kt[d * kLdk + lane], s[0][0]);
        s[1][0] = fmaf(q0, kt[d * kLdk + 32 + lane], s[1][0]);
        s[0][1] = fmaf(q1, kt[(d + 1) * kLdk + lane], s[0][1]);
        s[1][1] = fmaf(q1, kt[(d + 1) * kLdk + 32 + lane], s[1][1]);
      }
      float sc[2], mx = m[u];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int key = k0 + 32 * h + lane;
        sc[h] = (s[h][0] + s[h][1]) * scale;
        if (causal && key > pos[u]) sc[h] = -1e30f;
        if (key >= sk) sc[h] = -INFINITY;
        mx = fmaxf(mx, sc[h]);
      }
      mx = warp_max(mx);
      const float corr = expf(m[u] - mx);  // 0 on the first tile (m = -inf)
      const float p0 = expf(sc[0] - mx), p1 = expf(sc[1] - mx);
      l[u] = l[u] * corr + warp_sum(p0 + p1);
      m[u] = mx;
      __syncwarp();  // the previous row's weights are read
      pw[lane] = p0;
      pw[32 + lane] = p1;
      __syncwarp();
      // keys past the cache weigh 0 and their V rows are zeros
      float pv[2][kPer] = {};
#pragma unroll 16
      for (int j = 0; j < kDecKeys; ++j) {
        const float pj = pw[j];
#pragma unroll
        for (int t = 0; t < kPer; ++t)
          pv[j & 1][t] = fmaf(pj, vs[j * HD + lane + 32 * t], pv[j & 1][t]);
      }
#pragma unroll
      for (int t = 0; t < kPer; ++t)
        acc[u][t] = acc[u][t] * corr + (pv[0][t] + pv[1][t]);
    }
  }
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    if (!live[u]) continue;
    const int rho = rho0 + warp + kDecWarps * u;
    if (splits == 1) {
      const float inv = 1.0f / fmaxf(l[u], 1e-30f);
      T* orow = o + (static_cast<size_t>(b) * sq + rho / rep) * n_heads * HD +
                static_cast<size_t>(g * rep + rho % rep) * HD;
#pragma unroll
      for (int t = 0; t < kPer; ++t)
        orow[lane + 32 * t] = from_f32<T>(acc[u][t] * inv);
      continue;
    }
    float* st = ws + ((static_cast<size_t>(group) * splits + split) * n_rows +
                      rho) * (HD + 2);
#pragma unroll
    for (int t = 0; t < kPer; ++t) st[lane + 32 * t] = acc[u][t];
    if (lane == 0) {
      st[HD] = m[u];
      st[HD + 1] = l[u];
    }
  }
}

// grid (groups, n_rows), HD threads, `splits` words of shared memory:
// merges the splits of one row. Every load is issued at once (thread d:
// dim d of the first 32 splits' acc, and (m, l) of splits d, d + HD, ...);
// m and l are reduced across the block in a fixed order.
template <typename T, int HD>
__global__ void __launch_bounds__(HD)
    flash_combine_kernel(const float* __restrict__ ws, T* __restrict__ o,
                         int sq, int n_heads, int n_kv, int splits) {
  constexpr int kChunk = 32;
  extern __shared__ float w_s[];  // each split's weight e^(m_s - m)
  __shared__ float red[2][HD / 32];
  const int rep = n_heads / n_kv, n_rows = sq * rep;
  const int group = blockIdx.x, rho = blockIdx.y, d = threadIdx.x;
  const int warp = d >> 5, lane = d & 31;
  const int b = group / n_kv, g = group % n_kv;
  const float* st = ws + (static_cast<size_t>(group) * splits * n_rows + rho) *
                             (HD + 2);
  const size_t stride = static_cast<size_t>(n_rows) * (HD + 2);
  float a[kChunk];
#pragma unroll
  for (int i = 0; i < kChunk; ++i)
    a[i] = i < splits ? st[i * stride + d] : 0.0f;
  float mx = -INFINITY;
  for (int s = d; s < splits; s += HD) {
    w_s[s] = st[s * stride + HD];
    mx = fmaxf(mx, w_s[s]);
  }
  mx = warp_max(mx);
  if (lane == 0) red[0][warp] = mx;
  __syncthreads();
  mx = red[0][0];
#pragma unroll
  for (int w = 1; w < HD / 32; ++w) mx = fmaxf(mx, red[0][w]);
  float l = 0.0f;
  for (int s = d; s < splits; s += HD) {  // a split that saw no key weighs 0
    const float w = w_s[s] == -INFINITY ? 0.0f : expf(w_s[s] - mx);
    w_s[s] = w;
    l += st[s * stride + HD + 1] * w;
  }
  l = warp_sum(l);
  if (lane == 0) red[1][warp] = l;
  __syncthreads();
  l = 0.0f;
#pragma unroll
  for (int w = 0; w < HD / 32; ++w) l += red[1][w];
  float acc = 0.0f;
  for (int s0 = 0; s0 < splits; s0 += kChunk) {
    if (s0 > 0) {
#pragma unroll
      for (int i = 0; i < kChunk; ++i)
        a[i] = s0 + i < splits ? st[(s0 + i) * stride + d] : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < kChunk; ++i)
      if (s0 + i < splits) acc += a[i] * w_s[s0 + i];
  }
  o[(static_cast<size_t>(b) * sq + rho / rep) * n_heads * HD +
    static_cast<size_t>(g * rep + rho % rep) * HD + d] =
      from_f32<T>(acc / fmaxf(l, 1e-30f));
}

// ------------------------------------ 3. float32 prefill, CUDA cores
constexpr int kF32Warps = 8;  // one query row each
constexpr int kF32Threads = kF32Warps * 32;
constexpr int kF32Keys = 32;  // keys per staged tile: one per lane

// float32 words of shared memory: the rows' queries, K^T [HD][33], V [32][HD]
constexpr int f32_smem_words(int hd) {
  return kF32Warps * hd + hd * (kF32Keys + 1) + kF32Keys * hd;
}

template <int HD>
__global__ void __launch_bounds__(kF32Threads)
    flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     int sq, int sk, int n_heads, int n_kv, int causal,
                     int q_offset, float scale) {
  constexpr int kPer = HD / 32;  // output dims per lane
  constexpr int kLdk = kF32Keys + 1;  // odd: a column of K^T spans the banks
  constexpr int kRowVecs = HD / 4;
  constexpr int kLoads = kF32Keys * kRowVecs / kF32Threads;
  static_assert(kF32Keys * kRowVecs % kF32Threads == 0, "staging tiles");
  extern __shared__ float4 smem_f32[];
  float* qs = reinterpret_cast<float*>(smem_f32);  // [8][HD]
  float* kt = qs + kF32Warps * HD;                 // [HD][kLdk]
  float* vs = kt + HD * kLdk;                      // [32][HD]

  const int bh = blockIdx.x;
  const int b = bh / n_heads, h = bh % n_heads;
  const int g = h / (n_heads / n_kv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i0 = blockIdx.y * kF32Warps;
  const int i = i0 + warp;
  const bool active = i < sq;
  const int q_pos = q_offset + i;

  for (int e = threadIdx.x; e < kF32Warps * HD; e += kF32Threads) {
    const int ii = i0 + e / HD;
    qs[e] = ii < sq ? q[(static_cast<size_t>(b) * sq + ii) * n_heads * HD +
                        static_cast<size_t>(h) * HD + e % HD]
                    : 0.0f;
  }
  // keys any row of the block can see
  const int k_end =
      causal ? min(sk, q_offset + min(i0 + kF32Warps, sq)) : sk;
  const size_t kv_row = static_cast<size_t>(n_kv) * HD;  // stride of a key
  const float* kb = k + static_cast<size_t>(b) * sk * kv_row + g * HD;
  const float* vb = v + static_cast<size_t>(b) * sk * kv_row + g * HD;
  const float4* q4 = reinterpret_cast<const float4*>(qs + warp * HD);

  float m = -INFINITY, l = 0.0f, acc[kPer];
#pragma unroll
  for (int t = 0; t < kPer; ++t) acc[t] = 0.0f;

  // k_end is uniform over the block, so every thread reaches each barrier
  for (int k0 = 0; k0 < k_end; k0 += kF32Keys) {
    float4 kr[kLoads], vr[kLoads];  // all issued before any is used
#pragma unroll
    for (int c = 0; c < kLoads; ++c) {
      const int e = threadIdx.x + c * kF32Threads;
      const int key = k0 + e / kRowVecs;
      const size_t off = key * kv_row + (e % kRowVecs) * 4;
      const bool in = key < sk;
      kr[c] = in ? __ldg(reinterpret_cast<const float4*>(kb + off))
                 : make_float4(0, 0, 0, 0);
      vr[c] = in ? __ldg(reinterpret_cast<const float4*>(vb + off))
                 : make_float4(0, 0, 0, 0);
    }
    __syncthreads();  // the previous tile is consumed
#pragma unroll
    for (int c = 0; c < kLoads; ++c) {
      const int e = threadIdx.x + c * kF32Threads;
      const int j = e / kRowVecs, d0 = (e % kRowVecs) * 4;
      kt[d0 * kLdk + j] = kr[c].x;
      kt[(d0 + 1) * kLdk + j] = kr[c].y;
      kt[(d0 + 2) * kLdk + j] = kr[c].z;
      kt[(d0 + 3) * kLdk + j] = kr[c].w;
      *reinterpret_cast<float4*>(vs + j * HD + d0) = vr[c];
    }
    __syncthreads();
    // warp-uniform: a whole tile past the row's causal limit, or the keys
    if (!active || (causal && k0 > q_pos)) continue;
    const int key = k0 + lane;
    float s = 0.0f;
#pragma unroll 8
    for (int d4 = 0; d4 < HD / 4; ++d4) {
      const float4 qv = q4[d4];
      const float* kc = kt + 4 * d4 * kLdk + lane;
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
    const int n = min(kF32Keys, sk - k0);
    for (int j = 0; j < n; ++j) {
      const float pj = __shfl_sync(0xffffffffu, p, j);
#pragma unroll
      for (int t = 0; t < kPer; ++t)
        acc[t] = fmaf(pj, vs[j * HD + lane + 32 * t], acc[t]);
    }
  }
  if (!active) return;
  const float inv = 1.0f / fmaxf(l, 1e-30f);
  float* orow = o + (static_cast<size_t>(b) * sq + i) * n_heads * HD +
                static_cast<size_t>(h) * HD;
#pragma unroll
  for (int t = 0; t < kPer; ++t) orow[lane + 32 * t] = acc[t] * inv;
}

// ------------------------------------------------------------- launches
template <typename T, int HD>
void launch_decode(const void* q, const void* k, const void* v, void* o,
                   float* ws, int b, int sq, int sk, int n_heads, int n_kv,
                   int causal, int q_offset, int splits, float scale,
                   cudaStream_t stream) {
  constexpr int kSmem = dec_smem_words(HD) * 4;
  allow_smem(flash_decode_kernel<T, HD>, kSmem);
  const int n_rows = sq * (n_heads / n_kv);
  const int key_end = causal ? min(sk, q_offset + sq) : sk;
  const int tiles = (key_end + kDecKeys - 1) / kDecKeys;
  const int per = (tiles + splits - 1) / splits;
  const dim3 grid(b * n_kv * ((n_rows + kDecRows - 1) / kDecRows), splits);
  flash_decode_kernel<T, HD><<<grid, kDecThreads, kSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), ws, sq, sk, n_heads, n_kv,
      causal, q_offset, scale, key_end, per);
  if (splits > 1)
    flash_combine_kernel<T, HD>
        <<<dim3(b * n_kv, n_rows), HD, splits * sizeof(float), stream>>>(
            ws, static_cast<T*>(o), sq, n_heads, n_kv, splits);
}

template <int HD>
void launch_tc(const void* q, const void* k, const void* v, void* o, int b,
               int sq, int sk, int n_heads, int n_kv, int causal,
               int q_offset, float scale, cudaStream_t stream) {
  constexpr int kSmem = tc_smem_bytes<HD>();
  allow_smem(flash_tc_kernel<HD>, kSmem);
  const int n_rows = sq * (n_heads / n_kv);
  const dim3 grid((n_rows + kTcRows - 1) / kTcRows, b * n_kv);
  flash_tc_kernel<HD><<<grid, kTcThreads, kSmem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), sq, sk, n_heads,
      n_kv, causal, q_offset, scale * 1.4426950408889634f);
}

template <int HD>
void launch_f32(const void* q, const void* k, const void* v, void* o, int b,
                int sq, int sk, int n_heads, int n_kv, int causal,
                int q_offset, float scale, cudaStream_t stream) {
  constexpr int kSmem = f32_smem_words(HD) * 4;
  allow_smem(flash_f32_kernel<HD>, kSmem);
  const dim3 grid(b * n_heads, (sq + kF32Warps - 1) / kF32Warps);
  flash_f32_kernel<HD><<<grid, kF32Threads, kSmem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), sq, sk, n_heads,
      n_kv, causal, q_offset, scale);
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, float* ws,
           int b, int sq, int sk, int n_heads, int n_kv, int causal,
           int q_offset, int is_bf16, int splits, cudaStream_t stream) {
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(HD)));
  if (sq < kDecRows) {
    if (splits < 1 || (splits > 1 && ws == nullptr))
      return static_cast<int>(cudaErrorInvalidValue);
    if (is_bf16)
      launch_decode<bf16, HD>(q, k, v, o, ws, b, sq, sk, n_heads, n_kv,
                              causal, q_offset, splits, scale, stream);
    else
      launch_decode<float, HD>(q, k, v, o, ws, b, sq, sk, n_heads, n_kv,
                               causal, q_offset, splits, scale, stream);
  } else if (is_bf16) {
    launch_tc<HD>(q, k, v, o, b, sq, sk, n_heads, n_kv, causal, q_offset,
                  scale, stream);
  } else {
    launch_f32<HD>(q, k, v, o, b, sq, sk, n_heads, n_kv, causal, q_offset,
                   scale, stream);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [b, sq, n_heads, hd], k and v [b, sk, n_kv, hd], o like q; contiguous,
// 16-byte aligned, one dtype: bf16 (is_bf16 = 1) or float32. hd is 64 or
// 128 (anything else returns cudaErrorInvalidValue; the wrapper refuses it
// first). sq < 16 runs the split-K decode: `splits` >= 1 key splits and,
// for more than one, `ws` a float32 scratch of b * n_kv * splits * sq *
// (n_heads / n_kv) * (hd + 2) words; otherwise both are unused.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, float* ws, int b, int sq, int sk,
                               int n_heads, int n_kv, int hd, int causal,
                               int q_offset, int is_bf16, int splits,
                               cudaStream_t stream) {
  if (b == 0 || sq == 0) return static_cast<int>(cudaGetLastError());
  if (hd == 64)
    return launch<64>(q, k, v, o, ws, b, sq, sk, n_heads, n_kv, causal,
                      q_offset, is_bf16, splits, stream);
  if (hd == 128)
    return launch<128>(q, k, v, o, ws, b, sq, sk, n_heads, n_kv, causal,
                       q_offset, is_bf16, splits, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
