// Flash-attention forward for Hopper (sm_90a), bf16, on wgmma.
//
// Replaces: tpu_hc_bench/ops/flash_attention.py, the Pallas forward
// `_fwd_kernel` (:83) through `_fwd_call` (:127), for bf16 inputs; the
// float32 forward stays on flash_attention.cu's kernel.
//
//   S = Q K^T * scale, masked (a key past seq_k, or a key after the query
//   under `causal`, both from 0); online softmax over key tiles in f32;
//   P = where(visible, exp(S - m), 0), rounded to bf16 only as the
//   operand of P V; l sums the f32 P; O = acc / max(l, 1e-30) in bf16,
//   lse = m + log(max(l, 1e-30)) in f32 (natural log).
//
// Layouts: q, k, v [b, s, h, d] read through their batch, sequence and
// head strides (d contiguous), so the views of one fused [b, s, 3, h, d]
// projection go in without a copy; o contiguous [b, sq, h, d]; lse
// [b, h, sq].  Head dim 64 or 128.
//
// What bounds it on an H100: bytes, barely.  At the GPT-2 training shape
// (b 16, s 1024, h 12, d 64, causal) the forward does 25.8 GFLOP of
// tensor-core work against ~101 MB (254 FLOP/byte, just under the card's
// ~295 ridge): 0.0303 ms at 3.35 TB/s, 0.026 ms at 989 TFLOP/s.
//
// What the design does about it (FlashAttention-3's shape, simplified):
//   - one block per (128-query tile, b*h): two warpgroups of 64 query rows
//     each; Q is staged once; K and V tiles (128 keys at d 64, 64 at d 128)
//     go through a 2-stage shared-memory ring, the next tile's cp.async
//     copy in flight while the current one is used;
//   - S = Q K^T is a wgmma SS product (both operands K-major) accumulated
//     in registers: S never touches shared memory;
//   - the online softmax runs in registers: each thread holds two rows of
//     the accumulator, row max and sum across the quad by two shuffles,
//     exp2 with scale * log2(e) folded in (m is kept in the log2 domain,
//     lse converted back); masks only on the diagonal and ragged tiles;
//   - O += P V is a wgmma RS product: P, packed to bf16 in registers, is
//     the A operand in the accumulator's own layout; V is the MN-major B
//     operand (the transpose bit); O stays in registers for the whole key
//     loop;
//   - causal: the key loop ends at the diagonal tile, a warpgroup skips a
//     tile it cannot see, and the query tiles launch longest first (the
//     tile index is the grid's slow axis, reversed), so the heaviest
//     blocks do not form the tail;
//   - no atomics: the same bits on every run.
//   - two blocks an SM, so one block's loads and epilogue overlap the
//     other's products.
// Not yet done: TMA and a producer warp, warpgroup ping-pong and the
// overlap of one tile's softmax with the next tile's products.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBQ = 128;         // query rows per block: two warpgroups
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int D>
struct Cfg {
  static constexpr int kBK = D == 64 ? 128 : 64;   // keys per tile
  static constexpr int kQBytes = kBQ * D * 2;
  static constexpr int kTileBytes = kBK * D * 2;   // one K or V tile
  // Q, then K0 V0 K1 V1; +1024 to align the base to a swizzle atom
  static constexpr int kSmem = kQBytes + 4 * kTileBytes + 1024;
};

struct Args {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;
  float* lse;
  long long qs[3], ks[3], vs[3];   // batch, sequence, head strides
  int h, sq, sk;
  float scale;
  int causal;
};

// rows row0 .. row0 + R - 1 of one head ([rows, D] through row_stride)
// into a swizzled R x D tile; zeros past `rows`
template <int R, int D>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* src,
                                          long long row_stride, int row0,
                                          int rows, int tid) {
  constexpr int kChunks = D / 8;
  static_assert(R * kChunks % kThreads == 0, "whole chunks per thread");
#pragma unroll
  for (int i = 0; i < R * kChunks / kThreads; ++i) {
    const int u = tid + i * kThreads;
    const int r = u / kChunks, c = u % kChunks;
    const bool ok = row0 + r < rows;
    const bf16* g = ok ? src + (row0 + r) * row_stride + c * 8 : src;
    sm90::cp_async16(dst + sm90::sw128_offset(r, c, R), g, ok);
  }
}

// S = Q K^T over D / 16 k-steps; PV: O += P V over kBK / 16 k-steps
template <int D>
struct Products;

template <>
struct Products<64> {            // S m64n128, O m64n64
  static __device__ __forceinline__ void qk(float (&s)[64], uint32_t sq,
                                            uint32_t sk) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      sm90::wgmma_ss_m64n128<0>(s, sm90::desc_k_major(sq, kBQ, kk),
                                sm90::desc_k_major(sk, 128, kk), kk > 0);
  }
  static __device__ __forceinline__ void pv(float (&o)[32],
                                            const uint32_t (&p)[8][4],
                                            uint32_t sv) {
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      sm90::wgmma_rs_m64n64<1>(o, p[kk], sm90::desc_mn_major(sv, 128, kk),
                               1);
  }
};

template <>
struct Products<128> {           // S m64n64, O m64n128
  static __device__ __forceinline__ void qk(float (&s)[32], uint32_t sq,
                                            uint32_t sk) {
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      sm90::wgmma_ss_m64n64<0>(s, sm90::desc_k_major(sq, kBQ, kk),
                               sm90::desc_k_major(sk, 64, kk), kk > 0);
  }
  static __device__ __forceinline__ void pv(float (&o)[64],
                                            const uint32_t (&p)[4][4],
                                            uint32_t sv) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      sm90::wgmma_rs_m64n128<1>(o, p[kk], sm90::desc_mn_major(sv, 64, kk),
                                1);
  }
};

// two blocks an SM (128 registers a thread; 81 or 97 KB of shared memory
// each), so one block's loads and epilogue overlap the other's products
template <int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_sm90_kernel(const Args p) {
  using C = Cfg<D>;
  constexpr int kBK = C::kBK;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sQ = (sm90::smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sKV = sQ + C::kQBytes;          // stage st: K, then V

  const int tid = threadIdx.x, wg = tid >> 7;
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int bh = blockIdx.x, bi = bh / p.h, hi = bh % p.h;
  const int qt = p.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int i0 = qt * kBQ;
  const bf16* q = p.q + bi * p.qs[0] + hi * p.qs[2];
  const bf16* k = p.k + bi * p.ks[0] + hi * p.ks[2];
  const bf16* v = p.v + bi * p.vs[0] + hi * p.vs[2];

  const int n_kt = (p.sk + kBK - 1) / kBK;
  const int kt_end = p.causal ? min(n_kt, (i0 + kBQ - 1) / kBK + 1) : n_kt;

  load_tile<kBQ, D>(sQ, q, p.qs[1], i0, p.sq, tid);
  if (kt_end > 0) {
    load_tile<kBK, D>(sKV, k, p.ks[1], 0, p.sk, tid);
    load_tile<kBK, D>(sKV + C::kTileBytes, v, p.vs[1], 0, p.sk, tid);
  }
  sm90::cp_async_commit();

  // this thread's rows: row0 and row0 + 8 of the block's query tile
  const int wg_row = i0 + wg * 64;
  const int row0 = wg_row + warp * 16 + (lane >> 2);
  const int col0 = 2 * (lane & 3);
  const float sl2 = p.scale * kLog2e;
  const uint32_t sQwg = sQ + wg * 64 * 128;       // this warpgroup's rows
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m2[2] = {kNegInf, kNegInf};   // row max of S * scale * log2(e)
  float l[2] = {0.f, 0.f};            // this thread's share of the row sum

  for (int kt = 0; kt < kt_end; ++kt) {
    const int st = kt & 1;
    const uint32_t sK = sKV + st * 2 * C::kTileBytes;
    const uint32_t sV = sK + C::kTileBytes;
    if (kt + 1 < kt_end) {
      const uint32_t nK = sKV + (st ^ 1) * 2 * C::kTileBytes;
      load_tile<kBK, D>(nK, k, p.ks[1], (kt + 1) * kBK, p.sk, tid);
      load_tile<kBK, D>(nK + C::kTileBytes, v, p.vs[1], (kt + 1) * kBK,
                        p.sk, tid);
    }
    sm90::cp_async_commit();
    sm90::cp_async_wait<1>();        // Q and tile kt are in
    sm90::fence_proxy_async();
    __syncthreads();

    const int j0 = kt * kBK;
    if (!p.causal || j0 <= wg_row + 63) {
      float s[kBK / 2];
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i) s[i] = 0.f;
      sm90::wgmma_fence();
      Products<D>::qk(s, sQwg, sK);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(s);

      // scores in the log2 domain; a hidden one is -inf, so its
      // exp2 is 0 whatever the row max (which starts at -1e30)
      const bool mask = (p.causal && j0 + kBK - 1 > wg_row) ||
                        j0 + kBK > p.sk;
      float mx[2] = {m2[0], m2[1]};
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i) {
        float x = s[i] * sl2;
        if (mask) {
          const int kpos = j0 + 8 * (i >> 2) + col0 + (i & 1);
          const int qpos = row0 + 8 * ((i >> 1) & 1);
          if (kpos >= p.sk || (p.causal && kpos > qpos))
            x = __int_as_float(0xff800000);              // -inf
        }
        s[i] = x;
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
      }
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(~0u, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(~0u, mx[r], 2));
        corr[r] = exp2f(m2[r] - mx[r]);
        m2[r] = mx[r];
      }
      uint32_t pa[kBK / 16][4];
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          const int i = 8 * kk + 2 * f;
          const float p0 = exp2f(s[i] - mx[f & 1]);
          const float p1 = exp2f(s[i + 1] - mx[f & 1]);
          rs[f & 1] += p0 + p1;
          pa[kk][f] = sm90::pack_bf16(p0, p1);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + rs[r];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= corr[(i >> 1) & 1];

      sm90::wgmma_fence();
      Products<D>::pv(o, pa, sV);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(o);
    }
    __syncthreads();                 // stage st is free for tile kt + 2
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(~0u, l[r], 1);
    l[r] += __shfl_xor_sync(~0u, l[r], 2);
    l[r] = fmaxf(l[r], 1e-30f);
  }
  const int sq = p.sq;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = row0 + 8 * r;
    if (qpos >= sq) continue;
    bf16* orow = p.o + (((long long)bi * sq + qpos) * p.h + hi) * D + col0;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(orow + 8 * j) = sm90::pack_bf16(
          o[4 * j + 2 * r] / l[r], o[4 * j + 2 * r + 1] / l[r]);
    if ((lane & 3) == 0)
      p.lse[(long long)bh * sq + qpos] =
          (m2[r] == kNegInf ? kNegInf : m2[r] * kLn2) + logf(l[r]);
  }
}

template <int D>
int launch(const Args& a, int b, cudaStream_t stream) {
  const int smem = Cfg<D>::kSmem;
  auto kernel = flash_fwd_sm90_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (a.sq + kBQ - 1) / kBQ;
  if (tiles == 0 || b * a.h == 0) return 0;
  kernel<<<dim3(b * a.h, tiles), kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

namespace thb {

// The bf16 forward; called by thb_flash_attention_fwd (flash_attention.cu).
// Strides in elements (batch, sequence, head) for q, k and v.  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a head
// dim other than 64 or 128.
int flash_fwd_sm90(const void* q, const void* k, const void* v, void* o,
                   void* lse, int b, int h, int sq, int sk, int d,
                   const long long* qs, const long long* ks,
                   const long long* vs, float scale, int causal,
                   cudaStream_t stream) {
  Args a = {};
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.o = static_cast<bf16*>(o);
  a.lse = static_cast<float*>(lse);
  for (int i = 0; i < 3; ++i) {
    a.qs[i] = qs[i];
    a.ks[i] = ks[i];
    a.vs[i] = vs[i];
  }
  a.h = h;
  a.sq = sq;
  a.sk = sk;
  a.scale = scale;
  a.causal = causal;
  if (d == 64) return launch<64>(a, b, stream);
  if (d == 128) return launch<128>(a, b, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace thb
