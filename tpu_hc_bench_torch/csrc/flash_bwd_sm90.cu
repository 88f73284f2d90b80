// Flash-attention backward for Hopper (sm_90a), bf16, on wgmma: the dQ
// pass and the dK/dV pass, one kernel each.
//
// Replaces: tpu_hc_bench/ops/flash_attention.py, the Pallas `_dq_kernel`
// (:184) and `_dkv_kernel` (:208), both reached through `_bwd_call`
// (:240; pallas_calls at :249 and :265), for bf16 inputs; the float32
// passes stay on flash_attention.cu's FMA kernels.  Both recompute, tile
// by tile, what `_p_and_ds` (:165) does, with its rounding points:
//
//   P  = where(visible, exp(S * scale - lse), 0) in f32 (lse natural-log,
//        from the forward; here exp2 with scale * log2(e) folded in);
//   dP = dO V^T in f32;  dS = (P * (dP - D)) * scale, rounded to bf16
//        before its product;  P rounded to bf16 before P^T dO;
//   dQ = sum over key tiles of dS K;  dV = sum over query tiles of P^T dO,
//   dK = sum of dS^T Q; every sum in f32, the outputs rounded to bf16.
//   D = rowsum(dO * O) in f32 comes from the caller, as in the JAX package.
//
// Layouts: q, k, v [b, s, h, d] read through their batch, sequence and
// head strides (d contiguous), so the views of one fused [b, s, 3, h, d]
// projection go in without a copy; dO, dQ, dK, dV contiguous [b, s, h, d];
// lse and D [b, h, sq] f32.  Head dim 64 or 128 (template cases; the
// wrapper zero-pads other head dims up to 128).
//
// What bounds it on an H100: operations.  At the GPT-2 training shape
// (b 16, s 1024, h 12, d 64, causal) dQ does 38.7 GFLOP of tensor-core
// work against ~127 MB and dK/dV 51.6 GFLOP against ~153 MB (304 and 338
// FLOP/byte, above the card's ~295 ridge): 0.039 and 0.052 ms at 989
// TFLOP/s.
//
// What the design does about it (FlashAttention-3's backward, simplified
// to two kernels and no atomics, so the same bits on every run):
//   - dQ: one block per (b*h, 128-query tile), two consumer warpgroups of
//     64 query rows; Q, dO and the rows' lse and D once (lse and D held in
//     registers); K and V tiles of 64 keys through a 2-stage cp.async
//     ring.  S = Q K^T and dP = dO V^T are wgmma SS products into
//     registers; dS is formed there and packed to bf16 in the
//     accumulator's own layout, the A fragment of dQ += dS K (RS, K read
//     MN-major through the transpose bit).  dQ stays in registers for the
//     whole key loop.
//   - dK/dV: one block per (b*h, 128-key tile), two warpgroups of 64 keys;
//     K and V once; Q, dO, lse and D tiles of 64 queries through the ring.
//     The scores are computed transposed, S^T = K Q^T and dP^T = V dO^T
//     (SS, both operands K-major), so P^T and dS^T are born in the
//     accumulator layout with key rows and feed dV += P^T dO and
//     dK += dS^T Q as RS products, dO and Q read MN-major: no transposed
//     fragment, nothing through shared memory.  lse and D are per column
//     here, read from the staged rows.
//   - masks only on the diagonal and ragged tiles; under causal a
//     warpgroup skips a tile it cannot see, and the heaviest blocks launch
//     first (query tiles in reverse for dQ, low key tiles first for dK/dV)
//     so the triangle leaves no tail; b*h on the grid's x axis (no 65535
//     cap).
// Not yet done: TMA and a producer warp, warpgroup ping-pong, and the
// overlap of one tile's elementwise work with the next tile's products.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBM = 128;          // output rows per block: two warpgroups
constexpr int kBN = 64;           // rows of each streamed tile
constexpr int kThreads = 256;
constexpr float kLog2e = 1.4426950408889634f;

struct Args {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* dout;
  const float* lse;
  const float* delta;
  bf16* dq;
  bf16* dk;
  bf16* dv;
  long long qs[3], ks[3], vs[3];   // batch, sequence, head strides
  int h, sq, sk;
  float scale;
  int causal;
};

template <int D>
struct Cfg {
  static constexpr int kBig = kBM * D * 2;     // a 128-row tile
  static constexpr int kTile = kBN * D * 2;    // a 64-row tile
  // dQ: Q, dO, then K0 V0 K1 V1; dK/dV: K, V, then Q0 dO0 Q1 dO1 and the
  // staged lse and D rows; +1024 to align the base to a swizzle atom
  static constexpr int kDqSmem = 2 * kBig + 4 * kTile + 1024;
  static constexpr int kDkvSmem = 2 * kBig + 4 * kTile + 4 * kBN * 4 + 1024;
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

// acc[64, 64] = A B^T over D / 16 k-steps: A a warpgroup's 64 rows of a
// K-major tile of `a_rows` rows, B a K-major tile of kBN rows
template <int D>
__device__ __forceinline__ void ss_scores(float (&acc)[32], uint32_t sa,
                                          int a_rows, uint32_t sb) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    sm90::wgmma_ss_m64n64<0>(acc, sm90::desc_k_major(sa, a_rows, kk),
                             sm90::desc_k_major(sb, kBN, kk), kk > 0);
}

// acc[64, D] += A B over kBN / 16 k-steps: A the packed bf16 fragments,
// B a kBN x D tile read MN-major
template <int D>
__device__ __forceinline__ void rs_accumulate(float (&acc)[D / 2],
                                              const uint32_t (&a)[4][4],
                                              uint32_t sb) {
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk) {
    if constexpr (D == 64)
      sm90::wgmma_rs_m64n64<1>(acc, a[kk], sm90::desc_mn_major(sb, kBN, kk),
                               1);
    else
      sm90::wgmma_rs_m64n128<1>(acc, a[kk],
                                sm90::desc_mn_major(sb, kBN, kk), 1);
  }
}

// one [64, D] accumulator (rows row0 and row0 + 8 of this thread) to bf16
// rows of stride `hd`, rows at or past `rows` dropped
template <int D>
__device__ __forceinline__ void store_rows(bf16* dst, long long hd,
                                           const float (&acc)[D / 2],
                                           int row0, int rows, int col0) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int pos = row0 + 8 * r;
    if (pos >= rows) continue;
    bf16* out = dst + pos * hd + col0;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(out + 8 * j) =
          sm90::pack_bf16(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = 0.f;
}

// Blocks an SM, chosen by measurement at head dim 64 (PERF.md): dQ holds
// dQ, S and dP (96 f32 a thread) and runs two under the 128-register cap;
// dK/dV holds dK, dV, S^T and dP^T (128 f32) and runs one, faster than two
// with spills.  At head dim 128 each kernel's 129-130 KB of shared memory
// fits one block an SM.

// --- dQ: one block per (b*h, 128-query tile) -----------------------------

template <int D>
__global__ void __launch_bounds__(kThreads, D == 64 ? 2 : 1)
flash_dq_sm90_kernel(const Args p) {
  using C = Cfg<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sQ = (sm90::smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sdO = sQ + C::kBig;
  const uint32_t sKV = sdO + C::kBig;            // stage st: K, then V

  const int tid = threadIdx.x, wg = tid >> 7;
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int bh = blockIdx.x, bi = bh / p.h, hi = bh % p.h;
  // under causal the last query tiles see the most keys: launch them first
  const int qt = p.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int i0 = qt * kBM;
  const long long hd = (long long)p.h * D;       // row stride of dO, dQ
  const bf16* q = p.q + bi * p.qs[0] + hi * p.qs[2];
  const bf16* k = p.k + bi * p.ks[0] + hi * p.ks[2];
  const bf16* v = p.v + bi * p.vs[0] + hi * p.vs[2];
  const bf16* dout = p.dout + (long long)bi * p.sq * hd + (long long)hi * D;

  const int n_kt = (p.sk + kBN - 1) / kBN;
  const int kt_end = p.causal ? min(n_kt, (i0 + kBM - 1) / kBN + 1) : n_kt;

  // nothing to load when no key tile is visible (sk 0): no copy is left in
  // flight at exit
  if (kt_end > 0) {
    load_tile<kBM, D>(sQ, q, p.qs[1], i0, p.sq, tid);
    load_tile<kBM, D>(sdO, dout, hd, i0, p.sq, tid);
    load_tile<kBN, D>(sKV, k, p.ks[1], 0, p.sk, tid);
    load_tile<kBN, D>(sKV + C::kTile, v, p.vs[1], 0, p.sk, tid);
  }
  sm90::cp_async_commit();

  // this thread's rows: row0 and row0 + 8; their lse (log2 domain) and D
  const int wg_row = i0 + wg * 64;
  const int row0 = wg_row + warp * 16 + (lane >> 2);
  const int col0 = 2 * (lane & 3);
  float lse2[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int pos = row0 + 8 * r;
    const bool ok = pos < p.sq;
    lse2[r] = ok ? p.lse[(long long)bh * p.sq + pos] * kLog2e : 0.f;
    dlt[r] = ok ? p.delta[(long long)bh * p.sq + pos] : 0.f;
  }
  const float sl2 = p.scale * kLog2e;
  const uint32_t sQwg = sQ + wg * 64 * 128;      // this warpgroup's rows
  const uint32_t sdOwg = sdO + wg * 64 * 128;
  float dq[D / 2];
  zero(dq);

  for (int kt = 0; kt < kt_end; ++kt) {
    const int st = kt & 1;
    const uint32_t sK = sKV + st * 2 * C::kTile;
    const uint32_t sV = sK + C::kTile;
    if (kt + 1 < kt_end) {
      const uint32_t nK = sKV + (st ^ 1) * 2 * C::kTile;
      load_tile<kBN, D>(nK, k, p.ks[1], (kt + 1) * kBN, p.sk, tid);
      load_tile<kBN, D>(nK + C::kTile, v, p.vs[1], (kt + 1) * kBN, p.sk,
                        tid);
    }
    sm90::cp_async_commit();
    sm90::cp_async_wait<1>();          // Q, dO and tile kt are in
    sm90::fence_proxy_async();
    __syncthreads();

    const int j0 = kt * kBN;
    if (!p.causal || j0 <= wg_row + 63) {
      float s[32], dp[32];
      zero(s);
      zero(dp);
      sm90::wgmma_fence();
      ss_scores<D>(s, sQwg, kBM, sK);
      ss_scores<D>(dp, sdOwg, kBM, sV);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(s);
      sm90::fence_regs(dp);

      const bool mask = (p.causal && j0 + kBN - 1 > wg_row) ||
                        j0 + kBN > p.sk;
      uint32_t ds[kBN / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk) {
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          const int r = f & 1;
          float x[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 8 * kk + 2 * f + e;
            float pr = exp2f(fmaf(s[i], sl2, -lse2[r]));
            if (mask) {
              const int kpos = j0 + 8 * (i >> 2) + col0 + e;
              if (kpos >= p.sk || (p.causal && kpos > row0 + 8 * r))
                pr = 0.f;
            }
            x[e] = pr * (dp[i] - dlt[r]) * p.scale;
          }
          ds[kk][f] = sm90::pack_bf16(x[0], x[1]);
        }
      }
      sm90::wgmma_fence();
      rs_accumulate<D>(dq, ds, sK);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(dq);
    }
    __syncthreads();                   // stage st is free for tile kt + 2
  }

  bf16* out = p.dq + (long long)bi * p.sq * hd + (long long)hi * D;
  store_rows<D>(out, hd, dq, row0, p.sq, col0);
}

// --- dK, dV: one block per (b*h, 128-key tile) ---------------------------

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_dkv_sm90_kernel(const Args p) {
  using C = Cfg<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = sm90::smem_u32(smem_raw);
  const uint32_t sK = (base + 1023) & ~1023u;
  const uint32_t sV = sK + C::kBig;
  const uint32_t sQD = sV + C::kBig;             // stage st: Q, then dO
  const uint32_t sRows = sQD + 4 * C::kTile;     // stage st: lse, then D
  const float* rows_gen =
      reinterpret_cast<const float*>(smem_raw + (sRows - base));

  const int tid = threadIdx.x, wg = tid >> 7;
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int bh = blockIdx.x, bi = bh / p.h, hi = bh % p.h;
  // under causal the first key tiles are seen by the most queries: they
  // launch first, in the grid's natural order
  const int j0 = blockIdx.y * kBM;
  const long long hd = (long long)p.h * D;
  const bf16* q = p.q + bi * p.qs[0] + hi * p.qs[2];
  const bf16* k = p.k + bi * p.ks[0] + hi * p.ks[2];
  const bf16* v = p.v + bi * p.vs[0] + hi * p.vs[2];
  const bf16* dout = p.dout + (long long)bi * p.sq * hd + (long long)hi * D;
  const float* lse = p.lse + (long long)bh * p.sq;
  const float* delta = p.delta + (long long)bh * p.sq;

  // the first query tile holding a query at or after key j0
  const int n_qt = (p.sq + kBN - 1) / kBN;
  const int qt0 = p.causal ? j0 / kBN : 0;

  // the Q, dO, lse and D tiles of query tile qt into stage st
  auto load_stage = [&](int qt, int st) {
    const int i0 = qt * kBN;
    const uint32_t sQ = sQD + st * 2 * C::kTile;
    load_tile<kBN, D>(sQ, q, p.qs[1], i0, p.sq, tid);
    load_tile<kBN, D>(sQ + C::kTile, dout, hd, i0, p.sq, tid);
    if (tid < 2 * kBN) {
      const int c = tid % kBN;
      const float* src = tid < kBN ? lse : delta;
      const bool ok = i0 + c < p.sq;
      sm90::cp_async4(sRows + (st * 2 + tid / kBN) * kBN * 4 + c * 4,
                      ok ? src + i0 + c : src, ok);
    }
  };

  // under causal with sk > sq, keys past the last query see no tile: their
  // dK and dV are zero and nothing is loaded (no copy in flight at exit)
  if (qt0 < n_qt) {
    load_tile<kBM, D>(sK, k, p.ks[1], j0, p.sk, tid);
    load_tile<kBM, D>(sV, v, p.vs[1], j0, p.sk, tid);
    load_stage(qt0, 0);
  }
  sm90::cp_async_commit();

  // this thread's key rows: krow0 and krow0 + 8
  const int wg_key = j0 + wg * 64;
  const int krow0 = wg_key + warp * 16 + (lane >> 2);
  const int col0 = 2 * (lane & 3);
  const float sl2 = p.scale * kLog2e;
  const uint32_t sKwg = sK + wg * 64 * 128;      // this warpgroup's keys
  const uint32_t sVwg = sV + wg * 64 * 128;
  float dk[D / 2], dv[D / 2];
  zero(dk);
  zero(dv);

  for (int qt = qt0; qt < n_qt; ++qt) {
    const int st = (qt - qt0) & 1;
    const uint32_t sQ = sQD + st * 2 * C::kTile;
    const uint32_t sdO = sQ + C::kTile;
    if (qt + 1 < n_qt) load_stage(qt + 1, st ^ 1);
    sm90::cp_async_commit();
    sm90::cp_async_wait<1>();          // K, V and tile qt are in
    sm90::fence_proxy_async();
    __syncthreads();

    const int i0 = qt * kBN;
    if (!p.causal || i0 + kBN - 1 >= wg_key) {
      // transposed scores: key rows, query columns
      float s[32], dp[32];
      zero(s);
      zero(dp);
      sm90::wgmma_fence();
      ss_scores<D>(s, sKwg, kBM, sQ);
      ss_scores<D>(dp, sVwg, kBM, sdO);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(s);
      sm90::fence_regs(dp);

      const float* lse_t = rows_gen + st * 2 * kBN;
      const float* dlt_t = lse_t + kBN;
      const bool mask = (p.causal && i0 < wg_key + 63) || i0 + kBN > p.sq ||
                        wg_key + 64 > p.sk;
      uint32_t pa[kBN / 16][4], da[kBN / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk) {
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          const int kpos = krow0 + 8 * (f & 1);
          float pv[2], dv2[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 8 * kk + 2 * f + e;
            const int c = 8 * (i >> 2) + col0 + e;   // query in the tile
            float pr = exp2f(fmaf(s[i], sl2, -lse_t[c] * kLog2e));
            if (mask) {
              const int qpos = i0 + c;
              if (qpos >= p.sq || kpos >= p.sk || (p.causal && kpos > qpos))
                pr = 0.f;
            }
            pv[e] = pr;
            dv2[e] = pr * (dp[i] - dlt_t[c]) * p.scale;
          }
          pa[kk][f] = sm90::pack_bf16(pv[0], pv[1]);
          da[kk][f] = sm90::pack_bf16(dv2[0], dv2[1]);
        }
      }
      sm90::wgmma_fence();
      rs_accumulate<D>(dv, pa, sdO);
      rs_accumulate<D>(dk, da, sQ);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(dv);
      sm90::fence_regs(dk);
    }
    __syncthreads();                   // stage st is free for tile qt + 2
  }

  const long long off = (long long)bi * p.sk * hd + (long long)hi * D;
  store_rows<D>(p.dk + off, hd, dk, krow0, p.sk, col0);
  store_rows<D>(p.dv + off, hd, dv, krow0, p.sk, col0);
}

template <typename Kernel>
int launch_kernel(Kernel kernel, int smem, int bh, int tiles, const Args& a,
                  cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (tiles == 0 || bh == 0) return 0;
  kernel<<<dim3(bh, tiles), kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch(bool dkv, const Args& a, int b, cudaStream_t stream) {
  if (dkv)
    return launch_kernel(flash_dkv_sm90_kernel<D>,
                         Cfg<D>::kDkvSmem, b * a.h, (a.sk + kBM - 1) / kBM,
                         a, stream);
  return launch_kernel(flash_dq_sm90_kernel<D>,
                       Cfg<D>::kDqSmem, b * a.h, (a.sq + kBM - 1) / kBM, a,
                       stream);
}

int run(bool dkv, Args& a, const void* q, const void* k, const void* v,
        const void* dout, const void* lse, const void* delta, int b, int h,
        int sq, int sk, int d, const long long* qs, const long long* ks,
        const long long* vs, float scale, int causal, cudaStream_t stream) {
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.dout = static_cast<const bf16*>(dout);
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
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
  if (d == 64) return launch<64>(dkv, a, b, stream);
  if (d == 128) return launch<128>(dkv, a, b, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

namespace thb {

// The bf16 backward passes; called by thb_flash_attention_dq and _dkv
// (flash_attention.cu).  Strides in elements (batch, sequence, head) for
// q, k and v.  Each returns cudaGetLastError() after its launch, or
// cudaErrorInvalidValue for a head dim other than 64 or 128.
int flash_dq_sm90(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* delta,
                  void* dq, int b, int h, int sq, int sk, int d,
                  const long long* qs, const long long* ks,
                  const long long* vs, float scale, int causal,
                  cudaStream_t stream) {
  Args a = {};
  a.dq = static_cast<bf16*>(dq);
  return run(false, a, q, k, v, dout, lse, delta, b, h, sq, sk, d, qs, ks,
             vs, scale, causal, stream);
}

int flash_dkv_sm90(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dk, void* dv, int b, int h, int sq, int sk, int d,
                   const long long* qs, const long long* ks,
                   const long long* vs, float scale, int causal,
                   cudaStream_t stream) {
  Args a = {};
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  return run(true, a, q, k, v, dout, lse, delta, b, h, sq, sk, d, qs, ks,
             vs, scale, causal, stream);
}

}  // namespace thb
