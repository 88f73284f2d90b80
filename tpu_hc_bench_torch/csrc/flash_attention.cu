// Flash attention for Hopper (sm_90a) on the FMA units: the forward and
// the two backward passes (dQ; dK and dV), each one kernel, for float32
// at head dims 64, 128 and 256 and for bfloat16 at head dim 256, and for
// both at a multiple of 256 above it; and the
// C entries of all flash kernels (bf16 at head dims 64 and 128 runs
// flash_fwd_sm90.cu and flash_bwd_sm90.cu).
//
// Replaces: tpu_hc_bench/ops/flash_attention.py, the three Pallas kernels
// reached from `flash_attention`, for those inputs: `_fwd_kernel`
// (through `_fwd_call`), `_dq_kernel` and `_dkv_kernel` (both through
// `_bwd_call`).
//
//   forward:  S = Q K^T * scale, masked to -1e30 (key past seq_k, or a key
//             after the query under `causal`: qpos >= kpos, both from 0);
//             online softmax over key tiles in f32, P = where(visible,
//             exp(S - m), 0) rounded to V's dtype before P V;
//             O = acc / max(l, 1e-30), lse = m + log(max(l, 1e-30)) in f32.
//   dQ:       P = where(visible, exp(S - lse), 0), dP = dO V^T,
//             dS = (P * (dP - D)) * scale rounded to the input dtype,
//             dQ = sum over key tiles of dS K.
//   dK, dV:   the same P and dS, dV = sum over query tiles of P^T dO
//             (P rounded to the input dtype), dK = sum of dS^T Q.
//   D = rowsum(dO * O) in f32 comes from the caller, as in the JAX
//   package, where it is computed outside the kernels.
//
// Layouts: q, k, v are [b, s, h, d] read through their batch, sequence
// and head strides (the last dimension contiguous), so the views q, k, v
// of one fused [b, s, 3, h, d] projection go in without a copy; o, dO, dQ,
// dK and dV are contiguous [b, s, h, d]; lse and D are [b, h, s] float32.
// Head dim 64, 128 or 256 (template cases), or a multiple of 256 above
// it on the 256 case.  Tiles are 64 rows at head dims 64 and 128 and 32
// rows from 256, where 64-row tiles of the dK/dV kernel would need ~420
// KB of shared memory in f32 and ~320 KB in bf16 (Geo::dkv), and a 64 x
// 256 register patch of P V would spill.
//
// Above 256 (p.nch = d / 256 chunks of 256 columns): the contractions over
// the head dim loop over the chunks, S = sum_c Q_c K_c^T and, in the
// backward, dP = sum_c dO_c V_c^T, each chunk staged in the 256-wide tiles
// in turn; the grid's z axis is the 256-wide column block cb of each
// output (O, dQ, dK, dV), which takes V_cb, K_cb, or Q_cb and dO_cb for
// its last product.  Each column block recomputes S (and dP): ceil(d /
// 256) times the score work, for a shape no model of the zoo has.  At d <=
// 256 (nch 1) the tiles are staged once, as the loops always did.
//
// What bounds it on an H100, at the training shape (b 16, s 1024, h 12,
// d 64, causal): operations on the FMA units (67 TFLOP/s in f32; no TF32,
// the plain version's arithmetic): 25.8, 38.7 and 51.6 GFLOP for the
// forward, dQ and dK/dV.  Every tile product goes through shared memory
// between block-wide barriers, with no overlap of loads with math.
//
// What the design does about it: every block owns one row tile of its
// output and loops over the other operand's row tiles, so the score
// tile never reaches device memory and no block shares an output with
// another (no atomics: the result is the same on every run).  The tiles
// are staged in shared memory with 16-byte loads (bf16 stays bf16 there
// and is widened to f32 as a product reads it: the products of two bf16
// values are exact in f32); each thread computes a kB/8 x N/16 patch of a
// product in registers.  The accumulators (O; dQ; dK
// and dV) stay in shared memory between tiles.  Under `causal` the loops
// stop at the diagonal: the forward and dQ visit key tiles 0..i only,
// dK/dV query tiles j.. only, the counterpart of the Pallas `_tile_live`
// test, so dead tiles cost nothing at all.  A Pallas grid axis runs in
// order and carries the accumulator in VMEM; here a loop inside the block
// does, and the blocks run in parallel.  b*h is the grid's x axis (no
// 65535 cap), the tile index its y axis.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;   // four warps, kB / 4 tile rows each
constexpr float kNegInf = -1e30f;

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16(x);
}
__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

// Shared-memory geometry per element type and head dim: kB rows a tile.
// Row strides are padded against bank conflicts, but f32 at d 128 goes
// unpadded so the dK/dV kernel fits in 227 KB.  In f32 the probabilities
// and dS are written over S and dP in place (kP = 0); bf16 gives them
// tiles of their own (a bf16 P written over an f32 S would be read back
// by other threads before they read their S).
template <typename T, int D>
struct Geo {
  static constexpr bool kHalf = sizeof(T) == 2;
  static_assert(!kHalf || D == 256,
                "bf16 at head dims 64 and 128 runs the wgmma kernels");
  static constexpr int kB = D == 256 ? 32 : 64;
  static constexpr int kLdT = D + (kHalf ? 8 : (D == 128 ? 0 : 4));
  static constexpr int kLdS = kB + 4;                 // f32 [kB, kB]
  static constexpr int kLdP = kHalf ? kB + 8 : kLdS;
  static constexpr int kLdO = D + (D == 128 ? 0 : 4);
  static constexpr int kTile = kB * kLdT * (int)sizeof(T);
  static constexpr int kS = kB * kLdS * 4;
  static constexpr int kP = kHalf ? kB * kLdP * 2 : 0;
  static constexpr int kO = kB * kLdO * 4;
  static constexpr int kRow = kB * 4;
  static constexpr int fwd = 3 * kTile + kS + kP + kO + 2 * kRow;
  static constexpr int dq = 4 * kTile + 2 * kS + kP + kO + 2 * kRow;
  static constexpr int dkv = 4 * kTile + 2 * kS + 2 * kP + 2 * kO + 2 * kRow;
  static_assert(dkv <= 232448, "dK/dV tiles exceed 227 KB");
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;       // dO, contiguous [b, sq, h, d]
  void* o;                // contiguous [b, sq, h, d]
  float* lse;             // [b, h, sq]
  const float* lse_in;    // [b, h, sq]
  const float* delta;     // [b, h, sq]
  void* dq;               // contiguous [b, sq, h, d]
  void* dk;               // contiguous [b, sk, h, d]
  void* dv;
  long long qs[3], ks[3], vs[3];   // batch, sequence, head strides
  int b, h, sq, sk;
  int d;                  // row length of o, dO and the gradients
  int nch;                // chunks of D columns a row (d / D; 1 at d <= D)
  float scale;
  int causal;
};

// --- staging --------------------------------------------------------------

// rows row0.. of one head into a [KB, ld] tile, zeros past `rows`
template <typename T, int D, int KB>
__device__ __forceinline__ void load_tile(T* dst, int ld, const T* src,
                                          long long row_stride, int row0,
                                          int rows, int tid) {
  constexpr int kVec = 16 / (int)sizeof(T);
  constexpr int kPerRow = D / kVec;
  for (int u = tid; u < KB * kPerRow; u += kThreads) {
    const int r = u / kPerRow, c = (u % kPerRow) * kVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < rows)
      val = *reinterpret_cast<const uint4*>(src + (row0 + r) * row_stride + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

// f32 [KB] row values (lse or D) of one head, 0 past `rows`
template <int KB>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int row0, int rows, int tid) {
  for (int r = tid; r < KB; r += kThreads)
    dst[r] = row0 + r < rows ? src[row0 + r] : 0.f;
}

// --- C[M, N] (+)= A[M, K] B[K, N], C f32 in shared memory -------------
// A(i, k) = A_ROW ? A[i * lda + k] : A[k * lda + i]
// B(k, j) = B_ROW ? B[k * ldb + j] : B[j * ldb + k]
// A and B are f32 or bf16, widened to f32 as they are read.

template <bool A_ROW, bool B_ROW, int M, int N, int K, typename TA,
          typename TB>
__device__ __forceinline__ void tile_gemm(const TA* A, int lda, const TB* B,
                                          int ldb, float* C, int ldc,
                                          bool accumulate, int tid) {
  constexpr int kRows = M / 8;
  constexpr int kCols = N / 16;
  const int tx = tid & 15, ty = tid >> 4;      // rows ty + 8 i, cols tx + 16 j
  float c[kRows][kCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      c[i][j] = accumulate ? C[(ty + 8 * i) * ldc + tx + 16 * j] : 0.f;
#pragma unroll 4
  for (int kk = 0; kk < K; ++kk) {
    float a[kRows], bv[kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
      a[i] = to_f(A_ROW ? A[(ty + 8 * i) * lda + kk]
                        : A[kk * lda + ty + 8 * i]);
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      bv[j] = to_f(B_ROW ? B[kk * ldb + tx + 16 * j]
                         : B[(tx + 16 * j) * ldb + kk]);
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) c[i][j] = fmaf(a[i], bv[j], c[i][j]);
  }
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) C[(ty + 8 * i) * ldc + tx + 16 * j] = c[i][j];
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(~0u, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(~0u, x, o);
  return x;
}

__device__ __forceinline__ bool visible(int qpos, int kpos, int sq, int sk,
                                        int causal) {
  return qpos < sq && kpos < sk && (!causal || qpos >= kpos);
}

// --- forward: one block per (b*h, query tile) -----------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const Params p) {
  using G = Geo<T, D>;
  constexpr int kB = G::kB;
  constexpr int kRowsPerWarp = kB / 4;
  constexpr int kKeys = kB / 32;                // keys a lane
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* Ks = reinterpret_cast<T*>(smem + G::kTile);
  T* Vs = reinterpret_cast<T*>(smem + 2 * G::kTile);
  float* Ss = reinterpret_cast<float*>(smem + 3 * G::kTile);
  // P over S in place in f32, a tile of its own in bf16
  T* Ps = reinterpret_cast<T*>(G::kHalf ? smem + 3 * G::kTile + G::kS
                                        : smem + 3 * G::kTile);
  float* Os = reinterpret_cast<float*>(smem + 3 * G::kTile + G::kS + G::kP);
  float* m_s = Os + kB * G::kLdO;
  float* l_s = m_s + kB;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.x, qt = blockIdx.y, cb = blockIdx.z;
  const int bi = bh / p.h, hi = bh % p.h;
  const int i0 = qt * kB;
  const T* q = static_cast<const T*>(p.q) + bi * p.qs[0] + hi * p.qs[2];
  const T* k = static_cast<const T*>(p.k) + bi * p.ks[0] + hi * p.ks[2];
  const T* v = static_cast<const T*>(p.v) + bi * p.vs[0] + hi * p.vs[2];

  if (p.nch == 1) load_tile<T, D, kB>(Qs, G::kLdT, q, p.qs[1], i0, p.sq, tid);
  for (int u = tid; u < kB * D; u += kThreads)
    Os[(u / D) * G::kLdO + u % D] = 0.f;
  for (int r = tid; r < kB; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  const int n_kt = (p.sk + kB - 1) / kB;
  const int kt_end = p.causal ? min(n_kt, qt + 1) : n_kt;
  for (int kt = 0; kt < kt_end; ++kt) {
    const int j0 = kt * kB;
    // S = sum over the chunks of Q_c K_c^T; V_cb for P V
    for (int c = 0; c < p.nch; ++c) {
      if (p.nch > 1)
        load_tile<T, D, kB>(Qs, G::kLdT, q + c * D, p.qs[1], i0, p.sq, tid);
      load_tile<T, D, kB>(Ks, G::kLdT, k + c * D, p.ks[1], j0, p.sk, tid);
      if (c == 0)
        load_tile<T, D, kB>(Vs, G::kLdT, v + cb * D, p.vs[1], j0, p.sk, tid);
      __syncthreads();
      tile_gemm<true, false, kB, kB, D>(Qs, G::kLdT, Ks, G::kLdT, Ss,
                                        G::kLdS, c > 0, tid);
      __syncthreads();
    }
    // the online-softmax update, one warp per kB / 4 rows, kB / 32 keys a
    // lane
    for (int r = warp * kRowsPerWarp; r < (warp + 1) * kRowsPerWarp; ++r) {
      const int qpos = i0 + r;
      float s[kKeys];
      bool vis[kKeys];
      float mx = kNegInf;
#pragma unroll
      for (int t = 0; t < kKeys; ++t) {
        const int c = lane + 32 * t;
        vis[t] = visible(qpos, j0 + c, p.sq, p.sk, p.causal);
        s[t] = vis[t] ? Ss[r * G::kLdS + c] * p.scale : kNegInf;
        mx = fmaxf(mx, s[t]);
      }
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, warp_max(mx));
      float pr[kKeys], psum = 0.f;
#pragma unroll
      for (int t = 0; t < kKeys; ++t) {
        pr[t] = vis[t] ? expf(s[t] - m_new) : 0.f;
        psum += pr[t];
      }
      const float corr = expf(m_old - m_new);
      const float rowsum = warp_sum(psum);
      __syncwarp();     // every lane has read its S before P goes over it
#pragma unroll
      for (int t = 0; t < kKeys; ++t)
        Ps[r * G::kLdP + lane + 32 * t] = from_f<T>(pr[t]);
      if (lane == 0) {
        l_s[r] = l_s[r] * corr + rowsum;
        m_s[r] = m_new;
      }
      for (int c = lane; c < D; c += 32) Os[r * G::kLdO + c] *= corr;
    }
    __syncthreads();
    tile_gemm<true, true, kB, D, kB>(Ps, G::kLdP, Vs, G::kLdT, Os, G::kLdO,
                                     true, tid);
    __syncthreads();
  }
  T* o = static_cast<T*>(p.o);
  for (int u = tid; u < kB * D; u += kThreads) {
    const int r = u / D, c = u % D;
    if (i0 + r < p.sq) {
      const float l = fmaxf(l_s[r], 1e-30f);
      o[(((long long)bi * p.sq + i0 + r) * p.h + hi) * p.d + cb * D + c] =
          from_f<T>(Os[r * G::kLdO + c] / l);
    }
  }
  for (int r = tid; r < kB; r += kThreads)
    if (cb == 0 && i0 + r < p.sq)
      p.lse[(long long)bh * p.sq + i0 + r] =
          m_s[r] + logf(fmaxf(l_s[r], 1e-30f));
}

// P and dS of one [kB query, kB key] tile from S and dP (f32, in Ss and
// DPs), written as T into Ps (when WRITE_P) and DSs, which alias Ss and
// DPs in f32 (each thread reads an element before it writes it) and have
// tiles of their own in bf16
template <typename T, int D, bool WRITE_P>
__device__ __forceinline__ void p_and_ds(const float* Ss, const float* DPs,
                                         T* Ps, T* DSs, const float* lse_s,
                                         const float* delta_s, int i0,
                                         int j0, const Params& p, int tid) {
  using G = Geo<T, D>;
  constexpr int kB = G::kB;
  for (int u = tid; u < kB * kB; u += kThreads) {
    const int r = u / kB, c = u % kB;
    const bool vis = visible(i0 + r, j0 + c, p.sq, p.sk, p.causal);
    const float s = Ss[r * G::kLdS + c] * p.scale;
    const float pr = vis ? expf(s - lse_s[r]) : 0.f;
    const float ds = (pr * (DPs[r * G::kLdS + c] - delta_s[r])) * p.scale;
    if (WRITE_P) Ps[r * G::kLdP + c] = from_f<T>(pr);
    DSs[r * G::kLdP + c] = from_f<T>(ds);
  }
}

// --- dQ: one block per (b*h, query tile) ---------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const Params p) {
  using G = Geo<T, D>;
  constexpr int kB = G::kB;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* dOs = reinterpret_cast<T*>(smem + G::kTile);
  T* Ks = reinterpret_cast<T*>(smem + 2 * G::kTile);
  T* Vs = reinterpret_cast<T*>(smem + 3 * G::kTile);
  float* Ss = reinterpret_cast<float*>(smem + 4 * G::kTile);
  float* DPs = reinterpret_cast<float*>(smem + 4 * G::kTile + G::kS);
  // dS over dP in place in f32, a tile of its own in bf16
  T* DSs = reinterpret_cast<T*>(smem + 4 * G::kTile + G::kS +
                                (G::kHalf ? G::kS : 0));
  float* dQs =
      reinterpret_cast<float*>(smem + 4 * G::kTile + 2 * G::kS + G::kP);
  float* lse_s = dQs + kB * G::kLdO;
  float* delta_s = lse_s + kB;

  const int tid = threadIdx.x;
  const int bh = blockIdx.x, qt = blockIdx.y, cb = blockIdx.z;
  const int bi = bh / p.h, hi = bh % p.h;
  const int i0 = qt * kB;
  const long long hd = (long long)p.h * p.d;   // row stride of dO and dQ
  const T* q = static_cast<const T*>(p.q) + bi * p.qs[0] + hi * p.qs[2];
  const T* k = static_cast<const T*>(p.k) + bi * p.ks[0] + hi * p.ks[2];
  const T* v = static_cast<const T*>(p.v) + bi * p.vs[0] + hi * p.vs[2];
  const T* dout = static_cast<const T*>(p.dout) + (long long)bi * p.sq * hd
                  + (long long)hi * p.d;

  if (p.nch == 1) {
    load_tile<T, D, kB>(Qs, G::kLdT, q, p.qs[1], i0, p.sq, tid);
    load_tile<T, D, kB>(dOs, G::kLdT, dout, hd, i0, p.sq, tid);
  }
  load_rows<kB>(lse_s, p.lse_in + (long long)bh * p.sq, i0, p.sq, tid);
  load_rows<kB>(delta_s, p.delta + (long long)bh * p.sq, i0, p.sq, tid);
  for (int u = tid; u < kB * D; u += kThreads)
    dQs[(u / D) * G::kLdO + u % D] = 0.f;
  const int n_kt = (p.sk + kB - 1) / kB;
  const int kt_end = p.causal ? min(n_kt, qt + 1) : n_kt;
  for (int kt = 0; kt < kt_end; ++kt) {
    const int j0 = kt * kB;
    // S and dP: sums over the chunks of Q_c K_c^T and dO_c V_c^T
    for (int c = 0; c < p.nch; ++c) {
      if (p.nch > 1) {
        load_tile<T, D, kB>(Qs, G::kLdT, q + c * D, p.qs[1], i0, p.sq, tid);
        load_tile<T, D, kB>(dOs, G::kLdT, dout + c * D, hd, i0, p.sq, tid);
      }
      load_tile<T, D, kB>(Ks, G::kLdT, k + c * D, p.ks[1], j0, p.sk, tid);
      load_tile<T, D, kB>(Vs, G::kLdT, v + c * D, p.vs[1], j0, p.sk, tid);
      __syncthreads();
      tile_gemm<true, false, kB, kB, D>(Qs, G::kLdT, Ks, G::kLdT, Ss,
                                        G::kLdS, c > 0, tid);
      tile_gemm<true, false, kB, kB, D>(dOs, G::kLdT, Vs, G::kLdT, DPs,
                                        G::kLdS, c > 0, tid);
      __syncthreads();
    }
    // K_cb for dS K, unless the last chunk was cb (p_and_ds reads no K)
    if (cb != p.nch - 1)
      load_tile<T, D, kB>(Ks, G::kLdT, k + cb * D, p.ks[1], j0, p.sk, tid);
    p_and_ds<T, D, false>(Ss, DPs, nullptr, DSs, lse_s, delta_s, i0, j0, p,
                          tid);
    __syncthreads();
    tile_gemm<true, true, kB, D, kB>(DSs, G::kLdP, Ks, G::kLdT, dQs,
                                     G::kLdO, true, tid);
    __syncthreads();
  }
  T* dq = static_cast<T*>(p.dq) + (long long)bi * p.sq * hd +
          (long long)hi * p.d + cb * D;
  for (int u = tid; u < kB * D; u += kThreads) {
    const int r = u / D, c = u % D;
    if (i0 + r < p.sq) dq[(i0 + r) * hd + c] = from_f<T>(dQs[r * G::kLdO + c]);
  }
}

// --- dK, dV: one block per (b*h, key tile) -------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const Params p) {
  using G = Geo<T, D>;
  constexpr int kB = G::kB;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem);
  T* Vs = reinterpret_cast<T*>(smem + G::kTile);
  T* Qs = reinterpret_cast<T*>(smem + 2 * G::kTile);
  T* dOs = reinterpret_cast<T*>(smem + 3 * G::kTile);
  float* Ss = reinterpret_cast<float*>(smem + 4 * G::kTile);
  float* DPs = reinterpret_cast<float*>(smem + 4 * G::kTile + G::kS);
  unsigned char* after_s = smem + 4 * G::kTile + 2 * G::kS;
  // P and dS over S and dP in place in f32, tiles of their own in bf16
  T* Ps = G::kHalf ? reinterpret_cast<T*>(after_s)
                   : reinterpret_cast<T*>(Ss);
  T* DSs = G::kHalf ? reinterpret_cast<T*>(after_s + G::kP)
                    : reinterpret_cast<T*>(DPs);
  float* dKs = reinterpret_cast<float*>(after_s + 2 * G::kP);
  float* dVs = dKs + kB * G::kLdO;
  float* lse_s = dVs + kB * G::kLdO;
  float* delta_s = lse_s + kB;

  const int tid = threadIdx.x;
  const int bh = blockIdx.x, kt = blockIdx.y, cb = blockIdx.z;
  const int bi = bh / p.h, hi = bh % p.h;
  const int j0 = kt * kB;
  const long long hd = (long long)p.h * p.d;
  const T* q = static_cast<const T*>(p.q) + bi * p.qs[0] + hi * p.qs[2];
  const T* k = static_cast<const T*>(p.k) + bi * p.ks[0] + hi * p.ks[2];
  const T* v = static_cast<const T*>(p.v) + bi * p.vs[0] + hi * p.vs[2];
  const T* dout = static_cast<const T*>(p.dout) + (long long)bi * p.sq * hd
                  + (long long)hi * p.d;

  if (p.nch == 1) {
    load_tile<T, D, kB>(Ks, G::kLdT, k, p.ks[1], j0, p.sk, tid);
    load_tile<T, D, kB>(Vs, G::kLdT, v, p.vs[1], j0, p.sk, tid);
  }
  for (int u = tid; u < kB * D; u += kThreads) {
    dKs[(u / D) * G::kLdO + u % D] = 0.f;
    dVs[(u / D) * G::kLdO + u % D] = 0.f;
  }
  const int n_qt = (p.sq + kB - 1) / kB;
  for (int qt = p.causal ? kt : 0; qt < n_qt; ++qt) {
    const int i0 = qt * kB;
    // S and dP: sums over the chunks of Q_c K_c^T and dO_c V_c^T
    for (int c = 0; c < p.nch; ++c) {
      if (p.nch > 1) {
        load_tile<T, D, kB>(Ks, G::kLdT, k + c * D, p.ks[1], j0, p.sk, tid);
        load_tile<T, D, kB>(Vs, G::kLdT, v + c * D, p.vs[1], j0, p.sk, tid);
      }
      load_tile<T, D, kB>(Qs, G::kLdT, q + c * D, p.qs[1], i0, p.sq, tid);
      load_tile<T, D, kB>(dOs, G::kLdT, dout + c * D, hd, i0, p.sq, tid);
      if (c == 0) {
        load_rows<kB>(lse_s, p.lse_in + (long long)bh * p.sq, i0, p.sq,
                      tid);
        load_rows<kB>(delta_s, p.delta + (long long)bh * p.sq, i0, p.sq,
                      tid);
      }
      __syncthreads();
      tile_gemm<true, false, kB, kB, D>(Qs, G::kLdT, Ks, G::kLdT, Ss,
                                        G::kLdS, c > 0, tid);
      tile_gemm<true, false, kB, kB, D>(dOs, G::kLdT, Vs, G::kLdT, DPs,
                                        G::kLdS, c > 0, tid);
      __syncthreads();
    }
    // Q_cb and dO_cb for the products, unless the last chunk was cb
    // (p_and_ds reads neither)
    if (cb != p.nch - 1) {
      load_tile<T, D, kB>(Qs, G::kLdT, q + cb * D, p.qs[1], i0, p.sq, tid);
      load_tile<T, D, kB>(dOs, G::kLdT, dout + cb * D, hd, i0, p.sq, tid);
    }
    p_and_ds<T, D, true>(Ss, DPs, Ps, DSs, lse_s, delta_s, i0, j0, p, tid);
    __syncthreads();
    // dV += P^T dO and dK += dS^T Q: the [query, key] tiles read transposed
    tile_gemm<false, true, kB, D, kB>(Ps, G::kLdP, dOs, G::kLdT, dVs,
                                      G::kLdO, true, tid);
    tile_gemm<false, true, kB, D, kB>(DSs, G::kLdP, Qs, G::kLdT, dKs,
                                      G::kLdO, true, tid);
    __syncthreads();
  }
  T* dk = static_cast<T*>(p.dk) + (long long)bi * p.sk * hd +
          (long long)hi * p.d + cb * D;
  T* dv = static_cast<T*>(p.dv) + (long long)bi * p.sk * hd +
          (long long)hi * p.d + cb * D;
  for (int u = tid; u < kB * D; u += kThreads) {
    const int r = u / D, c = u % D;
    if (j0 + r < p.sk) {
      dk[(j0 + r) * hd + c] = from_f<T>(dKs[r * G::kLdO + c]);
      dv[(j0 + r) * hd + c] = from_f<T>(dVs[r * G::kLdO + c]);
    }
  }
}

enum Which { kFwd, kDq, kDkv };

template <typename T, int D>
int launch(Which which, const Params& p, cudaStream_t stream) {
  using G = Geo<T, D>;
  constexpr int kB = G::kB;
  void (*kernel)(const Params);
  int smem, tiles;
  if (which == kFwd) {
    kernel = flash_fwd_kernel<T, D>;
    smem = G::fwd;
    tiles = (p.sq + kB - 1) / kB;
  } else if (which == kDq) {
    kernel = flash_dq_kernel<T, D>;
    smem = G::dq;
    tiles = (p.sq + kB - 1) / kB;
  } else {
    kernel = flash_dkv_kernel<T, D>;
    smem = G::dkv;
    tiles = (p.sk + kB - 1) / kB;
  }
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (tiles == 0 || p.b * p.h == 0) return 0;
  kernel<<<dim3(p.b * p.h, tiles, p.nch), kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// the kernels of this file: float32 at head dims 64, 128 and 256, bf16
// at 256, and both at a multiple of 256 above it (the 256 case over d /
// 256 chunks)
int dispatch(Which which, Params& p, int d, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  p.d = d;
  p.nch = d > 256 && d % 256 == 0 ? d / 256 : 1;
  if (is_bf16) {
    if (d == 256 || p.nch > 1) return launch<bf16, 256>(which, p, s);
  } else {
    if (d == 64) return launch<float, 64>(which, p, s);
    if (d == 128) return launch<float, 128>(which, p, s);
    if (d == 256 || p.nch > 1) return launch<float, 256>(which, p, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

Params make_params(const void* q, const void* k, const void* v, int b, int h,
                   int sq, int sk, long long qsb, long long qss,
                   long long qsh, long long ksb, long long kss, long long ksh,
                   long long vsb, long long vss, long long vsh, float scale,
                   int causal) {
  Params p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.qs[0] = qsb; p.qs[1] = qss; p.qs[2] = qsh;
  p.ks[0] = ksb; p.ks[1] = kss; p.ks[2] = ksh;
  p.vs[0] = vsb; p.vs[1] = vss; p.vs[2] = vsh;
  p.b = b;
  p.h = h;
  p.sq = sq;
  p.sk = sk;
  p.scale = scale;
  p.causal = causal;
  return p;
}

}  // namespace

namespace thb {
int flash_fwd_sm90(const void* q, const void* k, const void* v, void* o,
                   void* lse, int b, int h, int sq, int sk, int d,
                   const long long* qs, const long long* ks,
                   const long long* vs, float scale, int causal,
                   cudaStream_t stream);
int flash_dq_sm90(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* delta,
                  void* dq, int b, int h, int sq, int sk, int d,
                  const long long* qs, const long long* ks,
                  const long long* vs, float scale, int causal,
                  cudaStream_t stream);
int flash_dkv_sm90(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dk, void* dv, int b, int h, int sq, int sk, int d,
                   const long long* qs, const long long* ks,
                   const long long* vs, float scale, int causal,
                   cudaStream_t stream);
}  // namespace thb

// Each entry returns cudaGetLastError() after its launch (0 when it was
// accepted), or cudaErrorInvalidValue for a head dim other than 64, 128,
// 256 or a multiple of 256.  Strides are in elements: batch, sequence,
// head, for q, k and v.  bf16 at head dims 64 and 128 runs the wgmma kernels
// (flash_fwd_sm90.cu, flash_bwd_sm90.cu), everything else this file's;
// *design is set to the one that ran: 2 wgmma, 1 FMA.

extern "C" int thb_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse, int b,
    int h, int sq, int sk, int d, long long qsb, long long qss, long long qsh,
    long long ksb, long long kss, long long ksh, long long vsb, long long vss,
    long long vsh, float scale, int causal, int is_bf16, int* design,
    void* stream) {
  Params p = make_params(q, k, v, b, h, sq, sk, qsb, qss, qsh, ksb, kss, ksh,
                         vsb, vss, vsh, scale, causal);
  if (is_bf16 && d <= 128) {
    *design = 2;
    return thb::flash_fwd_sm90(q, k, v, o, lse, b, h, sq, sk, d, p.qs, p.ks,
                               p.vs, scale, causal,
                               static_cast<cudaStream_t>(stream));
  }
  *design = 1;
  p.o = o;
  p.lse = static_cast<float*>(lse);
  return dispatch(kFwd, p, d, is_bf16, stream);
}

extern "C" int thb_flash_attention_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int b, int h, int sq,
    int sk, int d, long long qsb, long long qss, long long qsh, long long ksb,
    long long kss, long long ksh, long long vsb, long long vss, long long vsh,
    float scale, int causal, int is_bf16, int* design, void* stream) {
  Params p = make_params(q, k, v, b, h, sq, sk, qsb, qss, qsh, ksb, kss, ksh,
                         vsb, vss, vsh, scale, causal);
  if (is_bf16 && d <= 128) {
    *design = 2;
    return thb::flash_dq_sm90(q, k, v, dout, lse, delta, dq, b, h, sq, sk, d,
                              p.qs, p.ks, p.vs, scale, causal,
                              static_cast<cudaStream_t>(stream));
  }
  *design = 1;
  p.dout = dout;
  p.lse_in = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq = dq;
  return dispatch(kDq, p, d, is_bf16, stream);
}

extern "C" int thb_flash_attention_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int b, int h,
    int sq, int sk, int d, long long qsb, long long qss, long long qsh,
    long long ksb, long long kss, long long ksh, long long vsb, long long vss,
    long long vsh, float scale, int causal, int is_bf16, int* design,
    void* stream) {
  Params p = make_params(q, k, v, b, h, sq, sk, qsb, qss, qsh, ksb, kss, ksh,
                         vsb, vss, vsh, scale, causal);
  if (is_bf16 && d <= 128) {
    *design = 2;
    return thb::flash_dkv_sm90(q, k, v, dout, lse, delta, dk, dv, b, h, sq,
                               sk, d, p.qs, p.ks, p.vs, scale, causal,
                               static_cast<cudaStream_t>(stream));
  }
  *design = 1;
  p.dout = dout;
  p.lse_in = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dk = dk;
  p.dv = dv;
  return dispatch(kDkv, p, d, is_bf16, stream);
}
