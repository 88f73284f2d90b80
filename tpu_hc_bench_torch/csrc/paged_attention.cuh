// The split and merge kernels of paged decode attention, shared by
// paged_attention.cu (the template head dims 16, 32, 64, 128 and 256, and
// the C entry) and paged_attention_masked.cu (any other head dim up to
// 256 on the next listed case, masked), so the two compile in parallel.
// The design is described in paged_attention.cu.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace thb_paged {

constexpr int kMaxGroup = 8;      // query rows a block holds (a group tile)

struct Params {
  const void* q;          // [b, heads, d] f32 or bf16
  const void* k_pool;     // [L, pages, ps, kvh, d]
  const void* v_pool;
  const float* k_scales;  // [L, pages] (int8 only)
  const float* v_scales;
  const int32_t* tables;  // [b, w]
  const int32_t* lengths; // [b]
  void* out;              // [b, heads, d] in q's dtype
  float* lse;             // [b, heads]
  float* ws_acc;          // [b, kvh, splits, group, d]
  float* ws_ml;           // [b, kvh, splits, group, 2]: m, l
  int heads, kvh, d, pages, ps, w, ppb, layer, splits, slots_per_split;
  int group, group_tiles, q_bf16;
  int vec;                // 16-byte pool loads (masked case; else scalar)
  float scale;
};

// the split kernel of a head dim off the template list (MASK = true),
// compiled in paged_attention_masked.cu
int launch_split_masked(const Params& p, int b, int g_tile, int pool_dtype,
                        cudaStream_t s);

}  // namespace thb_paged

namespace {

using bf16 = __nv_bfloat16;
using thb_paged::Params;

constexpr float kNegInf = -1e30f;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

// the V = 16 / sizeof(T) values of one 16-byte vector, widened to f32
template <typename T, int V>
__device__ __forceinline__ void widen(const uint4& u, float* f);
template <>
__device__ __forceinline__ void widen<float, 4>(const uint4& u, float* f) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
template <>
__device__ __forceinline__ void widen<bf16, 8>(const uint4& u, float* f) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
template <>
__device__ __forceinline__ void widen<int8_t, 16>(const uint4& u, float* f) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      f[4 * i + j] = (float)(int8_t)((w[i] >> (8 * j)) & 0xffu);
}

__device__ __forceinline__ uint4 ldg16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

template <int S> struct RawOf;
template <> struct RawOf<4> { using T = unsigned int; };
template <> struct RawOf<2> { using T = unsigned short; };
template <> struct RawOf<1> { using T = unsigned char; };

// the masked case's load of one 16-byte vector of V values at p, of which
// n are in the row (the rest read as 0): one 16-byte load when the row
// holds all V and `vec`, else a scalar load a value
template <typename T, int V>
__device__ __forceinline__ uint4 ld_masked(const T* p, int n, int vec) {
  if (vec && n >= V) return ldg16(p);
  using R = typename RawOf<(int)sizeof(T)>::T;
  uint4 u = make_uint4(0u, 0u, 0u, 0u);
  R* r = reinterpret_cast<R*>(&u);
  const R* src = reinterpret_cast<const R*>(p);
#pragma unroll
  for (int e = 0; e < V; ++e)
    if (e < n) r[e] = __ldg(src + e);
  return u;
}

constexpr int cmin(int a, int b) { return a < b ? a : b; }
constexpr int cmax(int a, int b) { return a > b ? a : b; }

// Geometry of a warp's reads for pool type T and head dim D.
template <typename T, int D>
struct Lay {
  static constexpr int V = 16 / (int)sizeof(T);   // values a 16-byte load
  static constexpr int RV = D / V;                // loads a token row
  static_assert(D % V == 0, "head dim is not a whole number of vectors");
  static constexpr int LPT = RV < 32 ? RV : 32;   // lanes a token row
  static constexpr int VPL = RV / LPT;            // loads a lane a row
  static constexpr int TPW = 32 / LPT;            // rows a warp load
  // loads of K (and of V) a lane makes for a chunk: at most 4, and a
  // chunk of at most 16 tokens
  static constexpr int NI = cmax(1, cmin(4 / VPL, 16 / TPW));
  static constexpr int CT = NI * TPW;             // tokens a warp chunk
  static constexpr bool kQuant = sizeof(T) == 1;
  static constexpr bool kRoundP = sizeof(T) == 2;   // bf16: p to bf16
};

// One split of one (row, kv head, group tile): its partial softmax.
// MASK: a head dim d = p.d below the template's D: rows are d values
// apart, and the lanes past d read 0 (so their q.k terms and acc are 0)
// and store nothing.
template <typename T, int D, int G, bool MASK>
__global__ void __launch_bounds__(kThreads)
paged_decode_split_kernel(const Params p) {
  using Y = Lay<T, D>;
  constexpr int V = Y::V, LPT = Y::LPT, VPL = Y::VPL, TPW = Y::TPW;
  constexpr int NI = Y::NI, CT = Y::CT;
  const int dd = MASK ? p.d : D;              // the rows' stride
  __shared__ float m_w[kWarps][G], l_w[kWarps][G];
  __shared__ float acc_w[kWarps][G][D];

  const int row = blockIdx.x;
  const int h = blockIdx.y / p.group_tiles;
  const int g0 = (blockIdx.y - h * p.group_tiles) * G;
  const int split = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int sub = lane % LPT;                 // the lane's slice of a row
  const int tok = lane / LPT;                 // the lane's row in a load

  const int span = p.slots_per_split * p.ps;  // tokens a split
  const int t_end_all = min(p.lengths[row],
                            ((p.w + p.ppb - 1) / p.ppb) * p.ppb * p.ps);
  const int tb = split * span;
  const int te = min(tb + span, t_end_all);
  if (tb >= te) return;                       // past the row: not merged

  // the group tile's query rows, this lane's slice of each
  float qf[G][VPL][V];
  const size_t qrow0 = (size_t)row * p.heads + (size_t)h * p.group + g0;
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int vv = 0; vv < VPL; ++vv)
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const int col = (vv * LPT + sub) * V + e;
        float x = 0.f;
        if (g0 + g < p.group && (!MASK || col < dd)) {
          const size_t i = (qrow0 + g) * dd + col;
          x = p.q_bf16 ? to_f(static_cast<const bf16*>(p.q)[i])
                       : static_cast<const float*>(p.q)[i];
        }
        qf[g][vv][e] = x;
      }

  float acc[G][VPL][V], l[G], m[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int vv = 0; vv < VPL; ++vv)
#pragma unroll
      for (int e = 0; e < V; ++e) acc[g][vv][e] = 0.f;
  }

  const T* kpool = static_cast<const T*>(p.k_pool);
  const T* vpool = static_cast<const T*>(p.v_pool);
  const int32_t* table = p.tables + (size_t)row * p.w;
  const size_t layer_page0 = (size_t)p.layer * p.pages;
  const int n_chunks = (te - tb + CT - 1) / CT;

  // the page index of each of this lane's tokens of chunk c (-1 past te)
  auto pages_of = [&](int c, int* pg) {
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int t = tb + c * CT + i * TPW + tok;
      int page = -1;
      if (c < n_chunks && t < te) {
        const int slot = t / p.ps;
        page = slot < p.w ? __ldg(table + slot) : 0;
      }
      pg[i] = page;
    }
  };
  // the K and V vectors (and int8 scales) of chunk c's tokens
  auto load = [&](int c, const int* pg, uint4 (*kb)[VPL], uint4 (*vb)[VPL],
                  float* ks, float* vs) {
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int t = tb + c * CT + i * TPW + tok;
      if (pg[i] >= 0) {
        const int pos = t - (t / p.ps) * p.ps;
        const size_t base =
            (((layer_page0 + pg[i]) * p.ps + pos) * p.kvh + h) * dd;
#pragma unroll
        for (int vv = 0; vv < VPL; ++vv) {
          const int col0 = (vv * LPT + sub) * V;
          const size_t off = base + col0;
          if (MASK) {
            kb[i][vv] = ld_masked<T, V>(kpool + off, dd - col0, p.vec);
            vb[i][vv] = ld_masked<T, V>(vpool + off, dd - col0, p.vec);
          } else {
            kb[i][vv] = ldg16(kpool + off);
            vb[i][vv] = ldg16(vpool + off);
          }
        }
        if (Y::kQuant) {
          ks[i] = __ldg(p.k_scales + layer_page0 + pg[i]);
          vs[i] = __ldg(p.v_scales + layer_page0 + pg[i]);
        }
      } else {
#pragma unroll
        for (int vv = 0; vv < VPL; ++vv)
          kb[i][vv] = vb[i][vv] = make_uint4(0u, 0u, 0u, 0u);
        ks[i] = vs[i] = 0.f;
      }
    }
  };

  // warp `warp` takes chunks warp, warp + kWarps, ...: three stages in
  // flight (page indices of c + 2 kWarps, K/V of c + kWarps, math on c);
  // a page index of -1 marks a token past the split (masked, not read)
  uint4 kb[NI][VPL], vb[NI][VPL], kn[NI][VPL], vn[NI][VPL];
  float ks[NI], vs[NI], ksn[NI], vsn[NI];
  int pgc[NI], pgn[NI], pgl[NI];
  int c = warp;
  pages_of(c, pgc);
  load(c, pgc, kb, vb, ks, vs);
  pages_of(c + kWarps, pgn);
  for (; c < n_chunks; c += kWarps) {
#pragma unroll
    for (int i = 0; i < NI; ++i) pgl[i] = pgn[i];
    load(c + kWarps, pgl, kn, vn, ksn, vsn);
    pages_of(c + 2 * kWarps, pgn);

    // scores of this lane's tokens for every query row of the tile
    float s[NI][G];
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      float kf[VPL][V];
#pragma unroll
      for (int vv = 0; vv < VPL; ++vv) {
        widen<T, V>(kb[i][vv], kf[vv]);
        if (Y::kQuant)
#pragma unroll
          for (int e = 0; e < V; ++e) kf[vv][e] *= ks[i];
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float acc_s = 0.f;
#pragma unroll
        for (int vv = 0; vv < VPL; ++vv)
#pragma unroll
          for (int e = 0; e < V; ++e)
            acc_s = fmaf(qf[g][vv][e], kf[vv][e], acc_s);
#pragma unroll
        for (int o = 1; o < LPT; o <<= 1)
          acc_s += __shfl_xor_sync(0xffffffffu, acc_s, o);
        s[i][g] = pgc[i] >= 0 ? acc_s * p.scale : kNegInf;
      }
    }
    // online softmax: the warp's running max, this lane's sums
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float mx = kNegInf;
#pragma unroll
      for (int i = 0; i < NI; ++i) mx = fmaxf(mx, s[i][g]);
#pragma unroll
      for (int o = LPT; o < 32; o <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[g], mx);
      const float corr = expf(m[g] - m_new);
      m[g] = m_new;
      l[g] *= corr;
#pragma unroll
      for (int vv = 0; vv < VPL; ++vv)
#pragma unroll
        for (int e = 0; e < V; ++e) acc[g][vv][e] *= corr;
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        // masked again after exp: a chunk with no visible token keeps
        // m == -1e30, where exp(s - m) would be 1
        const float pr = pgc[i] >= 0 ? expf(s[i][g] - m_new) : 0.f;
        l[g] += pr;
        s[i][g] = Y::kRoundP ? __bfloat162float(__float2bfloat16(pr)) : pr;
      }
    }
    // acc += p V
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      float vf[VPL][V];
#pragma unroll
      for (int vv = 0; vv < VPL; ++vv) {
        widen<T, V>(vb[i][vv], vf[vv]);
        if (Y::kQuant)
#pragma unroll
          for (int e = 0; e < V; ++e) vf[vv][e] *= vs[i];
      }
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int vv = 0; vv < VPL; ++vv)
#pragma unroll
          for (int e = 0; e < V; ++e)
            acc[g][vv][e] = fmaf(s[i][g], vf[vv][e], acc[g][vv][e]);
    }
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      pgc[i] = pgl[i];
      ks[i] = ksn[i];
      vs[i] = vsn[i];
#pragma unroll
      for (int vv = 0; vv < VPL; ++vv) {
        kb[i][vv] = kn[i][vv];
        vb[i][vv] = vn[i][vv];
      }
    }
  }

  // merge the lanes of the warp: sums over the rows of a load
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int o = LPT; o < 32; o <<= 1) {
      l[g] += __shfl_xor_sync(0xffffffffu, l[g], o);
#pragma unroll
      for (int vv = 0; vv < VPL; ++vv)
#pragma unroll
        for (int e = 0; e < V; ++e)
          acc[g][vv][e] += __shfl_xor_sync(0xffffffffu, acc[g][vv][e], o);
    }
    if (lane < LPT) {
#pragma unroll
      for (int vv = 0; vv < VPL; ++vv)
#pragma unroll
        for (int e = 0; e < V; ++e)
          acc_w[warp][g][(vv * LPT + sub) * V + e] = acc[g][vv][e];
    }
    if (lane == 0) {
      m_w[warp][g] = m[g];
      l_w[warp][g] = l[g];
    }
  }
  __syncthreads();

  // merge the warps, in warp order, into the split's partial
  const size_t part = (((size_t)row * p.kvh + h) * p.splits + split) *
                          p.group + g0;
  for (int u = tid; u < G * D; u += kThreads) {
    const int g = u / D, col = u - (u / D) * D;
    if (g0 + g >= p.group || (MASK && col >= dd)) continue;
    float mx = kNegInf;
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) mx = fmaxf(mx, m_w[wi][g]);
    float a = 0.f;
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi)
      a += acc_w[wi][g][col] * expf(m_w[wi][g] - mx);
    p.ws_acc[(part + g) * dd + col] = a;
    if (col == 0) {
      float lsum = 0.f;
#pragma unroll
      for (int wi = 0; wi < kWarps; ++wi)
        lsum += l_w[wi][g] * expf(m_w[wi][g] - mx);
      p.ws_ml[(part + g) * 2] = mx;
      p.ws_ml[(part + g) * 2 + 1] = lsum;
    }
  }
}

// Merge the live splits of each (row, kv head) in split order; write out
// (q's dtype) and lse.  Block (d, rows of the group), grid (row, kv head).
__global__ void paged_decode_merge_kernel(const Params p) {
  const int row = blockIdx.x, h = blockIdx.y;
  const int col = threadIdx.x;
  const int span = p.slots_per_split * p.ps;
  const int len = min(p.lengths[row],
                      ((p.w + p.ppb - 1) / p.ppb) * p.ppb * p.ps);
  const int live = min(p.splits, (max(len, 0) + span - 1) / span);
  const size_t part0 = ((size_t)row * p.kvh + h) * p.splits;
  for (int g = threadIdx.y; g < p.group; g += blockDim.y) {
    float mx = kNegInf;
    for (int s = 0; s < live; ++s)
      mx = fmaxf(mx, p.ws_ml[((part0 + s) * p.group + g) * 2]);
    float a = 0.f, lsum = 0.f;
    for (int s = 0; s < live; ++s) {
      const size_t i = (part0 + s) * p.group + g;
      const float c = expf(p.ws_ml[i * 2] - mx);
      a += p.ws_acc[i * p.d + col] * c;
      lsum += p.ws_ml[i * 2 + 1] * c;
    }
    const float l = fmaxf(lsum, 1e-30f);
    const size_t o = (size_t)row * p.heads + (size_t)h * p.group + g;
    if (p.q_bf16)
      static_cast<bf16*>(p.out)[o * p.d + col] = __float2bfloat16(a / l);
    else
      static_cast<float*>(p.out)[o * p.d + col] = a / l;
    if (col == 0) p.lse[o] = mx + logf(l);
  }
}

// group tiles of 1, 2, 4 or 8 query rows; int8 stops at 4 (16 values a
// lane: a tile of 8 would hold 256 f32 of q and acc a thread)
template <typename T, int D, bool MASK>
int launch_split(const Params& p, int b, int g_tile, cudaStream_t s) {
  const dim3 grid(b, p.kvh * p.group_tiles, p.splits);
  if (g_tile == 1)
    paged_decode_split_kernel<T, D, 1, MASK><<<grid, kThreads, 0, s>>>(p);
  else if (g_tile == 2)
    paged_decode_split_kernel<T, D, 2, MASK><<<grid, kThreads, 0, s>>>(p);
  else if (g_tile == 4)
    paged_decode_split_kernel<T, D, 4, MASK><<<grid, kThreads, 0, s>>>(p);
  else if constexpr (sizeof(T) > 1) {
    if (g_tile != 8) return static_cast<int>(cudaErrorInvalidValue);
    paged_decode_split_kernel<T, D, 8, MASK><<<grid, kThreads, 0, s>>>(p);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// the template case of head dim p.d: D == d exactly (MASK false), or the
// next listed D above d (MASK true)
template <typename T, bool MASK>
int launch_split_d(const Params& p, int b, int g_tile, cudaStream_t s) {
  const int d = p.d;
  if (MASK ? d < 16 : d == 16)
    return launch_split<T, 16, MASK>(p, b, g_tile, s);
  if (MASK ? d < 32 : d == 32)
    return launch_split<T, 32, MASK>(p, b, g_tile, s);
  if (MASK ? d < 64 : d == 64)
    return launch_split<T, 64, MASK>(p, b, g_tile, s);
  if (MASK ? d < 128 : d == 128)
    return launch_split<T, 128, MASK>(p, b, g_tile, s);
  if (MASK ? d < 256 : d == 256)
    return launch_split<T, 256, MASK>(p, b, g_tile, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

