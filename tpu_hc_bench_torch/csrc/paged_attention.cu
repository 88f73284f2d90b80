// Paged single-query decode attention for Hopper (sm_90a), split over the
// page table (the flash-decoding form): two kernels a call.
//
// Replaces: tpu_hc_bench/ops/paged_attention.py, the Pallas kernel
// `_kernel` reached from `paged_decode_attention`.
//
// What bounds it on an H100: at decode widths, latency; at long context,
// bytes.  Every cached token of a row is read once per kv head (K and V,
// head_dim values each) and used by the `heads / kv_heads` query rows of
// its group: 4 * group operations per pair of values, far below the ~20
// f32 operations per byte at which the card's f32 rate would take over
// from its memory rate.  At llama_1b's decode shape (8 rows, 8 kv heads,
// <= 576 keys) the bytes take ~2 us at 3.35 TB/s, so what costs is the
// chain of dependent loads in each block and the number of blocks in
// flight; with thousands of keys a row the bytes take over.
//
// What the design does about it:
// - Split the page loop.  The grid is (row, kv head x group tile, split):
//   each block takes a contiguous range of table slots (a multiple of
//   `pages_per_block`, ops/paged_attention.py `paged_splits` chooses the
//   count to fill about four blocks an SM) and writes its partial
//   (m, l, acc[group, d]) to a float32 workspace.  A second small kernel
//   merges the splits of each (row, kv head) in split order: no atomics,
//   the same bits every run.  Splits past the row's length are not
//   launched into the merge (`live`), so a row reads the pages its length
//   covers and no more.
// - 16-byte loads, no division per element.  A warp reads whole token
//   rows of K and V: LPT lanes a row, 16 bytes a lane (4 f32, 8 bf16 or
//   16 int8 values), TPW rows an instruction.  A token's page index and
//   pool offset are computed once per token by the lanes that read it.
// - The group's query rows stay in registers (each lane holds its slice
//   of every row), scores are warp-shuffle sums over a token's lanes,
//   and p and the accumulator stay in registers: each warp keeps its own
//   running max (uniform across the warp), each lane its own sums over
//   the tokens it read; they are merged across lanes and then across the
//   four warps once, at the end of the split.
// - Register prefetch: the K and V rows of a warp's next chunk are loaded
//   before the current chunk's math, and the page indices of the chunk
//   after that before those loads, so a chunk's two dependent loads
//   (table, then pool) overlap the work of the two chunks before it.
// - int8 pools are dequantized with their per-(layer, page) scale as each
//   value is read; the dequantized cache never exists in device memory.
//
// Numerics, as the TPU kernel: f32 sums, masked scores -1e30,
// probabilities masked again after exp, l floored at 1e-30, lse = m +
// log(l); for a bf16 pool p is rounded to bf16 before P V (l sums the
// unrounded p).  A row of length 0 gives out 0 and lse ~ -1e30, finite.
// Slots past the table width (up to the width padded to a multiple of
// `pages_per_block`) read the trash page 0, as the TPU kernel's padded
// table does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
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
  float scale;
};

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
template <typename T, int D, int G>
__global__ void __launch_bounds__(kThreads)
paged_decode_split_kernel(const Params p) {
  using Y = Lay<T, D>;
  constexpr int V = Y::V, LPT = Y::LPT, VPL = Y::VPL, TPW = Y::TPW;
  constexpr int NI = Y::NI, CT = Y::CT;
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
        if (g0 + g < p.group) {
          const size_t i = (qrow0 + g) * D + col;
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
            (((layer_page0 + pg[i]) * p.ps + pos) * p.kvh + h) * D;
#pragma unroll
        for (int vv = 0; vv < VPL; ++vv) {
          const size_t off = base + (size_t)(vv * LPT + sub) * V;
          kb[i][vv] = ldg16(kpool + off);
          vb[i][vv] = ldg16(vpool + off);
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
    if (g0 + g >= p.group) continue;
    float mx = kNegInf;
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) mx = fmaxf(mx, m_w[wi][g]);
    float a = 0.f;
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi)
      a += acc_w[wi][g][col] * expf(m_w[wi][g] - mx);
    p.ws_acc[(part + g) * D + col] = a;
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
template <typename T, int D>
int launch_split(const Params& p, int b, int g_tile, cudaStream_t s) {
  const dim3 grid(b, p.kvh * p.group_tiles, p.splits);
  if (g_tile == 1)
    paged_decode_split_kernel<T, D, 1><<<grid, kThreads, 0, s>>>(p);
  else if (g_tile == 2)
    paged_decode_split_kernel<T, D, 2><<<grid, kThreads, 0, s>>>(p);
  else if (g_tile == 4)
    paged_decode_split_kernel<T, D, 4><<<grid, kThreads, 0, s>>>(p);
  else if constexpr (sizeof(T) > 1) {
    if (g_tile != 8) return static_cast<int>(cudaErrorInvalidValue);
    paged_decode_split_kernel<T, D, 8><<<grid, kThreads, 0, s>>>(p);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_split_d(const Params& p, int b, int g_tile, cudaStream_t s) {
  switch (p.d) {
    case 16: return launch_split<T, 16>(p, b, g_tile, s);
    case 32: return launch_split<T, 32>(p, b, g_tile, s);
    case 64: return launch_split<T, 64>(p, b, g_tile, s);
    case 128: return launch_split<T, 128>(p, b, g_tile, s);
    case 256: return launch_split<T, 256>(p, b, g_tile, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// pool_dtype: 0 float32, 1 bfloat16, 2 int8 (with f32 scales); q is f32
// or (q_bf16) bf16, and out takes q's dtype.  Head dim 16, 32, 64, 128
// or 256, group
// tiles of 1, 2, 4 or 8 query rows (g_tile; int8 up to 4; a larger group
// runs in several tiles, each reading the K/V rows again).  ws_acc / ws_ml: float32 workspace of b * kvh * splits *
// group * (d, 2) values.  Returns cudaGetLastError() after the two
// launches (0 when both were accepted).
extern "C" int thb_paged_decode_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scales, const void* v_scales, const void* tables,
    const void* lengths, void* out, void* lse, void* ws_acc, void* ws_ml,
    int b, int heads, int kvh, int d, int pages, int ps, int w, int ppb,
    int layer, int splits, int slots_per_split, int g_tile, float scale,
    int pool_dtype, int q_bf16, void* stream) {
  Params p;
  p.q = q;
  p.k_pool = k_pool;
  p.v_pool = v_pool;
  p.k_scales = static_cast<const float*>(k_scales);
  p.v_scales = static_cast<const float*>(v_scales);
  p.tables = static_cast<const int32_t*>(tables);
  p.lengths = static_cast<const int32_t*>(lengths);
  p.out = out;
  p.lse = static_cast<float*>(lse);
  p.ws_acc = static_cast<float*>(ws_acc);
  p.ws_ml = static_cast<float*>(ws_ml);
  p.heads = heads;
  p.kvh = kvh;
  p.d = d;
  p.pages = pages;
  p.ps = ps;
  p.w = w;
  p.ppb = ppb;
  p.layer = layer;
  p.splits = splits;
  p.slots_per_split = slots_per_split;
  p.group = heads / kvh;
  p.group_tiles = (p.group + g_tile - 1) / g_tile;
  p.q_bf16 = q_bf16;
  p.scale = scale;
  if (g_tile > kMaxGroup || d > 1024 || b == 0)
    return b == 0 ? 0 : static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  switch (pool_dtype) {
    case 0: err = launch_split_d<float>(p, b, g_tile, s); break;
    case 1: err = launch_split_d<bf16>(p, b, g_tile, s); break;
    case 2: err = launch_split_d<int8_t>(p, b, g_tile, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err) return err;
  const int rows = 1024 / d < p.group ? 1024 / d : p.group;
  paged_decode_merge_kernel<<<dim3(b, kvh), dim3(d, rows), 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}
