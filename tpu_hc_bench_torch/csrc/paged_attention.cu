// Paged single-query decode attention for Hopper (sm_90a).
//
// Replaces: tpu_hc_bench/ops/paged_attention.py, the Pallas kernel
// `_kernel` reached from `paged_decode_attention`.
//
// What bounds it on an H100: bytes.  Every cached token of a row is read
// once per kv head (K and V, head_dim floats each) and used by the
// `heads / kv_heads` query rows of its group: 4 * group multiply-adds per
// byte pair, far below the ~20 f32 operations per byte at which the card's
// f32 rate (67 TFLOP/s) would take over from its memory rate (3.35 TB/s).
//
// What the design does about it:
// - One CUDA block per (request row, kv head).  The block holds the whole
//   GQA group of query rows, so each K/V byte leaves device memory once and
//   serves every query head that shares it.
// - The sequential page-block grid axis of the TPU kernel becomes a loop
//   inside the block over `pages_per_block` table slots at a time.  Each
//   slot is read through `tables[row, slot]`; nothing is gathered into a
//   dense cache first.
// - Tiles past the row's length are skipped, so a row reads the pages its
//   length covers and no more.
// - int8 pools are dequantized with their per-(layer, page) scale as the
//   tile is staged into shared memory, so the dequantized cache is never
//   written back to device memory.
// - Online softmax in f32 (running max m, sum l, accumulator acc), with
//   the TPU kernel's numerics held exactly: masked scores are -1e30,
//   probabilities are masked again after exp, l is floored at 1e-30 and
//   lse = m + log(l).  A row of length 0 gives out = 0 and lse ~ -1e30.
//
// This first version is plain CUDA: no TMA, no wgmma, no double buffering.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;

template <typename T>
__device__ __forceinline__ float load_as_float(const T* p) {
  return static_cast<float>(*p);
}

template <typename T>
__global__ void paged_decode_kernel(
    const float* __restrict__ q,          // [b, heads, d]
    const T* __restrict__ k_pool,         // [L, pages, ps, kvh, d]
    const T* __restrict__ v_pool,
    const float* __restrict__ k_scales,   // [L, pages] (int8 only)
    const float* __restrict__ v_scales,
    const int32_t* __restrict__ tables,   // [b, w]
    const int32_t* __restrict__ lengths,  // [b]
    float* __restrict__ out,              // [b, heads, d]
    float* __restrict__ lse,              // [b, heads]
    int heads, int kvh, int d, int pages, int ps, int w, int ppb,
    int layer, float scale, int quantized) {
  const int row = blockIdx.x;
  const int h = blockIdx.y;
  const int group = heads / kvh;
  const int tile = ppb * ps;             // tokens per loop step
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;

  extern __shared__ float smem[];
  float* ks = smem;                      // [tile, d]
  float* vs = ks + tile * d;             // [tile, d]
  float* qs = vs + tile * d;             // [group, d]
  float* acc = qs + group * d;           // [group, d]
  float* ss = acc + group * d;           // [group, tile] scores, then p
  float* m_s = ss + group * tile;        // [group] running max
  float* l_s = m_s + group;              // [group] running sum
  float* c_s = l_s + group;              // [group] rescale of this step

  const int length = lengths[row];
  const int32_t* table = tables + (size_t)row * w;
  const float* qrow = q + ((size_t)row * heads + (size_t)h * group) * d;

  for (int i = tid; i < group * d; i += blockDim.x) {
    qs[i] = qrow[i];
    acc[i] = 0.f;
  }
  for (int g = tid; g < group; g += blockDim.x) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }
  __syncthreads();

  const size_t page_stride = (size_t)ps * kvh * d;       // one page
  const size_t layer_base = (size_t)layer * pages * page_stride;
  const int nblocks = (w + ppb - 1) / ppb;

  for (int j = 0; j < nblocks; ++j) {
    const int start = j * tile;
    if (start >= length) break;          // the rest is past the cache depth

    // stage the tile's K/V rows for this kv head, slot by slot
    for (int i = tid; i < tile * d; i += blockDim.x) {
      const int t = i / d;
      const int dd = i - t * d;
      const int slot = j * ppb + t / ps;
      // slots past the table width read the trash page 0, as the
      // table padding of the TPU kernel does
      const int page = slot < w ? table[slot] : 0;
      const size_t off = layer_base + (size_t)page * page_stride +
                         ((size_t)(t % ps) * kvh + h) * d + dd;
      float kv_k = load_as_float(k_pool + off);
      float kv_v = load_as_float(v_pool + off);
      if (quantized) {
        kv_k *= k_scales[(size_t)layer * pages + page];
        kv_v *= v_scales[(size_t)layer * pages + page];
      }
      ks[i] = kv_k;
      vs[i] = kv_v;
    }
    __syncthreads();

    // scores for every (query row of the group, token of the tile)
    for (int i = tid; i < group * tile; i += blockDim.x) {
      const int g = i / tile;
      const int t = i - g * tile;
      const float* qg = qs + g * d;
      const float* kt = ks + t * d;
      float s = 0.f;
      for (int dd = 0; dd < d; ++dd) s += qg[dd] * kt[dd];
      ss[i] = (start + t < length) ? s * scale : kNegInf;
    }
    __syncthreads();

    // online-softmax statistics: one warp per query row
    for (int g = warp; g < group; g += nwarps) {
      float* sg = ss + g * tile;
      float mx = kNegInf;
      for (int t = lane; t < tile; t += 32) mx = fmaxf(mx, sg[t]);
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int t = lane; t < tile; t += 32) {
        // masked again after exp: a fully masked tile keeps m == -1e30,
        // where exp(s - m) would be 1
        const float p = (start + t < length) ? expf(sg[t] - m_new) : 0.f;
        sg[t] = p;
        sum += p;
      }
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        c_s[g] = corr;
        l_s[g] = l_s[g] * corr + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * corr + p @ V
    for (int i = tid; i < group * d; i += blockDim.x) {
      const int g = i / d;
      const int dd = i - g * d;
      const float* pg = ss + g * tile;
      float a = 0.f;
      for (int t = 0; t < tile; ++t) a += pg[t] * vs[t * d + dd];
      acc[i] = acc[i] * c_s[g] + a;
    }
    __syncthreads();
  }

  float* orow = out + ((size_t)row * heads + (size_t)h * group) * d;
  for (int i = tid; i < group * d; i += blockDim.x) {
    const float l = fmaxf(l_s[i / d], 1e-30f);
    orow[i] = acc[i] / l;
  }
  for (int g = tid; g < group; g += blockDim.x) {
    const float l = fmaxf(l_s[g], 1e-30f);
    lse[(size_t)row * heads + (size_t)h * group + g] = m_s[g] + logf(l);
  }
}

size_t smem_bytes(int group, int d, int tile) {
  return sizeof(float) *
         ((size_t)2 * tile * d + (size_t)2 * group * d +
          (size_t)group * tile + (size_t)3 * group);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 when it was accepted).
extern "C" int thb_paged_decode_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scales, const void* v_scales, const void* tables,
    const void* lengths, void* out, void* lse, int b, int heads, int kvh,
    int d, int pages, int ps, int w, int ppb, int layer, float scale,
    int quantized, void* stream) {
  const int group = heads / kvh;
  const size_t smem = smem_bytes(group, d, ppb * ps);
  const dim3 grid(b, kvh);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (quantized) {
    auto kern = paged_decode_kernel<int8_t>;
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    kern<<<grid, kThreads, smem, s>>>(
        static_cast<const float*>(q), static_cast<const int8_t*>(k_pool),
        static_cast<const int8_t*>(v_pool),
        static_cast<const float*>(k_scales),
        static_cast<const float*>(v_scales),
        static_cast<const int32_t*>(tables),
        static_cast<const int32_t*>(lengths), static_cast<float*>(out),
        static_cast<float*>(lse), heads, kvh, d, pages, ps, w, ppb, layer,
        scale, 1);
  } else {
    auto kern = paged_decode_kernel<float>;
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    kern<<<grid, kThreads, smem, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k_pool),
        static_cast<const float*>(v_pool), nullptr, nullptr,
        static_cast<const int32_t*>(tables),
        static_cast<const int32_t*>(lengths), static_cast<float*>(out),
        static_cast<float*>(lse), heads, kvh, d, pages, ps, w, ppb, layer,
        scale, 0);
  }
  return static_cast<int>(cudaGetLastError());
}
