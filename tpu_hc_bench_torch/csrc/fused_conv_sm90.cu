// Fused BN-apply + relu + 3x3/s1 SAME conv + per-channel stats for Hopper
// (sm_90a), bf16, on wgmma.
//
// Replaces: tpu_hc_bench/ops/fused_conv.py, the Pallas kernel `_kernel`
// (:65) through `_fused_fwd_impl` (:98), for bf16 inputs with Cin a
// multiple of 64 and W <= 62; fused_conv.cu keeps float32 and the other
// bf16 shapes (the wrapper's shape rule, ops/fused_conv.py `conv_design`).
//
//   xn = relu(y1 * a + b)      (f32 mul then add, each rounded, to bf16)
//   acc = conv3x3(xn, w)       (zero halo AFTER BN+relu, f32 accumulate)
//   y2 = acc in bf16;  s1 = sum(acc), s2 = sum(acc^2) per channel
//
// Layouts: y1 [N,H,W,Cin], y2 [N,H,W,Cout] (NHWC), w [3,3,Cin,Cout]; a, b
// float32 [Cin]; part1/part2 float32 [tiles, Cout].
//
// What bounds it on an H100: operations.  At the ResNet-50 shapes
// ([128,28,28,128] -> 128 and [128,14,14,256] -> 256) the conv is 29.6
// GFLOP against 26-51 MB: 0.0299 ms at 989 TFLOP/s bf16.  A plain implicit
// GEMM that stages each tap's shifted input apart reads y1 nine times
// from L2 and transforms it nine times; that, not the tensor cores, held
// the first wgmma version of this kernel back.
//
// What the design does about it: an implicit GEMM on wgmma, M = pixels,
// N = Cout, K = 9 * Cin, whose A operand is built once per 64 input
// channels and read by all nine taps.
//   - The pixels are numbered in a padded order: each image row is
//     followed by one zero slot and each image by one zero row (and one
//     zero row and slot lead the first), so the neighbour (dh, dw) of the
//     position q is the position q + dh (W + 1) + dw, and every neighbour
//     outside the image lands on a zero.  A block owns 128 consecutive
//     positions (the zero slots among them are computed and dropped: 7 %
//     of the work at W 28, 13 % at 14).
//   - For each 64-channel chunk the block stages the window of positions
//     its taps reach, 128 + 2 (W + 2) rows of relu(y1 * a + b) in bf16,
//     once, into a 128-byte-swizzled buffer; tap (dh, dw) is then the same
//     buffer from row (dh + 1) (W + 1) + dw + 1 on: a wgmma descriptor may
//     start at any row, since the swizzle follows the address bits.
//   - Two warpgroups of 64 rows, m64nBNk16 (BN 128, or 64 when Cout is
//     not a multiple of 128); the weight tile w[tap, c0:c0+64, n0:n0+BN]
//     (Cout contiguous) goes by cp.async into a 3-stage ring, one tap
//     ahead, and is read MN-major through the transpose bit.
//   - The next chunk's window is staged (16-byte loads, the plain
//     version's rounding, swizzled stores) into the other buffer during
//     tap 4, behind that tap's products.
//   - Two blocks an SM (128 registers a thread, about 100 KB of shared
//     memory each): one block's staging, prologue and epilogue overlap the
//     other's products.
//   - Epilogue: y2 goes through shared memory in bf16 and out in 16-byte
//     row stores; the per-channel sums of the f32 accumulator over the
//     tile's real pixels reduce by shuffles within each warp, then in a
//     fixed order over the 8 warps, into the [tiles, Cout] partial
//     buffers that fused_conv.cu's stats_reduce_kernel finishes in a fixed
//     order: the stats are the same bits on every run.
// Not yet done: a producer warpgroup with TMA; larger tiles (every block
// reads all the weights of its channels from L2, as many bytes as its
// products' A operand at 128 x 128); a persistent grid (tried: with the
// epilogue's own shared memory only one block fits an SM, and it ran
// slower than two blocks an SM).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBM = 128;        // positions per block: two warpgroups
constexpr int kBK = 64;         // input channels per chunk
constexpr int kThreads = 256;
constexpr int kBStages = 3;     // weight-tile ring
constexpr int kMaxWin = 256;    // window rows: kBM + 2 (W + 2) at most

// shared memory, in bytes from a 1024-aligned base: two windows of `rows`
// rows, then the weight ring; the epilogue reuses the front
template <int BN>
struct Cfg {
  static constexpr int kBBytes = kBK * BN * 2;
  static constexpr int kLdC = BN + 8;            // bf16 epilogue row
  static constexpr int kEpi = kBM * kLdC * 2 + 2 * 8 * BN * 4;
  // one window of `rows` rows, rounded to whole swizzle atoms
  static __host__ __device__ int win_bytes(int rows) {
    return (rows * 128 + 1023) / 1024 * 1024;
  }
  static int smem(int rows) {
    const int main = 2 * win_bytes(rows) + kBStages * kBBytes;
    return (main > kEpi ? main : kEpi) + kMaxWin * 4 + 1024;  // + src, align
  }
};

// the padded position order: pitch P = W + 1, image stride S = (H + 1) P,
// the first image's pixel (0, 0) at position L = P + 1
struct Geo {
  int P, S, L, n_img, H, W;
  // the pixel n H W + h W + w at position q, or -1 for a zero slot
  __device__ __forceinline__ int pixel(int q) const {
    const int t = q - L;
    if (t < 0) return -1;
    const int n = t / S, r = t - n * S, h = r / P, w = r - h * P;
    return n < n_img && h < H && w < W ? (n * H + h) * W + w : -1;
  }
};

template <int BN>
struct Mma;
template <>
struct Mma<128> {
  static __device__ __forceinline__ void step(float (&d)[64], uint32_t sa,
                                              uint32_t sb) {
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      sm90::wgmma_ss_m64n128<1>(d, sm90::desc_k_major(sa, kMaxWin, kk),
                                sm90::desc_mn_major(sb, kBK, kk), 1);
  }
};
template <>
struct Mma<64> {
  static __device__ __forceinline__ void step(float (&d)[32], uint32_t sa,
                                              uint32_t sb) {
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      sm90::wgmma_ss_m64n64<1>(d, sm90::desc_k_major(sa, kMaxWin, kk),
                               sm90::desc_mn_major(sb, kBK, kk), 1);
  }
};

__device__ __forceinline__ float bn_relu(float x, float a, float b) {
  // mul then add, each rounded (no FMA contraction): the plain version's
  // `x * a + b` exactly; a NaN passes through as in `torch.relu` and
  // `jnp.maximum` (`fmaxf(NaN, 0)` would return 0), and the bf16 packing
  // (`__floats2bfloat162_rn`) keeps it a NaN
  const float v = __fadd_rn(__fmul_rn(x, a), b);
  return (v > 0.f || v != v) ? v : 0.f;
}

// 8 bf16 of y1 -> relu(y1 * a + b), 8 bf16
__device__ __forceinline__ uint4 bn_relu8(uint4 raw, const float (&a)[8],
                                          const float (&b)[8]) {
  const uint32_t* in = reinterpret_cast<const uint32_t*>(&raw);
  uint4 out;
  uint32_t* o = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(in + q));
    o[q] = sm90::pack_bf16(bn_relu(f.x, a[2 * q], b[2 * q]),
                           bn_relu(f.y, a[2 * q + 1], b[2 * q + 1]));
  }
  return out;
}

template <int BN>
__global__ void __launch_bounds__(kThreads, 2)
fused_conv_sm90_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                       const float* __restrict__ a,
                       const float* __restrict__ b, bf16* __restrict__ y,
                       float* __restrict__ part1, float* __restrict__ part2,
                       const Geo g, int cin, int cout) {
  using C = Cfg<BN>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);

  const int tid = threadIdx.x, wg = tid >> 7;
  const int warp = tid >> 5, lane = tid & 31;
  const int q0 = g.L + blockIdx.x * kBM, n0 = blockIdx.y * BN;
  const int rows = kBM + 2 * g.P + 2;          // window rows
  const int win_bytes = C::win_bytes(rows);
  const uint32_t sB0 = base + 2 * win_bytes;
  // the pixel of each window row, -1 for a zero slot
  int* src = reinterpret_cast<int*>(
      smem + max(2 * win_bytes + kBStages * C::kBBytes, C::kEpi));
  for (int j = tid; j < rows; j += kThreads)
    src[j] = g.pixel(q0 - g.P - 1 + j);
  __syncthreads();
  const int csteps = cin / kBK, nsteps = 9 * csteps;

  // relu(y1 * a + b) of chunk c (channels 64 c ..) at the window's
  // positions into window buffer `buf`: thread rows (tid / 8) + 32 i,
  // 16-byte chunk cc
  const int cc = tid & 7;
  auto stage_win = [&](int c, int buf) {
    float av[8], bv[8];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float4 a4 = __ldg(reinterpret_cast<const float4*>(a + c * kBK) +
                              2 * cc + j);
      const float4 b4 = __ldg(reinterpret_cast<const float4*>(b + c * kBK) +
                              2 * cc + j);
      av[4 * j] = a4.x;
      av[4 * j + 1] = a4.y;
      av[4 * j + 2] = a4.z;
      av[4 * j + 3] = a4.w;
      bv[4 * j] = b4.x;
      bv[4 * j + 1] = b4.y;
      bv[4 * j + 2] = b4.z;
      bv[4 * j + 3] = b4.w;
    }
    unsigned char* sw = smem + buf * win_bytes;
#pragma unroll 4
    for (int j = tid >> 3; j < rows; j += kThreads / 8) {
      const int pix = src[j];
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (pix >= 0)
        val = bn_relu8(__ldg(reinterpret_cast<const uint4*>(
                           x + (size_t)pix * cin + c * kBK + 8 * cc)),
                       av, bv);
      *reinterpret_cast<uint4*>(sw + sm90::sw128_offset(j, cc, kMaxWin)) =
          val;
    }
  };
  // the weight tile of step s (chunk s / 9, tap s % 9)
  auto load_b = [&](int s) {
    const int c = s / 9, tap = s - 9 * c;
    const bf16* srcw = w + (size_t)(tap * cin + c * kBK) * cout + n0;
    const uint32_t sb = sB0 + (s % kBStages) * C::kBBytes;
#pragma unroll
    for (int j = 0; j < kBK * BN / 8 / kThreads; ++j) {
      const int u = tid + j * kThreads;
      const int k = u / (BN / 8), ch = u % (BN / 8);
      sm90::cp_async16(sb + sm90::sw128_offset(k, ch, kBK),
                       srcw + (size_t)k * cout + 8 * ch, true);
    }
  };

  // the ring runs kBStages - 2 taps ahead: a stage was last read two taps
  // back, whose products every warpgroup has waited for by then
#pragma unroll
  for (int s = 0; s < kBStages - 2; ++s) {
    load_b(s);
    sm90::cp_async_commit();
  }
  stage_win(0, 0);

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  for (int c = 0; c < csteps; ++c) {
    const uint32_t swin = base + (c & 1) * win_bytes + wg * 64 * 128;
    for (int tap = 0; tap < 9; ++tap) {
      const int s = 9 * c + tap;
      sm90::cp_async_wait<kBStages - 3>();   // the weights of step s are in
      sm90::fence_proxy_async();
      __syncthreads();
      if (s + kBStages - 2 < nsteps) load_b(s + kBStages - 2);
      sm90::cp_async_commit();
      // tap (dh, dw) starts at window row (dh + 1) P + dw + 1
      const int j0 = (tap / 3) * g.P + tap % 3;
      sm90::wgmma_fence();
      Mma<BN>::step(acc, swin + j0 * 128, sB0 + (s % kBStages) * C::kBBytes);
      sm90::wgmma_commit();
      // the next chunk's window, behind this tap's products, into the other
      // buffer: its last reader, chunk c - 1, is done (every warpgroup
      // waited for tap 2 of chunk c before this tap's barrier)
      if (tap == 4 && c + 1 < csteps) stage_win(c + 1, (c + 1) & 1);
      sm90::wgmma_wait<1>();                  // the previous tap is done
    }
  }
  sm90::wgmma_wait<0>();
  sm90::fence_regs(acc);
  __syncthreads();                            // the ring is free

  // --- epilogue ----------------------------------------------------------
  bf16* cs = reinterpret_cast<bf16*>(smem);
  float* red1 = reinterpret_cast<float*>(smem + kBM * C::kLdC * 2);
  float* red2 = red1 + 8 * BN;
  const int r0 = 64 * wg + 16 * (warp & 3) + (lane >> 2);
  const bool ok0 = src[r0 + g.P + 1] >= 0, ok1 = src[r0 + g.P + 9] >= 0;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = 8 * j + 2 * (lane & 3);
    *reinterpret_cast<uint32_t*>(cs + r0 * C::kLdC + col) =
        sm90::pack_bf16(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<uint32_t*>(cs + (r0 + 8) * C::kLdC + col) =
        sm90::pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float v0 = ok0 ? acc[4 * j + e] : 0.f;
      const float v1 = ok1 ? acc[4 * j + 2 + e] : 0.f;
      float s1 = v0 + v1, s2 = v0 * v0 + v1 * v1;
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        s1 += __shfl_xor_sync(~0u, s1, o);
        s2 += __shfl_xor_sync(~0u, s2, o);
      }
      if (lane < 4) {
        red1[warp * BN + col + e] = s1;
        red2[warp * BN + col + e] = s2;
      }
    }
  }
  __syncthreads();
  const int ch = tid % (BN / 8);
  for (int row = tid / (BN / 8); row < kBM; row += kThreads / (BN / 8)) {
    const int pix = src[row + g.P + 1];          // window row of position
    if (pix >= 0)                                // q0 + row
      *reinterpret_cast<uint4*>(y + (size_t)pix * cout + n0 + 8 * ch) =
          *reinterpret_cast<const uint4*>(cs + row * C::kLdC + 8 * ch);
  }
  for (int c = tid; c < BN; c += kThreads) {
    float t1 = 0.f, t2 = 0.f;
    for (int k = 0; k < 8; ++k) {
      t1 += red1[k * BN + c];
      t2 += red2[k * BN + c];
    }
    part1[(size_t)blockIdx.x * cout + n0 + c] = t1;
    part2[(size_t)blockIdx.x * cout + n0 + c] = t2;
  }
}

template <int BN>
int launch(const void* x, const void* w, const void* a, const void* b,
           void* y, void* part1, void* part2, const Geo& g, int tiles,
           int cin, int cout, cudaStream_t stream) {
  const int smem = Cfg<BN>::smem(kBM + 2 * g.P + 2);
  auto kernel = fused_conv_sm90_kernel<BN>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(tiles, cout / BN), kThreads, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<bf16*>(y), static_cast<float*>(part1),
      static_cast<float*>(part2), g, cin, cout);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

namespace thb {

// Rows of partial sums the kernel writes: one per 128 padded positions.
int fused_conv_sm90_tiles(int n, int h, int wd) {
  return (int)(((long long)n * (h + 1) * (wd + 1) + kBM - 1) / kBM);
}

// The bf16 kernel with 128 (bn 128) or 64 (bn 64) output channels a block;
// cin % 64 == 0, cout % bn == 0 and wd <= 62 (the caller checks).  Writes
// y2 and fused_conv_sm90_tiles(n, h, wd) rows of [tiles, cout] partial
// sums; fused_conv.cu reduces them.  Returns cudaGetLastError() after the
// launch.
int fused_conv_sm90(const void* x, const void* w, const void* a,
                    const void* b, void* y, void* part1, void* part2, int n,
                    int h, int wd, int cin, int cout, int bn,
                    cudaStream_t stream) {
  Geo g;
  g.P = wd + 1;
  g.S = (h + 1) * g.P;
  g.L = g.P + 1;
  g.n_img = n;
  g.H = h;
  g.W = wd;
  if (kBM + 2 * g.P + 2 > kMaxWin)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = fused_conv_sm90_tiles(n, h, wd);
  if (bn == 128)
    return launch<128>(x, w, a, b, y, part1, part2, g, tiles, cin, cout,
                       stream);
  if (bn == 64)
    return launch<64>(x, w, a, b, y, part1, part2, g, tiles, cin, cout,
                      stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace thb
