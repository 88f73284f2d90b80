// Fused BN-apply + relu + 3x3/s1 SAME conv + per-channel stats, for
// Hopper (sm_90a).
//
// Replaces: tpu_hc_bench/ops/fused_conv.py, the Pallas kernel `_kernel`
// reached from `fused_bn_relu_conv` through `_fused_fwd_impl`, in
// float32, and in bf16 where Cin is a multiple of 32 but not of 64; the
// other bf16 shapes run on fused_conv_sm90.cu's wgmma kernel (the
// wrapper's shape rule, ops/fused_conv.py `conv_design`).  The entry and
// the stats reduction here serve both files.
//
//   xn = relu(y1 * a + b)            (BN folded to scale/shift, f32 math,
//                                     rounded to y1's dtype)
//   acc = conv3x3(xn, w)             (zero halo AFTER BN+relu, f32 acc)
//   y2 = acc in y1's dtype;  s1 = sum(acc), s2 = sum(acc^2) per channel
//
// Layouts: y1 [N,H,W,Cin] and y2 [N,H,W,Cout] (NHWC, which is an NCHW
// tensor in channels_last), w [3,3,Cin,Cout]; a, b, s1, s2 float32.
// Types: float32 or bfloat16 for y1, w and y2.
//
// What bounds it on an H100: operations.  At the ResNet-50 shapes
// ([128,28,28,128] -> 128 and [128,14,14,256] -> 256) the conv is
// 29.6 GFLOP against ~26-51 MB of traffic, far above the card's
// ~295 FLOP/byte ridge in bf16.
//
// What the design does about it: an implicit GEMM (M = N*H*W pixels,
// N = Cout, K = 9*Cin) with one block per 128-pixel x 64-channel tile.
// For each tap and each 32-channel chunk the block stages relu(x*a+b) of
// its pixels' shifted neighbours into shared memory (zeros for the halo
// and for rows past the end), so the normalized input never touches
// device memory, and stages the weight tile beside it.  bf16 runs on the
// tensor cores through WMMA 16x16x16 (f32 accumulate); f32 runs on the
// FMA units (no TF32, the same arithmetic as the plain version).  The
// epilogue goes through shared memory: y2 is written in the input dtype
// and each block writes its partial column sums of the f32 accumulator to
// a [tiles_m, Cout] buffer; a second small kernel reduces that buffer in a
// fixed order, so the stats are deterministic (CUDA blocks run in no
// order, unlike the Pallas grid's sequential axis).
//
// Not yet done here: double-buffered staging and wgmma (see
// fused_conv_sm90.cu).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBM = 128;        // pixels per block
constexpr int kBN = 64;         // output channels per block
constexpr int kBK = 32;         // input channels per staging step
constexpr int kThreads = 256;
constexpr int kLDA = kBK + 8;   // shared-memory row strides, in elements
constexpr int kLDB = kBN + 8;
constexpr int kLDC = kBN + 4;

__device__ __forceinline__ float bn_relu(float x, float a, float b) {
  // mul then add, each rounded (no FMA contraction): the plain version's
  // `x * a + b` exactly; a NaN passes through as in `torch.relu` and
  // `jnp.maximum` (`fmaxf(NaN, 0)` would return 0), and the bf16 packing
  // (`__floats2bfloat162_rn`) keeps it a NaN
  const float v = __fadd_rn(__fmul_rn(x, a), b);
  return (v > 0.f || v != v) ? v : 0.f;
}

// --- staging: 4 consecutive input channels of one pixel -> shared -------

__device__ __forceinline__ void stage_a4(const float* src, const float4 a,
                                         const float4 b, float* dst,
                                         bool inb) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (inb) {
    const float4 x = *reinterpret_cast<const float4*>(src);
    v = make_float4(bn_relu(x.x, a.x, b.x), bn_relu(x.y, a.y, b.y),
                    bn_relu(x.z, a.z, b.z), bn_relu(x.w, a.w, b.w));
  }
  *reinterpret_cast<float4*>(dst) = v;
}

__device__ __forceinline__ void stage_a4(const bf16* src, const float4 a,
                                         const float4 b, bf16* dst,
                                         bool inb) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(0.f, 0.f), hi = lo;
  if (inb) {
    const uint2 raw = *reinterpret_cast<const uint2*>(src);
    const __nv_bfloat162 x01 = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
    const __nv_bfloat162 x23 = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
    const float2 f01 = __bfloat1622float2(x01);
    const float2 f23 = __bfloat1622float2(x23);
    lo = __floats2bfloat162_rn(bn_relu(f01.x, a.x, b.x),
                               bn_relu(f01.y, a.y, b.y));
    hi = __floats2bfloat162_rn(bn_relu(f23.x, a.z, b.z),
                               bn_relu(f23.y, a.w, b.w));
  }
  uint2 out;
  out.x = *reinterpret_cast<uint32_t*>(&lo);
  out.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(dst) = out;
}

// --- staging: the [kBK, kBN] weight tile -> shared ----------------------

__device__ __forceinline__ void stage_b(const float* w, float* Bs, int cout,
                                        int tid) {
  for (int j = 0; j < 2; ++j) {             // 512 float4 over 256 threads
    const int idx = tid + j * kThreads;
    const int row = idx >> 4, col = (idx & 15) * 4;
    *reinterpret_cast<float4*>(Bs + row * kLDB + col) =
        *reinterpret_cast<const float4*>(w + (size_t)row * cout + col);
  }
}

__device__ __forceinline__ void stage_b(const bf16* w, bf16* Bs, int cout,
                                        int tid) {
  const int row = tid >> 3, col = (tid & 7) * 8;   // 256 x 8 bf16
  *reinterpret_cast<uint4*>(Bs + row * kLDB + col) =
      *reinterpret_cast<const uint4*>(w + (size_t)row * cout + col);
}

// --- the tile product: As [kBM, kBK] x Bs [kBK, kBN] into the acc -------

struct AccF32 {            // f32: 8 rows x 4 columns per thread, FMA units
  float v[8][4];
  __device__ void zero() {
    for (int i = 0; i < 8; ++i)
      for (int j = 0; j < 4; ++j) v[i][j] = 0.f;
  }
  __device__ void mma(const float* As, const float* Bs, int tid) {
    const int ty = tid >> 4, tx = tid & 15;
#pragma unroll 4
    for (int k = 0; k < kBK; ++k) {
      const float4 bv = *reinterpret_cast<const float4*>(Bs + k * kLDB + tx * 4);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float av = As[(ty + 16 * i) * kLDA + k];
        v[i][0] = fmaf(av, bv.x, v[i][0]);
        v[i][1] = fmaf(av, bv.y, v[i][1]);
        v[i][2] = fmaf(av, bv.z, v[i][2]);
        v[i][3] = fmaf(av, bv.w, v[i][3]);
      }
    }
  }
  __device__ void store(float* Cs, int tid) {
    const int ty = tid >> 4, tx = tid & 15;
    for (int i = 0; i < 8; ++i)
      *reinterpret_cast<float4*>(Cs + (ty + 16 * i) * kLDC + tx * 4) =
          make_float4(v[i][0], v[i][1], v[i][2], v[i][3]);
  }
};

struct AccBF16 {           // bf16: each warp a 32x32 sub-tile, 2x2 WMMA
  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float> c[2][2];
  __device__ void zero() {
    for (int i = 0; i < 2; ++i)
      for (int j = 0; j < 2; ++j) nvcuda::wmma::fill_fragment(c[i][j], 0.f);
  }
  __device__ void mma(const bf16* As, const bf16* Bs, int tid) {
    using namespace nvcuda;
    const int warp = tid >> 5, wm = warp & 3, wn = warp >> 2;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[2];
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], As + (wm * 32 + i * 16) * kLDA + kk,
                               kLDA);
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], Bs + kk * kLDB + wn * 32 + j * 16,
                               kLDB);
      for (int i = 0; i < 2; ++i)
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(c[i][j], fa[i], fb[j], c[i][j]);
    }
  }
  __device__ void store(float* Cs, int tid) {
    using namespace nvcuda;
    const int warp = tid >> 5, wm = warp & 3, wn = warp >> 2;
    for (int i = 0; i < 2; ++i)
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(
            Cs + (wm * 32 + i * 16) * kLDC + wn * 32 + j * 16, c[i][j], kLDC,
            wmma::mem_row_major);
  }
};

template <typename T> struct AccFor;
template <> struct AccFor<float> { using type = AccF32; };
template <> struct AccFor<bf16> { using type = AccBF16; };

// --- y2 write: 8 consecutive channels of one pixel from the f32 tile ----

__device__ __forceinline__ void write8(const float* c, float* dst) {
  reinterpret_cast<float4*>(dst)[0] = reinterpret_cast<const float4*>(c)[0];
  reinterpret_cast<float4*>(dst)[1] = reinterpret_cast<const float4*>(c)[1];
}

__device__ __forceinline__ void write8(const float* c, bf16* dst) {
  uint4 out;
  uint32_t* o = reinterpret_cast<uint32_t*>(&out);
  for (int q = 0; q < 4; ++q) {
    __nv_bfloat162 h = __floats2bfloat162_rn(c[2 * q], c[2 * q + 1]);
    o[q] = *reinterpret_cast<uint32_t*>(&h);
  }
  *reinterpret_cast<uint4*>(dst) = out;
}

// bytes of the shared buffer: As + Bs in the main loop, Cs after it
template <typename T>
struct SmemBytes {
  static constexpr int ab = (kBM * kLDA + kBK * kLDB) * (int)sizeof(T);
  static constexpr int c = kBM * kLDC * (int)sizeof(float);
  static constexpr int value = ab > c ? ab : c;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_bn_relu_conv_kernel(const T* __restrict__ x, const T* __restrict__ w,
                          const float* __restrict__ a,
                          const float* __restrict__ b, T* __restrict__ y,
                          float* __restrict__ part1,
                          float* __restrict__ part2, int n_img, int H, int W,
                          int cin, int cout) {
  // As/Bs during the main loop; the f32 output tile Cs in the epilogue
  __shared__ __align__(128) unsigned char smem[SmemBytes<T>::value];
  __shared__ float red1[4][kBN], red2[4][kBN];
  T* As = reinterpret_cast<T*>(smem);
  T* Bs = As + kBM * kLDA;
  float* Cs = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x;
  const int hw = H * W;
  const int M = n_img * hw;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;

  // this thread stages rows (tid/8) + 32 i, channels (tid%8)*4 .. +3
  const int kq = (tid & 7) * 4;
  int row_h[4], row_w[4], row_base[4];
  bool row_ok[4];
  for (int i = 0; i < 4; ++i) {
    const int p = m0 + (tid >> 3) + 32 * i;
    row_ok[i] = p < M;
    const int img = row_ok[i] ? p / hw : 0;
    const int r = row_ok[i] ? p - img * hw : 0;
    row_h[i] = r / W;
    row_w[i] = r - row_h[i] * W;
    row_base[i] = img * hw;
  }

  typename AccFor<T>::type acc;
  acc.zero();
  for (int tap = 0; tap < 9; ++tap) {
    const int dh = tap / 3 - 1, dw = tap % 3 - 1;
    for (int c0 = 0; c0 < cin; c0 += kBK) {
      const float4 av = *reinterpret_cast<const float4*>(a + c0 + kq);
      const float4 bv = *reinterpret_cast<const float4*>(b + c0 + kq);
      for (int i = 0; i < 4; ++i) {
        const int hs = row_h[i] + dh, ws = row_w[i] + dw;
        const bool inb = row_ok[i] && hs >= 0 && hs < H && ws >= 0 && ws < W;
        const T* src = x + ((size_t)(row_base[i] + (inb ? hs * W + ws : 0)))
                               * cin + c0 + kq;
        stage_a4(src, av, bv, As + ((tid >> 3) + 32 * i) * kLDA + kq, inb);
      }
      stage_b(w + ((size_t)(tap * cin + c0)) * cout + n0, Bs, cout, tid);
      __syncthreads();
      acc.mma(As, Bs, tid);
      __syncthreads();
    }
  }
  acc.store(Cs, tid);          // the loop's last barrier freed As/Bs
  __syncthreads();

  for (int u = tid; u < kBM * kBN / 8; u += kThreads) {
    const int row = u >> 3, c8 = (u & 7) * 8;
    const int p = m0 + row;
    if (p < M) write8(Cs + row * kLDC + c8, y + (size_t)p * cout + n0 + c8);
  }
  // column sums of the f32 accumulator over this tile's real rows
  const int col = tid & (kBN - 1), rg = tid / kBN;
  float s1 = 0.f, s2 = 0.f;
  for (int r = rg * (kBM / 4); r < (rg + 1) * (kBM / 4); ++r) {
    if (m0 + r < M) {
      const float v = Cs[r * kLDC + col];
      s1 += v;
      s2 += v * v;
    }
  }
  red1[rg][col] = s1;
  red2[rg][col] = s2;
  __syncthreads();
  if (tid < kBN) {
    const size_t o = (size_t)blockIdx.x * cout + n0 + tid;
    part1[o] = ((red1[0][tid] + red1[1][tid]) + red1[2][tid]) + red1[3][tid];
    part2[o] = ((red2[0][tid] + red2[1][tid]) + red2[2][tid]) + red2[3][tid];
  }
}

// s[c] = sum over tiles of part[t, c], in a fixed order: 32 channels per
// block, 8 row groups, then the groups in order.
__global__ void stats_reduce_kernel(const float* __restrict__ part1,
                                    const float* __restrict__ part2,
                                    float* __restrict__ s1,
                                    float* __restrict__ s2, int tiles,
                                    int cout) {
  __shared__ float r1[8][32], r2[8][32];
  const int lane = threadIdx.x & 31, g = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane;
  float t1 = 0.f, t2 = 0.f;
  if (c < cout) {
    for (int t = g; t < tiles; t += 8) {
      t1 += part1[(size_t)t * cout + c];
      t2 += part2[(size_t)t * cout + c];
    }
  }
  r1[g][lane] = t1;
  r2[g][lane] = t2;
  __syncthreads();
  if (g == 0 && c < cout) {
    float u1 = 0.f, u2 = 0.f;
    for (int k = 0; k < 8; ++k) {
      u1 += r1[k][lane];
      u2 += r2[k][lane];
    }
    s1[c] = u1;
    s2[c] = u2;
  }
}

template <typename T>
int launch(const void* x, const void* w, const void* a, const void* b,
           void* y, void* part1, void* part2, int n, int h, int wd, int cin,
           int cout, cudaStream_t stream) {
  const int tiles = (n * h * wd + kBM - 1) / kBM;
  dim3 grid(tiles, cout / kBN);
  fused_bn_relu_conv_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<T*>(y), static_cast<float*>(part1),
      static_cast<float*>(part2), n, h, wd, cin, cout);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

namespace thb {
int fused_conv_sm90_tiles(int n, int h, int wd);
int fused_conv_sm90(const void* x, const void* w, const void* a,
                    const void* b, void* y, void* part1, void* part2, int n,
                    int h, int wd, int cin, int cout, int bn,
                    cudaStream_t stream);
}

// The main kernel by `design`, then the fixed-order reduction of its
// partial sums.  design 0: this file's kernel in float32 (FMA units);
// 1: in bf16 (WMMA; cin % 32 == 0); 2 and 3: fused_conv_sm90.cu's wgmma
// kernel with 128 and 64 output channels a block (bf16; cin % 64 == 0,
// wd <= 62, cout % 128 and % 64 == 0).  cout must be a multiple of 64;
// part1/part2 are [part_rows, cout] float32 scratch, at least one row per
// block along the pixels: ceil(n*h*wd / 128) for designs 0 and 1,
// ceil(n*(h+1)*(wd+1) / 128) for 2 and 3.  Returns cudaGetLastError()
// after the launches (0 when both were accepted), or
// cudaErrorInvalidValue for an unknown design or too few part_rows.
extern "C" int thb_fused_bn_relu_conv(
    const void* x, const void* w, const void* a, const void* b, void* y,
    void* part1, void* part2, void* s1, void* s2, int n, int h, int wd,
    int cin, int cout, int design, int part_rows, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = design >= 2 ? thb::fused_conv_sm90_tiles(n, h, wd)
                                : (n * h * wd + kBM - 1) / kBM;
  if (design < 0 || design > 3 || part_rows < tiles)
    return static_cast<int>(cudaErrorInvalidValue);
  int err;
  if (design == 0)
    err = launch<float>(x, w, a, b, y, part1, part2, n, h, wd, cin, cout, s);
  else if (design == 1)
    err = launch<bf16>(x, w, a, b, y, part1, part2, n, h, wd, cin, cout, s);
  else
    err = thb::fused_conv_sm90(x, w, a, b, y, part1, part2, n, h, wd, cin,
                               cout, design == 2 ? 128 : 64, s);
  if (err != cudaSuccess) return err;
  stats_reduce_kernel<<<(cout + 31) / 32, 256, 0, s>>>(
      static_cast<const float*>(part1), static_cast<const float*>(part2),
      static_cast<float*>(s1), static_cast<float*>(s2), tiles, cout);
  return static_cast<int>(cudaGetLastError());
}
