// One lone warpgroup product on the building blocks of sm90.cuh, for the
// card's tests: C [64, N] = A [64, K] x B in f32 from bf16 operands, one
// block of one warpgroup.  It holds the descriptors, the swizzle, the
// transpose bit, the accumulator layout and the register A fragment
// against torch.matmul before any kernel builds on them (a layout
// mismatch gives wrong numbers, not a fault).  No model runs it.
//
// Modes: 0  SS, B given as Bt [N, K] (K-major, as K in S = Q K^T);
//        1  SS, B given as [K, N] (MN-major, the transpose bit, as the
//           conv's weights);
//        2  RS: A from registers in the fragment layout, B [K, N]
//           MN-major (as P and V in O = P V).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

// rows x cols (row-major, cols a multiple of 64) -> swizzled tile
template <int ROWS, int COLS>
__device__ __forceinline__ void stage(uint32_t dst, const bf16* src,
                                      int tid) {
  for (int u = tid; u < ROWS * COLS / 8; u += 128) {
    const int r = u / (COLS / 8), c = u % (COLS / 8);
    sm90::cp_async16(dst + sm90::sw128_offset(r, c, ROWS),
                     src + r * COLS + c * 8, true);
  }
}

template <int N>
struct Mma;
template <>
struct Mma<64> {
  template <int T>
  static __device__ void ss(float (&d)[32], uint64_t a, uint64_t b) {
    sm90::wgmma_ss_m64n64<T>(d, a, b, 1);
  }
  static __device__ void rs(float (&d)[32], const uint32_t (&a)[4],
                            uint64_t b) {
    sm90::wgmma_rs_m64n64<1>(d, a, b, 1);
  }
};
template <>
struct Mma<128> {
  template <int T>
  static __device__ void ss(float (&d)[64], uint64_t a, uint64_t b) {
    sm90::wgmma_ss_m64n128<T>(d, a, b, 1);
  }
  static __device__ void rs(float (&d)[64], const uint32_t (&a)[4],
                            uint64_t b) {
    sm90::wgmma_rs_m64n128<1>(d, a, b, 1);
  }
};

template <int N, int K, int MODE>
__global__ void __launch_bounds__(128)
wgmma_tile_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B,
                  float* __restrict__ C) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sA = (sm90::smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sB = sA + 64 * K * 2;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  stage<64, K>(sA, A, tid);
  if (MODE == 0)
    stage<N, K>(sB, B, tid);
  else
    stage<K, N>(sB, B, tid);
  sm90::cp_async_commit();
  sm90::cp_async_wait<0>();
  sm90::fence_proxy_async();
  __syncthreads();

  const int row = 16 * warp + (lane >> 2), col = 2 * (lane & 3);
  float d[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) d[i] = 0.f;
  sm90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    if (MODE == 0) {
      Mma<N>::template ss<0>(d, sm90::desc_k_major(sA, 64, kk),
                             sm90::desc_k_major(sB, N, kk));
    } else if (MODE == 1) {
      Mma<N>::template ss<1>(d, sm90::desc_k_major(sA, 64, kk),
                             sm90::desc_mn_major(sB, K, kk));
    } else {
      const bf16* a0 = A + row * K + 16 * kk + col;
      uint32_t a[4];
      a[0] = sm90::pack_bf16(__bfloat162float(a0[0]),
                             __bfloat162float(a0[1]));
      a[1] = sm90::pack_bf16(__bfloat162float(a0[8 * K]),
                             __bfloat162float(a0[8 * K + 1]));
      a[2] = sm90::pack_bf16(__bfloat162float(a0[8]),
                             __bfloat162float(a0[9]));
      a[3] = sm90::pack_bf16(__bfloat162float(a0[8 * K + 8]),
                             __bfloat162float(a0[8 * K + 9]));
      Mma<N>::rs(d, a, sm90::desc_mn_major(sB, K, kk));
    }
  }
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
  sm90::fence_regs(d);
#pragma unroll
  for (int i = 0; i < N / 2; ++i)
    C[(row + 8 * ((i >> 1) & 1)) * N + 8 * (i >> 2) + col + (i & 1)] = d[i];
}

template <int N, int K, int MODE>
int launch(const void* a, const void* b, void* c, cudaStream_t stream) {
  const int smem = (64 + N) * K * 2 + 1024;
  auto kernel = wgmma_tile_kernel<N, K, MODE>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<1, 128, smem, stream>>>(static_cast<const bf16*>(a),
                                   static_cast<const bf16*>(b),
                                   static_cast<float*>(c));
  return static_cast<int>(cudaGetLastError());
}

template <int N, int K>
int by_mode(int mode, const void* a, const void* b, void* c,
            cudaStream_t s) {
  if (mode == 0) return launch<N, K, 0>(a, b, c, s);
  if (mode == 1) return launch<N, K, 1>(a, b, c, s);
  if (mode == 2) return launch<N, K, 2>(a, b, c, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// C [64, n] f32 from A [64, k] and B (mode 0: [n, k]; else [k, n]), all
// contiguous; n and k each 64 or 128.  Returns cudaGetLastError() after
// the launch, or cudaErrorInvalidValue for another shape or mode.
extern "C" int thb_sm90_wgmma_tile(const void* a, const void* b, void* c,
                                   int n, int k, int mode, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 64 && k == 64) return by_mode<64, 64>(mode, a, b, c, s);
  if (n == 64 && k == 128) return by_mode<64, 128>(mode, a, b, c, s);
  if (n == 128 && k == 64) return by_mode<128, 64>(mode, a, b, c, s);
  if (n == 128 && k == 128) return by_mode<128, 128>(mode, a, b, c, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
