// Fused residual add + RMSNorm / LayerNorm for Hopper (sm_90a).
//
// Replaces: tpu_hc_bench/ops/fused_residual_ln.py, the Pallas kernel
// `_kernel` reached from `fused_residual_norm`.
//
// y = res + x;  out = norm(y)  (both outputs in f32, stats in f32)
//   rmsnorm:   out = y * rsqrt(mean(y^2) + eps) * gamma
//   layernorm: out = (y - mu) * rsqrt(max(mean(y^2) - mu^2, 0) + eps)
//                    * gamma + beta      (Flax's fast variance)
//
// What bounds it on an H100: bytes.  Per element it reads res and x and
// writes y and out (16 bytes) for a handful of operations.
//
// What the design does about it: one block per row.  The row's y is kept
// in shared memory between the statistics pass and the normalize pass, so
// each input is read from device memory once and each output written once
// (the unfused form writes y, then reads it back twice).  Sums are reduced
// with warp shuffles, then across warps through shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum of v over the block; every thread gets the result.
__device__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  v = warp_sum(v);
  __syncthreads();                       // red may hold an earlier sum
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = lane < nwarps ? red[lane] : 0.f;
  return warp_sum(t);
}

__global__ void fused_residual_norm_kernel(
    const float* __restrict__ res, const float* __restrict__ x,
    const float* __restrict__ gamma, const float* __restrict__ beta,
    float* __restrict__ y_out, float* __restrict__ o_out, int hidden,
    float eps, int layernorm) {
  extern __shared__ float smem[];
  float* yrow = smem;                    // [hidden]
  float* red = smem + hidden;            // [32]
  const size_t base = (size_t)blockIdx.x * hidden;

  float s1 = 0.f, s2 = 0.f;
  for (int i = threadIdx.x; i < hidden; i += blockDim.x) {
    const float y = res[base + i] + x[base + i];
    yrow[i] = y;
    y_out[base + i] = y;
    s1 += y;
    s2 += y * y;
  }
  const float inv_h = 1.f / (float)hidden;
  const float mean_sq = block_sum(s2, red) * inv_h;
  if (layernorm) {
    const float mu = block_sum(s1, red) * inv_h;
    const float var = fmaxf(mean_sq - mu * mu, 0.f);
    const float r = rsqrtf(var + eps);
    for (int i = threadIdx.x; i < hidden; i += blockDim.x)
      o_out[base + i] = (yrow[i] - mu) * r * gamma[i] + beta[i];
  } else {
    const float r = rsqrtf(mean_sq + eps);
    for (int i = threadIdx.x; i < hidden; i += blockDim.x)
      o_out[base + i] = yrow[i] * r * gamma[i];
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 when it was accepted).
extern "C" int thb_fused_residual_norm(
    const void* res, const void* x, const void* gamma, const void* beta,
    void* y, void* out, int rows, int hidden, float eps, int layernorm,
    void* stream) {
  const size_t smem = sizeof(float) * ((size_t)hidden + 32);
  cudaFuncSetAttribute(fused_residual_norm_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  fused_residual_norm_kernel<<<rows, kThreads, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(res), static_cast<const float*>(x),
      static_cast<const float*>(gamma), static_cast<const float*>(beta),
      static_cast<float*>(y), static_cast<float*>(out), hidden, eps,
      layernorm);
  return static_cast<int>(cudaGetLastError());
}
