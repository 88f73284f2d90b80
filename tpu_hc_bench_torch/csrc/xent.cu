// Softmax cross-entropy with integer labels for Hopper (sm_90a): the
// forward and the backward, each one kernel.
//
// Replaces: tpu_hc_bench/ops/xent.py, the two Pallas kernels reached from
// `softmax_xent`: `_fwd_kernel` (through `_fwd_call`) and `_bwd_kernel`
// (through `_bwd_call`).
//
//   forward:  per row, lse = m + log(s) from the online logsumexp
//             m' = max(m, max(x)), s' = s e^(m - m') + sum e^(x - m'),
//             c = x[label] (0 where the label is outside [0, V), as the
//             JAX iota-compare-and-sum gives), loss = lse - c; both f32.
//   backward: dlogits = (exp(x - lse) - onehot(label)) * g, in f32, then
//             rounded once to the logits' dtype; g is the [N] cotangent
//             of the per-row loss.
//
// Layouts and types: logits [N, V] row-major (contiguous), float32 or
// bfloat16, read in their own type with all math in f32;
// labels [N] int64; loss, lse and g [N] float32.
//
// What bounds it on an H100: bytes.  The forward reads every logit once
// (GPT-2's [16384, 50257] f32: 3.29 GB, 0.983 ms at 3.35 TB/s) for one
// exp each; the backward reads every logit once and writes dlogits once
// (6.59 GB, 1.966 ms).  Each element costs one exp and a few FMAs, far
// below the card's ridge.
//
// What the design does about it: the forward gives each row one block of
// 256 threads, which stride over the vocab with coalesced scalar loads
// (a row of 50257 f32 is only 4-byte aligned, so no vector loads without
// a prologue), four loads in flight per thread before the math.  Each
// thread keeps a running (m, s); the pairs merge across the block in a
// fixed order (warp butterflies, then the warps in order), so every run
// gives the same bits.  No padding copy: JAX pads the vocab with -1e30 to
// a multiple of 512 (a 3.3 GB copy at GPT-2's shape); the kernel masks
// the ragged tail by index instead, with the same result, since e^(-1e30
// - m) is 0.  The label logit is read directly.  The backward runs a 2-D
// grid, rows by 2048-column chunks, reads the row's lse, g and label once
// a block and streams the chunk.  The logits never pass through shared
// memory and nothing is written but the outputs.
//
// Not yet done: 16-byte loads with an alignment prologue, skipping the
// reads of rows whose cotangent is 0 (85 % of BERT's MLM rows).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kUnroll = 4;          // loads in flight per thread (forward)
constexpr int kBwdPerThread = 8;    // columns per thread (backward)
constexpr int kBwdChunk = kThreads * kBwdPerThread;
constexpr float kNegInf = -1e30f;   // JAX's _NEG_INF: the running max's start

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16(x);
}

// (ma, sa) <- the logsumexp pair of the union of two sets
__device__ __forceinline__ void merge(float& ma, float& sa, float mb,
                                      float sb) {
  const float m = fmaxf(ma, mb);
  sa = sa * expf(ma - m) + sb * expf(mb - m);
  ma = m;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
xent_fwd_kernel(const T* __restrict__ logits,
                const int64_t* __restrict__ labels, float* __restrict__ loss,
                float* __restrict__ lse, int v) {
  __shared__ float red_m[kThreads / 32];
  __shared__ float red_s[kThreads / 32];
  const int64_t row = blockIdx.x;
  const T* x = logits + row * (int64_t)v;

  float m = kNegInf, s = 0.f;
  for (int base = threadIdx.x; base < v; base += kThreads * kUnroll) {
    float xs[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = base + u * kThreads;
      xs[u] = j < v ? to_f(x[j]) : -INFINITY;   // e^(-inf - m) is 0
    }
    float mc = xs[0];
#pragma unroll
    for (int u = 1; u < kUnroll; ++u) mc = fmaxf(mc, xs[u]);
    if (mc > m) {
      s *= expf(m - mc);
      m = mc;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) s += expf(xs[u] - m);
  }

  // the block's 256 pairs in a fixed order: butterflies within each warp,
  // then warp 0 over the warps' results
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float mo = __shfl_xor_sync(0xffffffffu, m, o);
    const float so = __shfl_xor_sync(0xffffffffu, s, o);
    merge(m, s, mo, so);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    red_m[warp] = m;
    red_s[warp] = s;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    m = red_m[0];
    s = red_s[0];
    for (int w = 1; w < kThreads / 32; ++w) merge(m, s, red_m[w], red_s[w]);
    const float l = m + logf(s);
    const int64_t label = labels[row];
    const float c = (label >= 0 && label < v) ? to_f(x[label]) : 0.f;
    lse[row] = l;
    loss[row] = l - c;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
xent_bwd_kernel(const T* __restrict__ logits,
                const int64_t* __restrict__ labels,
                const float* __restrict__ lse, const float* __restrict__ g,
                T* __restrict__ dlogits, int v) {
  const int64_t row = blockIdx.x;
  const float l = lse[row], gr = g[row];
  const int64_t label = labels[row];
  const int64_t off = row * (int64_t)v;
  const int j0 = blockIdx.y * kBwdChunk + threadIdx.x;
#pragma unroll
  for (int u = 0; u < kBwdPerThread; ++u) {
    const int j = j0 + u * kThreads;
    if (j < v) {
      const float p = expf(to_f(logits[off + j]) - l);
      const float onehot = j == label ? 1.f : 0.f;
      dlogits[off + j] = from_f<T>((p - onehot) * gr);
    }
  }
}

// the kernel for one logits type; dtype: 0 float32, 1 bfloat16
template <template <typename> class Launch, typename... Args>
int by_dtype(int dtype, Args... args) {
  switch (dtype) {
    case 0: Launch<float>::run(args...); break;
    case 1: Launch<bf16>::run(args...); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T> struct Fwd {
  static void run(const void* logits, const void* labels, void* loss,
                  void* lse, int n, int v, cudaStream_t stream) {
    xent_fwd_kernel<T><<<n, kThreads, 0, stream>>>(
        static_cast<const T*>(logits), static_cast<const int64_t*>(labels),
        static_cast<float*>(loss), static_cast<float*>(lse), v);
  }
};

template <typename T> struct Bwd {
  static void run(const void* logits, const void* labels, const void* lse,
                  const void* g, void* dlogits, int n, int v,
                  cudaStream_t stream) {
    const dim3 grid(n, (v + kBwdChunk - 1) / kBwdChunk);
    xent_bwd_kernel<T><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(logits), static_cast<const int64_t*>(labels),
        static_cast<const float*>(lse), static_cast<const float*>(g),
        static_cast<T*>(dlogits), v);
  }
};

}  // namespace

// Both return cudaGetLastError() after the launch (0 when it was accepted).
extern "C" int thb_softmax_xent_fwd(const void* logits, const void* labels,
                                    void* loss, void* lse, int n, int v,
                                    int dtype, void* stream) {
  return by_dtype<Fwd>(dtype, logits, labels, loss, lse, n, v,
                       static_cast<cudaStream_t>(stream));
}

extern "C" int thb_softmax_xent_bwd(const void* logits, const void* labels,
                                    const void* lse, const void* g,
                                    void* dlogits, int n, int v, int dtype,
                                    void* stream) {
  return by_dtype<Bwd>(dtype, logits, labels, lse, g, dlogits, n, v,
                       static_cast<cudaStream_t>(stream));
}
