// Max-pool backward for Hopper (sm_90a), where every element tied with
// its window's max receives the window's full cotangent.
//
// Replaces: tpu_hc_bench/ops/pool_bwd.py, the Pallas kernel `_bwd_kernel`
// reached from `max_pool` through `_pool_bwd`.
//
//   dx[i] = sum over the windows o that cover i of (x[i] == y[o]) * dy[o]
//
// compared in f32, summed in f32, written in x's dtype.  Windows are
// those of `max_pool(x, window, strides, padding)` with `pad_h`/`pad_w`
// rows and columns of padding before the input (SAME) or none (VALID);
// the caller routes stride > window, non-float inputs and inputs that
// hold -inf elsewhere, as the JAX package does.
//
// Layouts and types: x and dx are [B, H, W, C], y and dy [B, Ho, Wo, C],
// all contiguous (the NHWC memory of the port's channels_last tensors);
// float32 or bfloat16, one type for all four.
//
// What bounds it on an H100: bytes.  At ResNet's stem pool (bf16 [128,
// 112, 112, 64], 3x3/2 SAME) it reads x, y and dy and writes dx, 514 MB,
// 0.153 ms at 3.35 TB/s, for at most four compares and adds an element.
//
// What the design does about it: the gather form, one thread per input
// element, neighbouring threads on neighbouring channels, so every load
// and the store are coalesced.  The grid runs over the (column, channel)
// pairs of a row, the rows and the images, so the index arithmetic stays
// in 32 bits (64-bit divisions would cost more than the loads).  A
// thread walks the window's taps and keeps those that land on its
// element (at most ceil(wh/sh) x ceil(ww/sw) windows), found by index: no
// padded copy of x and no -inf pad taps, and no atomics, since each dx
// element has one writer.  The taps are visited in the Pallas kernel's
// order (tap row, then tap column), so the f32 sums match it.  The reads
// of y and dy by the neighbouring rows and columns that share a window
// hit in L1/L2.  The TPU kernel's phase reshapes, which stand in for the
// strided reads Mosaic lacks, have no counterpart here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16(x);
}

struct Dims {
  int b, h, w, c, ho, wo, wh, ww, sh, sw, pad_h, pad_w;
};

// grid: x over the (column, channel) pairs of one input row, y the row,
// z the image; only the offsets of the image and the row need 64 bits
template <typename T>
__global__ void __launch_bounds__(kThreads)
max_pool_bwd_kernel(const T* __restrict__ x, const T* __restrict__ y,
                    const T* __restrict__ dy, T* __restrict__ dx, Dims d) {
  const int j = blockIdx.x * kThreads + threadIdx.x;   // col * C + c
  if (j >= d.w * d.c) return;
  const int row = blockIdx.y, b = blockIdx.z;
  const int c = j % d.c, col = j / d.c;
  const int64_t i = ((int64_t)b * d.h + row) * d.w * d.c + j;
  const int64_t ybase = (int64_t)b * d.ho * d.wo * d.c + c;

  const float xv = to_f(x[i]);
  float acc = 0.f;
  // tap (ki, kj) of window (oh, ow) is input row oh*sh - pad_h + ki and
  // column ow*sw - pad_w + kj: the taps that land on this element, in the
  // Pallas kernel's order
  for (int ki = 0; ki < d.wh; ++ki) {
    const int ph = row + d.pad_h - ki;
    if (ph < 0 || ph % d.sh) continue;
    const int oh = ph / d.sh;
    if (oh >= d.ho) continue;
    for (int kj = 0; kj < d.ww; ++kj) {
      const int pw = col + d.pad_w - kj;
      if (pw < 0 || pw % d.sw) continue;
      const int ow = pw / d.sw;
      if (ow >= d.wo) continue;
      const int64_t o = ybase + ((int64_t)oh * d.wo + ow) * d.c;
      if (xv == to_f(y[o])) acc += to_f(dy[o]);
    }
  }
  dx[i] = from_f<T>(acc);
}

template <typename T>
void launch(const void* x, const void* y, const void* dy, void* dx,
            const Dims& d, cudaStream_t stream) {
  const dim3 grid((d.w * d.c + kThreads - 1) / kThreads, d.h, d.b);
  max_pool_bwd_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(y),
      static_cast<const T*>(dy), static_cast<T*>(dx), d);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  Returns cudaGetLastError()
// after the launch (0 when it was accepted).
extern "C" int thb_max_pool_bwd(const void* x, const void* y, const void* dy,
                                void* dx, int b, int h, int w, int c, int ho,
                                int wo, int wh, int ww, int sh, int sw,
                                int pad_h, int pad_w, int dtype,
                                void* stream) {
  const Dims d{b, h, w, c, ho, wo, wh, ww, sh, sw, pad_h, pad_w};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: launch<float>(x, y, dy, dx, d, s); break;
    case 1: launch<bf16>(x, y, dy, dx, d, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
