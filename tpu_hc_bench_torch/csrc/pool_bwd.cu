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
// What the design does about it:
// - Vectors over channels.  A thread owns V channels of one input pixel
//   (8 in bf16, 4 in f32: 16 bytes) and reads x, y and dy and writes dx
//   with 16-byte accesses; the block's x threads run over the channel
//   vectors of a pixel and its y threads over neighbouring columns, so a
//   warp reads contiguous memory.  A channel count that is not a
//   multiple of V (or a tensor not 16-byte aligned) runs the same kernel
//   with scalar accesses (`vec` = 0): V channels a thread, the last
//   vector of a pixel cut at C.
// - Windows by range, not taps by probe.  The windows that cover input
//   row r are oh in [ceil((r + pad_h - wh + 1) / sh), (r + pad_h) / sh]
//   (cut to [0, Ho)), and the same for columns, computed once per row
//   and once per column, not per element.  The 3x3/2 and 3x3/1 pools
//   are template cases, so the divisions by the stride are shifts; any
//   other window runs the generic case, whose divisions by the runtime
//   stride are per row and per column.  No division runs per element:
//   the grid is (column tiles, row tiles, images) and the block (channel
//   vectors, columns).
// - The windows are visited with oh, then ow, descending: tap row, then
//   tap column, ascending, the Pallas kernel's order, so the f32 sums
//   (and the bits) equal the plain version's.
// - Each thread walks kRows consecutive input rows of its column, so
//   the y and dy rows that neighbouring input rows share are read again
//   from L1 (through the read-only path), as are the columns that
//   neighbouring threads share.  No padded copy of x, no -inf pad taps,
//   no atomics: each dx element has one writer.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kRows = 8;          // input rows a thread walks

struct Dims {
  int b, h, w, c, ho, wo, wh, ww, sh, sw, pad_h, pad_w;
  int nvec;               // channel vectors a pixel: ceil(c / V)
  int vec;                // 1: 16-byte accesses; 0: scalar
};

template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int V = 4;
  __device__ static void widen(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  __device__ static uint4 narrow(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
  __device__ static float scalar(const float* p) { return __ldg(p); }
  __device__ static void store(float* p, float x) { *p = x; }
};
template <> struct Vec<bf16> {
  static constexpr int V = 8;
  __device__ static void widen(const uint4& u, float* f) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static uint4 narrow(const float* f) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t lo = __bfloat16_as_ushort(__float2bfloat16(f[2 * i]));
      const uint32_t hi =
          __bfloat16_as_ushort(__float2bfloat16(f[2 * i + 1]));
      w[i] = lo | (hi << 16);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
  __device__ static float scalar(const bf16* p) {
    return __bfloat162float(__ldg(p));
  }
  __device__ static void store(bf16* p, float x) { *p = __float2bfloat16(x); }
};

// the V values at p (n of them valid; the rest 0) widened to f32
template <typename T>
__device__ __forceinline__ void load(const T* p, int n, bool vec, float* f) {
  constexpr int V = Vec<T>::V;
  if (vec) {
    Vec<T>::widen(__ldg(reinterpret_cast<const uint4*>(p)), f);
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) f[e] = e < n ? Vec<T>::scalar(p + e) : 0.f;
  }
}

// first and last window (inclusive) covering input index i: o in
// [ceil((i + pad - k + 1) / s), (i + pad) / s], cut to [0, n); K and S
// are compile-time for the template cases (0: the runtime k and s)
template <int K, int S>
__device__ __forceinline__ void window_range(int i, int pad, int k, int s,
                                             int n, int& lo, int& hi) {
  const int kk = K ? K : k, ss = S ? S : s;
  const int top = i + pad;                 // >= 0
  const int first = top - kk + 1;
  lo = first <= 0 ? 0 : (first + ss - 1) / ss;
  hi = min(top / ss, n - 1);
}

// grid: x over column tiles of blockDim.y columns, y over row tiles of
// kRows rows, z the image; block: x over channel vectors, y columns
template <typename T, int K, int S>
__global__ void __launch_bounds__(kThreads)
max_pool_bwd_kernel(const T* __restrict__ x, const T* __restrict__ y,
                    const T* __restrict__ dy, T* __restrict__ dx, Dims d) {
  constexpr int V = Vec<T>::V;
  const int col = blockIdx.x * blockDim.y + threadIdx.y;
  if (col >= d.w) return;
  const int b = blockIdx.z;
  const int row0 = blockIdx.y * kRows;
  const int row1 = min(row0 + kRows, d.h);
  const bool vec = d.vec != 0;
  int ow_lo, ow_hi;
  window_range<K, S>(col, d.pad_w, d.ww, d.sw, d.wo, ow_lo, ow_hi);
  const int64_t ybase = (int64_t)b * d.ho * d.wo * d.c;

  for (int cv = threadIdx.x; cv < d.nvec; cv += blockDim.x) {
    const int c0 = cv * V;
    const int n = min(V, d.c - c0);
    for (int row = row0; row < row1; ++row) {
      int oh_lo, oh_hi;
      window_range<K, S>(row, d.pad_h, d.wh, d.sh, d.ho, oh_lo, oh_hi);
      const int64_t i = (((int64_t)b * d.h + row) * d.w + col) * d.c + c0;
      float xv[V], acc[V];
      load(x + i, n, vec, xv);
#pragma unroll
      for (int e = 0; e < V; ++e) acc[e] = 0.f;
      // tap row ascending is oh descending; tap column likewise
      for (int oh = oh_hi; oh >= oh_lo; --oh) {
        for (int ow = ow_hi; ow >= ow_lo; --ow) {
          const int64_t o = ybase + ((int64_t)oh * d.wo + ow) * d.c + c0;
          float yv[V], gv[V];
          load(y + o, n, vec, yv);
          load(dy + o, n, vec, gv);
#pragma unroll
          for (int e = 0; e < V; ++e)
            if (xv[e] == yv[e]) acc[e] += gv[e];
        }
      }
      if (vec) {
        *reinterpret_cast<uint4*>(dx + i) = Vec<T>::narrow(acc);
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e)
          if (e < n) Vec<T>::store(dx + i + e, acc[e]);
      }
    }
  }
}

template <typename T>
int launch(const void* x, const void* y, const void* dy, void* dx, Dims d,
           int aligned, cudaStream_t stream) {
  constexpr int V = Vec<T>::V;
  d.nvec = (d.c + V - 1) / V;
  d.vec = aligned && d.c % V == 0;
  const int bx = d.nvec < 64 ? d.nvec : 64;
  const int by = kThreads / bx;
  const dim3 block(bx, by);
  const dim3 grid((d.w + by - 1) / by, (d.h + kRows - 1) / kRows, d.b);
  const T* xp = static_cast<const T*>(x);
  const T* yp = static_cast<const T*>(y);
  const T* gp = static_cast<const T*>(dy);
  T* dxp = static_cast<T*>(dx);
  const bool square3 = d.wh == 3 && d.ww == 3 && d.sh == d.sw;
  if (square3 && d.sh == 2)
    max_pool_bwd_kernel<T, 3, 2><<<grid, block, 0, stream>>>(xp, yp, gp,
                                                             dxp, d);
  else if (square3 && d.sh == 1)
    max_pool_bwd_kernel<T, 3, 1><<<grid, block, 0, stream>>>(xp, yp, gp,
                                                             dxp, d);
  else
    max_pool_bwd_kernel<T, 0, 0><<<grid, block, 0, stream>>>(xp, yp, gp,
                                                             dxp, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 float32, 1 bfloat16; aligned: every pointer is 16-byte
// aligned.  Returns cudaGetLastError() after the launch (0 when it was
// accepted).
extern "C" int thb_max_pool_bwd(const void* x, const void* y, const void* dy,
                                void* dx, int b, int h, int w, int c, int ho,
                                int wo, int wh, int ww, int sh, int sw,
                                int pad_h, int pad_w, int aligned, int dtype,
                                void* stream) {
  Dims d{b, h, w, c, ho, wo, wh, ww, sh, sw, pad_h, pad_w, 0, 0};
  if (b == 0 || h == 0 || w == 0 || c == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(x, y, dy, dx, d, aligned, s);
    case 1: return launch<bf16>(x, y, dy, dx, d, aligned, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
