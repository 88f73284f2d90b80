// Fused residual add + RMSNorm / LayerNorm for Hopper (sm_90a).
//
// Replaces: tpu_hc_bench/ops/fused_residual_ln.py, the Pallas kernel
// `_kernel` reached from `fused_residual_norm`.
//
// y = res + x in res's dtype;  f = float(y);  out = norm(f) in res's dtype
//   rmsnorm:   out = f * rsqrt(mean(f^2) + eps) * gamma
//   layernorm: out = (f - mu) * rsqrt(max(mean(f^2) - mu^2, 0) + eps)
//                    * gamma + beta      (Flax's fast variance)
// Statistics in f32.  res and x are float32 or bfloat16; gamma and beta
// are res's dtype or float32.
//
// What bounds it on an H100: at decode widths, latency; at many rows,
// bytes.  Per element it reads res and x and writes y and out (16 bytes
// in f32) for a handful of operations.  At llama_1b's decode shape (8
// rows of 2048 f32) the 256 KB take ~0.08 us at 3.35 TB/s, so what costs
// is the chain of dependent steps: launch, the first touch of each input
// in device memory, the reduction, the stores.
//
// What the design does about it (ops/fused_residual_ln.py `norm_design`
// picks one of two launches of the same kernel):
// - "warp": a team of 1 to 16 warps of one block owns a row (several rows
//   a block), reduced with shuffles and, for a team of several warps, one
//   exchange through shared memory.
// - "cluster": each row is split over a thread-block cluster of C (2, 4
//   or 8) CTAs, so 8 rows of 2048 f32 put 64 SMs to work, each CTA on 256
//   elements (one 16-byte vector a thread for 64 threads).  The partial
//   sums of the row meet through distributed shared memory: every CTA
//   reads the partials of all C ranks, in rank order, so every CTA forms
//   the same statistics and the result is the same on every run.  A
//   second cluster barrier, waited on only before the CTA exits, keeps
//   each CTA's shared memory alive while the others read it.
// On an H100 the warp design wins at every row count of 2048: at a decode
// step's 8 rows both are launch and one device-memory round trip, and the
// cluster barrier adds to it.  At the warp design's widest rows (16 warps
// of 4 vectors, 32 KB) the two are within a few percent, so the cluster
// design runs the rows wider than that.
// In both, each thread starts all its loads of res, x, gamma (and beta)
// at once, 16 bytes each, before it uses any: one device-memory round
// trip.  y stays in registers between the statistics and the normalize
// pass; (sum f, sum f^2) are reduced together, once.  A hidden size that
// is not a multiple of the vector, or an operand not 16-byte aligned,
// runs the same kernel with scalar accesses (VEC = false).  Nothing is
// set on the function per call.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMaxThreads = 512;
constexpr int kMaxWarps = kMaxThreads / 32;

struct Params {
  const void* res;
  const void* x;
  const void* gamma;
  const void* beta;       // layernorm only
  void* y;
  void* out;
  int rows, hidden;
  int team;               // threads of one block that share a row
  int layernorm;
  float eps, inv_h;
};

template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int V = 4;
  using Raw = uint32_t;
  __device__ static float widen1(Raw r) { return __uint_as_float(r); }
  __device__ static Raw narrow1(float f) { return __float_as_uint(f); }
};
template <> struct Vec<bf16> {
  static constexpr int V = 8;
  using Raw = unsigned short;
  __device__ static float widen1(Raw r) {
    return __uint_as_float((uint32_t)r << 16);
  }
  __device__ static Raw narrow1(float f) {
    return __bfloat16_as_ushort(__float2bfloat16(f));
  }
};

// N values of type T at element col0 of row `base` as raw 16-byte words
// (N * sizeof(T) / 16 of them), zeros past `hidden`: one 16-byte load
// each when VEC, else one scalar load a value
template <typename T, int N, bool VEC>
__device__ __forceinline__ void load_raw(const T* base, int col0, int hidden,
                                         uint4* w) {
  constexpr int kWords = N * (int)sizeof(T) / 16;
  if (VEC) {
#pragma unroll
    for (int i = 0; i < kWords; ++i)
      w[i] = col0 < hidden
                 ? __ldg(reinterpret_cast<const uint4*>(base + col0) + i)
                 : make_uint4(0u, 0u, 0u, 0u);
  } else {
    using Raw = typename Vec<T>::Raw;
    const Raw* p = reinterpret_cast<const Raw*>(base);
    Raw* r = reinterpret_cast<Raw*>(w);
#pragma unroll
    for (int e = 0; e < N; ++e)
      r[e] = col0 + e < hidden ? __ldg(p + col0 + e) : Raw(0);
  }
}

template <typename T, int N>
__device__ __forceinline__ void widen(const uint4* w, float* f) {
  using Raw = typename Vec<T>::Raw;
  const Raw* r = reinterpret_cast<const Raw*>(w);
#pragma unroll
  for (int e = 0; e < N; ++e) f[e] = Vec<T>::widen1(r[e]);
}

// the V values of f, rounded to T, stored at element col0 (cut at hidden)
template <typename T, bool VEC>
__device__ __forceinline__ void store(T* base, int col0, int hidden,
                                      const float* f) {
  constexpr int V = Vec<T>::V;
  using Raw = typename Vec<T>::Raw;
  uint4 w;
  Raw* r = reinterpret_cast<Raw*>(&w);
#pragma unroll
  for (int e = 0; e < V; ++e) r[e] = Vec<T>::narrow1(f[e]);
  if (VEC) {
    if (col0 < hidden) *reinterpret_cast<uint4*>(base + col0) = w;
  } else {
    Raw* p = reinterpret_cast<Raw*>(base);
#pragma unroll
    for (int e = 0; e < V; ++e)
      if (col0 + e < hidden) p[col0 + e] = r[e];
  }
}

__device__ __forceinline__ float2 warp_sum2(float2 v, bool both) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    if (both) v.x += __shfl_xor_sync(0xffffffffu, v.x, o);
    v.y += __shfl_xor_sync(0xffffffffu, v.y, o);
  }
  return v;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// One thread's share of a row: NV vectors of V values, vector j at
// index t + j * tr of the row's vectors (t the thread's place among the
// tr threads of the row), so a warp's loads are contiguous.
// CLUSTER: the row is blockIdx.x / C, t = rank * blockDim.x + threadIdx.x.
// Otherwise: blockDim.x / team rows a block, t = threadIdx.x % team.
template <typename T, typename TG, int NV, bool VEC, bool CLUSTER>
__global__ void __launch_bounds__(kMaxThreads)
fused_residual_norm_kernel(Params p) {
  constexpr int V = Vec<T>::V;
  constexpr int GW = V * (int)sizeof(TG) / 16;   // gamma words a vector
  __shared__ float2 red[kMaxWarps];

  const int warp = threadIdx.x >> 5;
  int row, t, tr, nparts = 1;
  unsigned rank = 0;
  if (CLUSTER) {
    cg::cluster_group cluster = cg::this_cluster();
    rank = cluster.block_rank();
    nparts = (int)cluster.num_blocks();
    row = blockIdx.x / nparts;
    t = rank * blockDim.x + threadIdx.x;
    tr = nparts * blockDim.x;
  } else {
    row = blockIdx.x * (blockDim.x / p.team) + threadIdx.x / p.team;
    t = threadIdx.x % p.team;
    tr = p.team;
  }
  const bool live = row < p.rows;
  const bool ln = p.layernorm != 0;
  const size_t base = (size_t)(live ? row : 0) * p.hidden;
  const T* res = static_cast<const T*>(p.res) + base;
  const T* x = static_cast<const T*>(p.x) + base;
  const TG* gamma = static_cast<const TG*>(p.gamma);
  const TG* beta = static_cast<const TG*>(p.beta);
  const int lim = live ? p.hidden : 0;          // a dead row reads nothing

  // one wave of loads: res, x, gamma (and beta) of every vector
  uint4 rw[NV], xw[NV], gw[NV][GW], bw[NV][GW];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int col0 = (t + j * tr) * V;
    load_raw<T, V, VEC>(res, col0, lim, &rw[j]);
    load_raw<T, V, VEC>(x, col0, lim, &xw[j]);
    load_raw<TG, V, VEC>(gamma, col0, lim, gw[j]);
    if (ln) load_raw<TG, V, VEC>(beta, col0, lim, bw[j]);
  }

  // y = res + x rounded to T, kept in f32; store y; partial sums
  float yf[NV][V];
  float2 s = make_float2(0.f, 0.f);
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    float a[V], b[V];
    widen<T, V>(&rw[j], a);
    widen<T, V>(&xw[j], b);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      yf[j][e] = Vec<T>::widen1(Vec<T>::narrow1(a[e] + b[e]));
      s.x += yf[j][e];
      s.y += yf[j][e] * yf[j][e];
    }
    store<T, VEC>(static_cast<T*>(p.y) + base, (t + j * tr) * V, lim,
                  yf[j]);
  }

  // the row's sums: shuffles, then the partials of the team's warps (and
  // the cluster's CTAs): lane i of every warp reads partials i, i + 32,
  // ... (one round trip, in parallel), then the same shuffle tree.  Every
  // warp, in every CTA, sums the same values in the same order.
  s = warp_sum2(s, ln);
  const int team_warps = CLUSTER ? (int)(blockDim.x >> 5) : (p.team >> 5);
  if (CLUSTER || team_warps > 1) {
    const int lane = threadIdx.x & 31;
    if (lane == 0) red[warp] = s;
    const int nparts_all = nparts * team_warps;
    s = make_float2(0.f, 0.f);
    if (CLUSTER) {
      cg::cluster_group cluster = cg::this_cluster();
      cluster.sync();
      for (int i = lane; i < nparts_all; i += 32) {
        const float2 v =
            cluster.map_shared_rank(red, i / team_warps)[i % team_warps];
        s.x += v.x;
        s.y += v.y;
      }
      cluster_arrive();     // done with the others' shared memory
    } else {
      __syncthreads();
      const int w0 = (threadIdx.x / p.team) * team_warps;
      for (int i = lane; i < nparts_all; i += 32) {
        s.x += red[w0 + i].x;
        s.y += red[w0 + i].y;
      }
    }
    s = warp_sum2(s, ln);
  }

  const float mu = ln ? s.x * p.inv_h : 0.f;
  const float var = ln ? fmaxf(s.y * p.inv_h - mu * mu, 0.f) : s.y * p.inv_h;
  const float rs = rsqrtf(var + p.eps);
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    float g[V], b[V], o[V];
    widen<TG, V>(gw[j], g);
    if (ln) widen<TG, V>(bw[j], b);
#pragma unroll
    for (int e = 0; e < V; ++e)
      o[e] = ln ? (yf[j][e] - mu) * rs * g[e] + b[e] : yf[j][e] * rs * g[e];
    store<T, VEC>(static_cast<T*>(p.out) + base, (t + j * tr) * V, lim, o);
  }
  if (CLUSTER) cluster_wait();  // no CTA leaves while another reads it
}

template <typename T, typename TG, int NV, bool VEC>
int launch(Params& p, int cluster, int threads, cudaStream_t s) {
  if (cluster > 1) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)p.rows * cluster);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = 0;
    cfg.stream = s;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t err = cudaLaunchKernelEx(
        &cfg, fused_residual_norm_kernel<T, TG, NV, VEC, true>, p);
    if (err != cudaSuccess) return static_cast<int>(err);
  } else {
    const int rows_per_block = threads / p.team;
    const unsigned grid = (unsigned)((p.rows + rows_per_block - 1) /
                                     rows_per_block);
    fused_residual_norm_kernel<T, TG, NV, VEC, false>
        <<<grid, threads, 0, s>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename TG>
int launch_nv(Params& p, int nv, int vec, int cluster, int threads,
              cudaStream_t s) {
  switch (nv * 2 + (vec ? 1 : 0)) {
    case 2: return launch<T, TG, 1, false>(p, cluster, threads, s);
    case 3: return launch<T, TG, 1, true>(p, cluster, threads, s);
    case 4: return launch<T, TG, 2, false>(p, cluster, threads, s);
    case 5: return launch<T, TG, 2, true>(p, cluster, threads, s);
    case 8: return launch<T, TG, 4, false>(p, cluster, threads, s);
    case 9: return launch<T, TG, 4, true>(p, cluster, threads, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

__global__ void empty_kernel() {}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (res, x, y, out); gamma_f32: gamma and
// beta are float32 (else res's dtype).  cluster: CTAs a row (2, 4 or 8;
// 1 runs the "warp" design, `team` threads a row, threads / team rows a
// block); nv: vectors a thread (1, 2 or 4); vec: 16-byte accesses (the
// hidden size a multiple of the vector and every operand 16-byte
// aligned), else scalar.  Returns cudaGetLastError() after the launch
// (0 when it was accepted).
extern "C" int thb_fused_residual_norm(
    const void* res, const void* x, const void* gamma, const void* beta,
    void* y, void* out, int rows, int hidden, float eps, int layernorm,
    int dtype, int gamma_f32, int cluster, int threads, int team, int nv,
    int vec, void* stream) {
  if (rows == 0) return 0;
  Params p;
  p.res = res;
  p.x = x;
  p.gamma = gamma;
  p.beta = beta;
  p.y = y;
  p.out = out;
  p.rows = rows;
  p.hidden = hidden;
  p.team = cluster > 1 ? threads : team;
  p.layernorm = layernorm;
  p.eps = eps;
  p.inv_h = 1.f / (float)hidden;
  if (p.team <= 0 || threads % 32 || threads > kMaxThreads || p.team % 32 ||
      threads % p.team || cluster > 8 || (layernorm && beta == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_nv<float, float>(p, nv, vec, cluster, threads, s);
  if (gamma_f32)
    return launch_nv<bf16, float>(p, nv, vec, cluster, threads, s);
  return launch_nv<bf16, bf16>(p, nv, vec, cluster, threads, s);
}

// An empty kernel on `cluster` CTAs of 32 threads, as one cluster when
// cluster > 1: the floor under which no launch of the kernel above can
// finish (chip_smoke.py times it beside the kernel).
extern "C" int thb_empty_launch(int cluster, void* stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster > 1 ? cluster : 1);
  cfg.blockDim = dim3(32);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster > 1 ? cluster : 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, empty_kernel);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}
