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
// - Any head dim from 1 to 256.  16, 32, 64, 128 and 256 are template
//   cases, free of masks; any other d runs the next listed case with MASK
//   (paged_attention_masked.cu): the pool is read in place at its row
//   stride of d values (no padded copy), the lanes past d read 0, so their
//   q.k terms and acc are 0, and store nothing.  Where d values are not a
//   whole number of 16-byte vectors (bf16 at d 20), the loads are scalar.
//
// Numerics, as the TPU kernel: f32 sums, masked scores -1e30,
// probabilities masked again after exp, l floored at 1e-30, lse = m +
// log(l); for a bf16 pool p is rounded to bf16 before P V (l sums the
// unrounded p).  A row of length 0 gives out 0 and lse ~ -1e30, finite.
// Slots past the table width (up to the width padded to a multiple of
// `pages_per_block`) read the trash page 0, as the TPU kernel's padded
// table does.

#include "paged_attention.cuh"

// pool_dtype: 0 float32, 1 bfloat16, 2 int8 (with f32 scales); q is f32
// or (q_bf16) bf16, and out takes q's dtype.  Head dim 1 to 256: 16, 32,
// 64, 128 and 256 run their own template case, any other d the next
// listed case masked to d (paged_attention_masked.cu), with 16-byte pool
// loads where `vec` (d values a multiple of 16 bytes and the pools 16-byte
// aligned), else scalar ones.  Group tiles of 1, 2, 4 or 8 query rows
// (g_tile; int8 up to 4; a larger group runs in several tiles, each
// reading the K/V rows again).  ws_acc / ws_ml: float32 workspace of b *
// kvh * splits * group * (d, 2) values.  Returns cudaGetLastError() after
// the two launches (0 when both were accepted).
extern "C" int thb_paged_decode_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scales, const void* v_scales, const void* tables,
    const void* lengths, void* out, void* lse, void* ws_acc, void* ws_ml,
    int b, int heads, int kvh, int d, int pages, int ps, int w, int ppb,
    int layer, int splits, int slots_per_split, int g_tile, float scale,
    int pool_dtype, int q_bf16, int vec, void* stream) {
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
  p.vec = vec;
  p.scale = scale;
  if (g_tile > thb_paged::kMaxGroup || d < 1 || d > 256 || b == 0)
    return b == 0 ? 0 : static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool listed = d == 16 || d == 32 || d == 64 || d == 128 || d == 256;
  int err;
  if (!listed) {
    err = thb_paged::launch_split_masked(p, b, g_tile, pool_dtype, s);
  } else {
    switch (pool_dtype) {
      case 0: err = launch_split_d<float, false>(p, b, g_tile, s); break;
      case 1: err = launch_split_d<bf16, false>(p, b, g_tile, s); break;
      case 2: err = launch_split_d<int8_t, false>(p, b, g_tile, s); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (err) return err;
  const int rows = 1024 / d < p.group ? 1024 / d : p.group;
  paged_decode_merge_kernel<<<dim3(b, kvh), dim3(d, rows), 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}
