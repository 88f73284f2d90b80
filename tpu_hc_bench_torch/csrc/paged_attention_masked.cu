// Paged decode attention at a head dim off the template list (any d up
// to 256 other than 16, 32, 64, 128 and 256): the split kernel of the
// next listed head dim D > d with MASK = true (rows d values apart, the
// lanes past d read 0 and store nothing), for every pool type.  Kept apart
// from paged_attention.cu so the two compile in parallel; the C entry and
// the merge kernel are there.

#include "paged_attention.cuh"

namespace thb_paged {

int launch_split_masked(const Params& p, int b, int g_tile, int pool_dtype,
                        cudaStream_t s) {
  switch (pool_dtype) {
    case 0: return launch_split_d<float, true>(p, b, g_tile, s);
    case 1: return launch_split_d<bf16, true>(p, b, g_tile, s);
    case 2: return launch_split_d<int8_t, true>(p, b, g_tile, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace thb_paged
