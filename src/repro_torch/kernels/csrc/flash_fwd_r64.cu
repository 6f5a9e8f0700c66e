// The bf16 flash forward's instantiations of 64-row tiles (4 warps), one
// for each head dim and key tile that builds without a spill
// (flash_fwd_tc.cuh has the walk; tune/autotune.py::TILE_GRID and
// DROPPED_TILES list the same tiles for the tuner and the wrappers).
#include "flash_fwd_tc.cuh"

namespace rt {
namespace tc {

int flash_fwd_r64(const AttnArgs& a, int d, int bn, int bhq, cudaStream_t s) {
  if (d == 64 && bn == 64)
    return launch_walk<64, 64, 64>(attn_fwd_mma_kernel<64, 64, 64>, a, bhq, s);
  if (d == 64 && bn == 128)
    return launch_walk<64, 64, 128>(attn_fwd_mma_kernel<64, 64, 128>, a, bhq, s);
  if (d == 112 && bn == 64)
    return launch_walk<112, 64, 64>(attn_fwd_mma_kernel<112, 64, 64>, a, bhq, s);
  if (d == 128 && bn == 64)
    return launch_walk<128, 64, 64>(attn_fwd_mma_kernel<128, 64, 64>, a, bhq, s);
  if (d == 128 && bn == 128)
    return launch_walk<128, 64, 128>(attn_fwd_mma_kernel<128, 64, 128>, a, bhq, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace tc
}  // namespace rt
