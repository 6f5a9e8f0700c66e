// The bf16 flash dq's instantiations of 64-row tiles (4 warps), one for each
// head dim and key tile that builds without a spill (flash_bwd_tc.cuh has
// the walks; tune/autotune.py::TILE_GRID and DROPPED_TILES list the same
// tiles for the tuner and the wrappers).
#include "flash_bwd_tc.cuh"

namespace rt {
namespace tc {

int flash_dq_r64(const BwdArgs& a, int d, int keys, int bhq, cudaStream_t s) {
  if (d == 64 && keys == 64)
    return launch_bwd_walk<64, 64, 64, false>(attn_bwd_dq_mma_kernel<64, 64, 64>, a, bhq, s);
  if (d == 64 && keys == 128)
    return launch_bwd_walk<64, 64, 128, false>(attn_bwd_dq_mma_kernel<64, 64, 128>, a, bhq, s);
  if (d == 112 && keys == 64)
    return launch_bwd_walk<112, 64, 64, false>(attn_bwd_dq_mma_kernel<112, 64, 64>, a, bhq, s);
  if (d == 128 && keys == 64)
    return launch_bwd_walk<128, 64, 64, false>(attn_bwd_dq_mma_kernel<128, 64, 64>, a, bhq, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace tc
}  // namespace rt
