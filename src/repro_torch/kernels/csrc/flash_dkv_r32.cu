// The bf16 flash dkv's instantiations of 32-row Q tiles, one for each
// head dim and key tile that builds without a spill (flash_bwd_tc.cuh has
// the walks; tune/autotune.py::TILE_GRID and DROPPED_TILES list the same
// tiles for the tuner and the wrappers).
#include "flash_bwd_tc.cuh"

namespace rt {
namespace tc {

int flash_dkv_r32(const BwdArgs& a, int d, int keys, int bhq, cudaStream_t s) {
  if (d == 64 && keys == 64)
    return launch_bwd_walk<64, 32, 64, true>(attn_bwd_dkv_mma_kernel<64, 32, 64>, a, bhq, s);
  if (d == 64 && keys == 128)
    return launch_bwd_walk<64, 32, 128, true>(attn_bwd_dkv_mma_kernel<64, 32, 128>, a, bhq, s);
  if (d == 112 && keys == 64)
    return launch_bwd_walk<112, 32, 64, true>(attn_bwd_dkv_mma_kernel<112, 32, 64>, a, bhq, s);
  if (d == 112 && keys == 128)
    return launch_bwd_walk<112, 32, 128, true>(attn_bwd_dkv_mma_kernel<112, 32, 128>, a, bhq, s);
  if (d == 128 && keys == 64)
    return launch_bwd_walk<128, 32, 64, true>(attn_bwd_dkv_mma_kernel<128, 32, 64>, a, bhq, s);
  if (d == 128 && keys == 128)
    return launch_bwd_walk<128, 32, 128, true>(attn_bwd_dkv_mma_kernel<128, 32, 128>, a, bhq, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace tc
}  // namespace rt
