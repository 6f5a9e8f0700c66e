// The bf16 DistrAttention dkv's instantiations (Q tiles of dkv_rows<d>()),
// one for each head dim and key tile that builds without a spill
// (distr_bwd_tc.cuh has the kernels; tune/autotune.py::TILE_GRID and
// DROPPED_TILES list the same tiles for the tuner and the wrappers).
#include "distr_bwd_tc.cuh"

namespace rt {
namespace tc {

int distr_dkv(const BwdArgs& a, int d, int keys, int bhq, cudaStream_t s) {
  if (d == 64 && keys == 64) return launch_distr_walk<64, 64, true>(a, bhq, s);
  if (d == 64 && keys == 128) return launch_distr_walk<64, 128, true>(a, bhq, s);
  if (d == 112 && keys == 64) return launch_distr_walk<112, 64, true>(a, bhq, s);
  if (d == 112 && keys == 128) return launch_distr_walk<112, 128, true>(a, bhq, s);
  if (d == 128 && keys == 64) return launch_distr_walk<128, 64, true>(a, bhq, s);
  if (d == 128 && keys == 128) return launch_distr_walk<128, 128, true>(a, bhq, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace tc
}  // namespace rt
