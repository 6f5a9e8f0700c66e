// The bf16 DistrAttention forward's instantiations: 64-row CTAs (4 warps),
// one for each head dim and key tile that builds without a spill
// (distr_fwd_tc.cuh has the kernel; tune/autotune.py::TILE_GRID and
// DROPPED_TILES list the same tiles for the tuner and the wrappers).
#include "distr_fwd_tc.cuh"

namespace rt {
namespace tc {

int distr_fwd_r64(const AttnArgs& a, int d, int bn, int bhq, cudaStream_t s) {
  if (d == 64 && bn == 64)
    return launch_walk<64, 64, 64>(distr_fwd_exact_kernel<64, 64>, a, bhq, s);
  if (d == 64 && bn == 128)
    return launch_walk<64, 64, 128>(distr_fwd_exact_kernel<64, 128>, a, bhq, s);
  if (d == 112 && bn == 64)
    return launch_walk<112, 64, 64>(distr_fwd_exact_kernel<112, 64>, a, bhq, s);
  if (d == 128 && bn == 64)
    return launch_walk<128, 64, 64>(distr_fwd_exact_kernel<128, 64>, a, bhq, s);
  if (d == 128 && bn == 128)
    return launch_walk<128, 64, 128>(distr_fwd_exact_kernel<128, 128>, a, bhq, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace tc
}  // namespace rt
