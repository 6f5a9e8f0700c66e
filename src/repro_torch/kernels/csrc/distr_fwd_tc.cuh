// DistrAttention forward on Hopper's tensor cores, bf16 in and out (sm_90a).
//
// Replaces: src/repro/kernels/distr_attention.py::_distr_kernel for bf16
// inputs (distr_attention.cu routes f32 to the FMA tile, attention_tile.cuh).
//
// Q̂ arrives sampled and pre-scaled (width ds = d/G*), with one permutation
// per block_q rows; a CTA's 64 rows lie in one permutation block (the
// wrapper keeps 64 | block_q).  K̂[j][g] = Σ_u K[j][perm[g·G* + u]], and
// Q̂·K̂ᵀ = Q̃·Kᵀ with Q̃[:, perm[g·G* + u]] = Q̂[:, g] for u < G*: every
// column of K lies in exactly one group.  So the CTA's Q̂ rows and
// permutation arrive by cp.async beside the first K/V tile and are
// scattered into the Q tile once; then the walk is the flash forward's
// (flash_fwd_tc.cuh: mma.sync bf16 → f32 with ldmatrix operands, P in
// registers, a 2-stage cp.async K/V ring of BN-key tiles, 64-row CTAs of 4
// warps, the longest causal CTAs first) against raw K at full width d.
// BN is a template argument (64, the static tile, or 128, where it builds
// without a spill: distr_fwd_r64.cu lists them); the CTA's rows stay 64,
// so that they lie in one permutation block for every block_q the tuner
// takes (kernels/distr_attention.py::ROW_TILE divides block_q).
// Scores are sums of exact products of bf16 values in f32, as the plain
// version's f32 K̂ gives them, so the LSE holds 1e-4 and agrees with the K̂
// the backward kernels recompute.
//
// The paper's reduced-width product (K̂ fused per tile in shared memory,
// scores over d/G*) was built on this walk too and lost to this kernel at
// every serving shape: the per-tile gather costs what the narrower product
// saves, and K̂ rounded to bf16 moves the LSE past 1e-4 (PERF.md §6, §7).
//
// Bound on this card: operations, the score product at d/G* and P·V at d.
// Shared memory as the flash tile's: 87,040 bytes at d = 128 and BN = 64,
// two CTAs an SM.
#pragma once

#include "flash_fwd_tc.cuh"

namespace rt {
namespace tc {

// Q̂ scattered to Q̃ at width D.  perm must be a permutation of [0, D), so
// that every column of Q̃ is written once.  The CTA's Q̂ rows are one
// contiguous span of 128·ds bytes (the wrapper keeps 64 | N), 16-byte
// aligned like its permutation's d ints: both go through cp.async into ring
// stage 1 of K, idle until the walk starts, and are scattered from there.
template <int D, int BN_>
struct DistrExactQK {
  __device__ __forceinline__ void load_q(const AttnArgs& a, bf16*, bf16* sK, int bh, int q0) {
    const int q_bytes = BM * a.ds * (int)sizeof(bf16);
    const char* qh = static_cast<const char*>(a.q) +
                     ((size_t)bh * a.n_rows + q0) * a.ds * sizeof(bf16);
    const char* perm = reinterpret_cast<const char*>(
        a.perm + ((size_t)bh * a.n_perm_blocks + q0 / a.block_q) * D);
    unsigned char* dst = reinterpret_cast<unsigned char*>(sK + BN_ * (D + 8));
    for (int off = threadIdx.x * 16; off < q_bytes; off += THREADS * 16)
      cp_async16(smem_addr(dst + off), qh + off, true);
    for (int off = threadIdx.x * 16; off < D * 4; off += THREADS * 16)
      cp_async16(smem_addr(dst + q_bytes + off), perm + off, true);
  }
  // Thread t scatters column t % ds of rows t / ds + i · (THREADS / ds)
  // (ds ≤ d ≤ THREADS).
  __device__ __forceinline__ void finish_q(const AttnArgs& a, bf16* sQ, bf16* sK) {
    const bf16* scratch = sK + BN_ * (D + 8);
    const int ds = a.ds;
    const int g = a.group_size;
    const int step = THREADS / ds;
    const int col = threadIdx.x % ds;
    const int* perm = reinterpret_cast<const int*>(scratch + BM * ds) + col * g;
    if (threadIdx.x < step * ds) {
#pragma unroll 4
      for (int row = threadIdx.x / ds; row < BM; row += step) {
        const bf16 x = scratch[row * ds + col];
        for (int u = 0; u < g; ++u) sQ[row * (D + 8) + perm[u]] = x;
      }
    }
    __syncthreads();
  }
};

// Two CTAs an SM, what the shared memory allows at d ≥ 112: without the
// hint ptxas gave the kernel at d = 112 a tighter register budget than the
// flash kernel's and a slower schedule (PERF.md §6).
template <int D, int BN_>
__global__ void __launch_bounds__(THREADS, 2) distr_fwd_exact_kernel(AttnArgs a) {
  DistrExactQK<D, BN_> qk;
  fwd_mma_walk<D, BM, BN_>(a, qk);
}

// The instantiations (distr_fwd_r64.cu): launch the (d, bn) tile, or
// return cudaErrorInvalidValue for one that was not compiled.
int distr_fwd_r64(const AttnArgs& a, int d, int bn, int bhq, cudaStream_t stream);

}  // namespace tc
}  // namespace rt
