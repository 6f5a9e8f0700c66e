// DistrAttention backward for Hopper (sm_90a): dQ̂ in the sampled space and
// per-query-head dK / dV.
//
// Replaces: src/repro/kernels/backward.py::_distr_dq_kernel and
// ::_distr_dkv_kernel (the Pallas TPU kernels launched by
// distr_dq_kernel_call and distr_dkv_kernel_call).
//
// Q̂ arrives sampled and pre-scaled (width d/G*) with one int32 permutation
// per block_q query rows, as in the forward.  Both kernels re-fuse
// K̂ = Σ_u K[:, perm[g·G* + u]] under the Q block's permutation in shared
// memory, recompute S = Q̂ K̂ᵀ from the forward's LSE, mask P directly and
// form dS = P * (dO Vᵀ - D).  dq accumulates dQ̂ = Σ dS K̂ (no scale: Q̂
// carries it; the wrapper maps dQ̂ back to full-width dQ).  dkv accumulates
// dV = Σ Pᵀ dO in registers and scatters each tile's dK̂ = dSᵀ Q̂ into an f32
// dK tile in shared memory through the permutation: within one Q block the
// permutation is a bijection, so each of the d columns receives exactly one
// fused column's gradient.  That replaces the TPU kernel's gather by
// inv_perm, which therefore is not an input here.  A CTA's query rows (64
// in dq, 32 per tile in dkv) lie inside one permutation block because the
// wrapper requires 64 | block_q.
//
// Bound on this card: operations, as for the exact backward, with the
// score-side products (S, and dQ̂ or dK̂) at width d/G* and dP, dV at full
// width.  The products are f32 FMA loops on CUDA cores
// (attention_bwd_tile.cuh); the fusion and the scatter are shared-memory
// passes per tile.  Tensor-core products come later.
#include "attention_bwd_tile.cuh"

extern "C" int repro_distr_dq(const void* q_hat, const void* k, const void* v, const void* perm,
                              const void* dout, const void* lse, const void* delta, void* dq_hat,
                              int dtype, int bhq, int n_rows, int nk, int kv_len, int d,
                              int group_size, int block_q, int n_perm_blocks, int q_per_kv,
                              int causal, void* stream) {
  const rt::BwdArgs a =
      rt::bwd_args(q_hat, k, v, perm, dout, lse, delta, dq_hat, nullptr, nullptr, n_rows, nk,
                   kv_len, d / group_size, q_per_kv, group_size, block_q, n_perm_blocks, 1.0f,
                   causal);
  return rt::dispatch_attn_bwd<true, false>(a, dtype, d, bhq, static_cast<cudaStream_t>(stream));
}

extern "C" int repro_distr_dkv(const void* q_hat, const void* k, const void* v, const void* perm,
                               const void* dout, const void* lse, const void* delta, void* dk,
                               void* dv, int dtype, int bhq, int n_rows, int nk, int kv_len, int d,
                               int group_size, int block_q, int n_perm_blocks, int q_per_kv,
                               int causal, void* stream) {
  const rt::BwdArgs a =
      rt::bwd_args(q_hat, k, v, perm, dout, lse, delta, nullptr, dk, dv, n_rows, nk, kv_len,
                   d / group_size, q_per_kv, group_size, block_q, n_perm_blocks, 1.0f, causal);
  return rt::dispatch_attn_bwd<true, true>(a, dtype, d, bhq, static_cast<cudaStream_t>(stream));
}
