// DistrAttention backward for Hopper (sm_90a): dQ̂ in the sampled space and
// per-query-head dK / dV.
//
// Replaces: src/repro/kernels/backward.py::_distr_dq_kernel and
// ::_distr_dkv_kernel (the Pallas TPU kernels launched by
// distr_dq_kernel_call and distr_dkv_kernel_call).
//
// Q̂ arrives sampled and pre-scaled (width d/G*) with one int32 permutation
// per block_q query rows, as in the forward.  dq gives dQ̂ = Σ dS K̂ (no
// scale: Q̂ carries it; the wrapper maps dQ̂ back to full-width dQ); dkv
// gives dV = Σ Pᵀ dO and dK, dK̂ = dSᵀ Q̂ taken back to full width through
// the permutation.  Neither takes the reference's inverse permutation.
//
// Bound on this card: operations, as for the exact backward, with the
// score-side products (S, and dQ̂ or dK̂) at width d/G* and dP, dV at full
// width.  bf16, the dtype of every full-size config, runs on the tensor
// cores (distr_bwd_tc.cuh): Q̂ expanded to a full-width Q̃ through the
// permutation, then the flash backward's walks over it.  f32 runs the FMA
// tile (attention_bwd_tile.cuh), which re-fuses K̂ per Q block in shared
// memory and scatters dK̂ through the permutation: tensor cores would
// compute f32 as TF32, a different result.
//
// (block_rows, block_k) name the tile: in bf16 the walk's fixed rows (64
// for dq, dkv_rows<d>() for dkv) and one of the key tiles distr_dq_r64.cu
// and distr_dkv.cu compile, in f32 the FMA tile's.  Any other tile returns
// cudaErrorInvalidValue.
#include "distr_bwd_tc.cuh"

template <bool DKV>
static int distr_bwd(const rt::BwdArgs& a, void* q_tilde, int dtype, int d, int bhq, int rows,
                     int keys, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == rt::DTYPE_BF16)
    return rt::tc::dispatch_distr_bwd_mma<DKV>(a, q_tilde, d, rows, keys, bhq, s);
  const bool fma_tile = DKV ? rows == rt::DKV_BQ && keys == rt::DKV_BK
                            : rows == rt::DQ_BM && keys == rt::DQ_BN;
  if (dtype != rt::DTYPE_F32 || !fma_tile) return (int)cudaErrorInvalidValue;
  if (d == 128) return rt::launch_attn_bwd<128, true, DKV>(a, bhq, s);
  if (d == 112) return rt::launch_attn_bwd<112, true, DKV>(a, bhq, s);
  if (d == 64) return rt::launch_attn_bwd<64, true, DKV>(a, bhq, s);
  return (int)cudaErrorInvalidValue;
}

// q_tilde: bf16 scratch of (bhq, n_rows, d) for the expanded Q̂; unused in f32.
extern "C" int repro_distr_dq(const void* q_hat, const void* k, const void* v, const void* perm,
                              const void* dout, const void* lse, const void* delta, void* dq_hat,
                              void* q_tilde, int dtype, int bhq, int n_rows, int nk, int kv_len,
                              int d, int group_size, int block_q, int n_perm_blocks, int q_per_kv,
                              int causal, int block_rows, int block_k, void* stream) {
  const rt::BwdArgs a =
      rt::bwd_args(q_hat, k, v, perm, dout, lse, delta, dq_hat, nullptr, nullptr, n_rows, nk,
                   kv_len, d / group_size, q_per_kv, group_size, block_q, n_perm_blocks, 1.0f,
                   causal);
  return distr_bwd<false>(a, q_tilde, dtype, d, bhq, block_rows, block_k, stream);
}

extern "C" int repro_distr_dkv(const void* q_hat, const void* k, const void* v, const void* perm,
                               const void* dout, const void* lse, const void* delta, void* dk,
                               void* dv, void* q_tilde, int dtype, int bhq, int n_rows, int nk,
                               int kv_len, int d, int group_size, int block_q, int n_perm_blocks,
                               int q_per_kv, int causal, int block_rows, int block_k,
                               void* stream) {
  const rt::BwdArgs a =
      rt::bwd_args(q_hat, k, v, perm, dout, lse, delta, nullptr, dk, dv, n_rows, nk, kv_len,
                   d / group_size, q_per_kv, group_size, block_q, n_perm_blocks, 1.0f, causal);
  return distr_bwd<true>(a, q_tilde, dtype, d, bhq, block_rows, block_k, stream);
}
