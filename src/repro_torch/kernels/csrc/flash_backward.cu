// Exact FlashAttention-2 backward for Hopper (sm_90a): dQ and per-query-head
// dK / dV.
//
// Replaces: src/repro/kernels/backward.py::_flash_dq_kernel and
// ::_flash_dkv_kernel (the Pallas TPU kernels launched by
// flash_dq_kernel_call and flash_dkv_kernel_call).
//
// Both recompute S = scale · Q Kᵀ per tile from the forward's LSE, mask P
// directly and form dS = P * (dO Vᵀ - D).  dq accumulates dQ = scale · Σ dS K
// over KV tiles in registers, one CTA per 64 query rows; dkv accumulates
// dV = Σ Pᵀ dO and dK = scale · Σ dSᵀ Q over Q tiles in registers, one CTA
// per 64 keys of one query head.  The TPU kernels' sequential grid axis is
// the loop inside the CTA, so nothing crosses CTAs and no atomics are
// needed; the wrapper sums dK / dV over each GQA group.
//
// Bound on this card: operations.  Per causal (q, k) pair dq does 3
// products (S, dP, dQ: 6·d FLOPs) and dkv 4 (S, dP, dV, dK: 8·d), where the
// forward does 2, against O(N·d) bytes per head.  bf16, the dtype of every
// full-size config, runs on the tensor cores (flash_bwd_tc.cuh: mma.sync
// with ldmatrix operands, P and dS split into bf16 hi + lo, a cp.async
// ring).  f32 runs the FMA tile that the DistrAttention backward shares
// (attention_bwd_tile.cuh): tensor cores would compute f32 as TF32, a
// different result.
//
// (block_q, block_k) name the tile, (rows, keys): in bf16 one of the
// tensor-core tiles flash_dq_r*.cu and flash_dkv_r*.cu compile, in f32
// the FMA tile's.  Any other tile returns cudaErrorInvalidValue: nothing
// falls back to another tile.
#include "flash_bwd_tc.cuh"

template <bool DKV>
static int flash_bwd(const rt::BwdArgs& a, int dtype, int d, int bhq, int rows, int keys,
                     void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == rt::DTYPE_BF16) return rt::tc::dispatch_attn_bwd_mma<DKV>(a, d, rows, keys, bhq, s);
  const bool fma_tile = DKV ? rows == rt::DKV_BQ && keys == rt::DKV_BK
                            : rows == rt::DQ_BM && keys == rt::DQ_BN;
  if (dtype != rt::DTYPE_F32 || !fma_tile) return (int)cudaErrorInvalidValue;
  if (d == 128) return rt::launch_attn_bwd<128, false, DKV>(a, bhq, s);
  if (d == 112) return rt::launch_attn_bwd<112, false, DKV>(a, bhq, s);
  if (d == 64) return rt::launch_attn_bwd<64, false, DKV>(a, bhq, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int repro_flash_dq(const void* q, const void* k, const void* v, const void* dout,
                              const void* lse, const void* delta, void* dq, int dtype, int bhq,
                              int n_rows, int nk, int kv_len, int d, int q_per_kv, float scale,
                              int causal, int block_q, int block_k, void* stream) {
  const rt::BwdArgs a = rt::bwd_args(q, k, v, nullptr, dout, lse, delta, dq, nullptr, nullptr,
                                     n_rows, nk, kv_len, d, q_per_kv, 1, 0, 0, scale, causal);
  return flash_bwd<false>(a, dtype, d, bhq, block_q, block_k, stream);
}

extern "C" int repro_flash_dkv(const void* q, const void* k, const void* v, const void* dout,
                               const void* lse, const void* delta, void* dk, void* dv, int dtype,
                               int bhq, int n_rows, int nk, int kv_len, int d, int q_per_kv,
                               float scale, int causal, int block_q, int block_k,
                               void* stream) {
  const rt::BwdArgs a = rt::bwd_args(q, k, v, nullptr, dout, lse, delta, nullptr, dk, dv, n_rows,
                                     nk, kv_len, d, q_per_kv, 1, 0, 0, scale, causal);
  return flash_bwd<true>(a, dtype, d, bhq, block_q, block_k, stream);
}
