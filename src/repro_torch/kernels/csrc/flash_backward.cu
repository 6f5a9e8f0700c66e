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
// forward does 2, against O(N·d) bytes per head.  This first version runs
// every product as f32 FMA loops on CUDA cores over f32 shared-memory tiles
// (4 × 4 register tiles, float4 operand reads, causal tile skip), so it is
// bounded by the f32 FMA rate and shared-memory bandwidth, not by the
// tensor cores; wgmma and TMA staging are the next step.  The loops are in
// attention_bwd_tile.cuh.
#include "attention_bwd_tile.cuh"

extern "C" int repro_flash_dq(const void* q, const void* k, const void* v, const void* dout,
                              const void* lse, const void* delta, void* dq, int dtype, int bhq,
                              int n_rows, int nk, int kv_len, int d, int q_per_kv, float scale,
                              int causal, void* stream) {
  const rt::BwdArgs a = rt::bwd_args(q, k, v, nullptr, dout, lse, delta, dq, nullptr, nullptr,
                                     n_rows, nk, kv_len, d, q_per_kv, 1, 0, 0, scale, causal);
  return rt::dispatch_attn_bwd<false, false>(a, dtype, d, bhq, static_cast<cudaStream_t>(stream));
}

extern "C" int repro_flash_dkv(const void* q, const void* k, const void* v, const void* dout,
                               const void* lse, const void* delta, void* dk, void* dv, int dtype,
                               int bhq, int n_rows, int nk, int kv_len, int d, int q_per_kv,
                               float scale, int causal, void* stream) {
  const rt::BwdArgs a = rt::bwd_args(q, k, v, nullptr, dout, lse, delta, nullptr, dk, dv, n_rows,
                                     nk, kv_len, d, q_per_kv, 1, 0, 0, scale, causal);
  return rt::dispatch_attn_bwd<false, true>(a, dtype, d, bhq, static_cast<cudaStream_t>(stream));
}
