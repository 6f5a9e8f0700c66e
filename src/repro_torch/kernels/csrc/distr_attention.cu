// DistrAttention forward (paper §3.3 fused into FA-2) for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/distr_attention.py::_distr_kernel (the Pallas
// TPU kernel launched by distr_attention_kernel_call, with fuse_k_columns).
//
// Q arrives sampled and pre-scaled (Q̂, width d/G*), with one int32
// permutation per block_q query rows; K̂[j][g] = Σ_u K[j][perm[g·G* + u]]
// depends on the (Q block, K tile) pair and never reaches device memory.
// The CTA's 64 rows lie inside one permutation block because the wrapper
// requires 64 | block_q.
//
// Bound on this card: operations, as for the exact kernel, with the score
// product cut by G*.  bf16 runs on the tensor cores (distr_fwd_tc.cuh, on
// the flash forward's mma.sync walk) as the exact product Q̃·Kᵀ, Q̂
// scattered through the permutation, which the backward's recomputed K̂
// agrees with.  f32 runs the FMA tile (attention_tile.cuh), which fuses K̂
// per tile: tensor cores would compute f32 as TF32, a different result.
//
// (block_rows, block_k) name the CTA's tile: in bf16 64 rows and one of
// the key tiles distr_fwd_r64.cu compiles, in f32 the FMA tile's 64 × 32.
// Any other tile returns cudaErrorInvalidValue.
#include "distr_fwd_tc.cuh"

extern "C" int repro_distr_fwd(const void* q_hat, const void* k, const void* v, const void* perm,
                               void* o, void* lse, int dtype, int bhq, int n_rows, int nk,
                               int kv_len, int d, int group_size, int block_q, int n_perm_blocks,
                               int q_per_kv, int causal, int block_rows, int block_k,
                               void* stream) {
  rt::AttnArgs a;
  a.q = q_hat;
  a.k = k;
  a.v = v;
  a.perm = static_cast<const int*>(perm);
  a.o = o;
  a.lse = static_cast<float*>(lse);
  a.n_rows = n_rows;
  a.nk = nk;
  a.kv_len = kv_len;
  a.ds = d / group_size;
  a.q_per_kv = q_per_kv;
  a.group_size = group_size;
  a.block_q = block_q;
  a.n_perm_blocks = n_perm_blocks;
  a.scale = 1.0f;  // Q̂ carries the softmax scale
  a.causal = causal;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == rt::DTYPE_BF16) {
    if (block_rows != rt::tc::BM) return (int)cudaErrorInvalidValue;
    return rt::tc::distr_fwd_r64(a, d, block_k, bhq, s);
  }
  if (dtype != rt::DTYPE_F32 || block_rows != rt::BM || block_k != rt::BN)
    return (int)cudaErrorInvalidValue;
  if (d == 128) return rt::launch_attn_fwd<float, 128, true>(a, bhq, s);
  if (d == 112) return rt::launch_attn_fwd<float, 112, true>(a, bhq, s);
  if (d == 64) return rt::launch_attn_fwd<float, 64, true>(a, bhq, s);
  return (int)cudaErrorInvalidValue;
}
