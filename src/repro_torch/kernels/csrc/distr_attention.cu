// DistrAttention forward (paper §3.3 fused into FA-2) for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/distr_attention.py::_distr_kernel (the Pallas
// TPU kernel launched by distr_attention_kernel_call, with fuse_k_columns).
//
// Q arrives sampled and pre-scaled (Q̂, width d/G*), with one int32
// permutation per block_q query rows.  For every KV tile the kernel gathers
// K's d columns by the CTA's permutation and sums each run of G* in shared
// memory (K̂ is never written to device memory: it depends on the
// (Q block, K tile) pair), contracts the scores over d/G* and runs the same
// online softmax and full-width P·V as the exact kernel.  The CTA's 64 rows
// lie inside one permutation block because the wrapper requires 64 | block_q.
//
// Bound on this card: operations, as for the exact kernel, with the score
// product cut by G*.  The paper fuses K with warp shuffles; here the fusion
// is a shared-memory gather per tile, and both products are f32 FMA loops on
// CUDA cores (attention_tile.cuh) — tensor-core products come later.
#include "attention_tile.cuh"

extern "C" int repro_distr_fwd(const void* q_hat, const void* k, const void* v, const void* perm,
                               void* o, void* lse, int dtype, int bhq, int n_rows, int nk,
                               int kv_len, int d, int group_size, int block_q, int n_perm_blocks,
                               int q_per_kv, int causal, void* stream) {
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
  return rt::dispatch_attn_fwd<true>(a, dtype, d, bhq, static_cast<cudaStream_t>(stream));
}
