// Exact FlashAttention-2 forward for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention.py::_flash_kernel (the Pallas
// TPU kernel launched by flash_attention_kernel_call).
//
// Computes O = softmax(scale · Q Kᵀ + mask) V per (batch, query head), GQA
// through kv head = bh / q_per_kv, causal tile skip, keys at or past kv_len
// masked in the kernel (K/V are never padded in device memory), optional
// per-row LSE.  A row that sees no key writes O = 0 and LSE = -1e30.
//
// Bound on this card: operations.  At prefill lengths the work is
// 4·N²·d/2 FLOPs (causal) against 4·N·d bytes per head, far above the
// ~295 FLOP/byte bf16 ridge.  This first version runs the two products as
// f32 FMA loops on CUDA cores over f32 shared-memory tiles (register tiles
// of 4 rows × 4 keys and 4 rows × 16 value columns per thread), so it is
// bounded by the f32 FMA rate and shared-memory bandwidth rather than the
// tensor cores; moving both products to wgmma is the next step.  The tile
// loop itself is in attention_tile.cuh.
#include "attention_tile.cuh"

extern "C" int repro_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                               int dtype, int bhq, int n_rows, int nk, int kv_len, int d,
                               int q_per_kv, float scale, int causal, void* stream) {
  rt::AttnArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.perm = nullptr;
  a.o = o;
  a.lse = static_cast<float*>(lse);
  a.n_rows = n_rows;
  a.nk = nk;
  a.kv_len = kv_len;
  a.ds = d;
  a.q_per_kv = q_per_kv;
  a.group_size = 1;
  a.block_q = 0;
  a.n_perm_blocks = 0;
  a.scale = scale;
  a.causal = causal;
  return rt::dispatch_attn_fwd<false>(a, dtype, d, bhq, static_cast<cudaStream_t>(stream));
}
