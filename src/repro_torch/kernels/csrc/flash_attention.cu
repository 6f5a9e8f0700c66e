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
// ~295 FLOP/byte bf16 ridge.  bf16, the dtype of every full-size config,
// runs on the tensor cores (flash_fwd_tc.cuh: mma.sync with ldmatrix
// operands and a cp.async K/V ring).  f32 runs the FMA tile that
// DistrAttention shares (attention_tile.cuh): tensor cores would compute
// f32 as TF32, a different result.
//
// (block_q, block_k) name the tile: in bf16 one of the tensor-core tiles
// that flash_fwd_r64.cu and flash_fwd_r128.cu compile, in f32 the FMA
// tile's 64 × 32.  Any other tile returns cudaErrorInvalidValue: nothing
// falls back to another tile.
#include "flash_fwd_tc.cuh"

extern "C" int repro_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                               int dtype, int bhq, int n_rows, int nk, int kv_len, int d,
                               int q_per_kv, float scale, int causal, int block_q,
                               int block_k, void* stream) {
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
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == rt::DTYPE_BF16) return rt::tc::dispatch_attn_fwd_mma(a, d, block_q, block_k, bhq, s);
  if (dtype != rt::DTYPE_F32 || block_q != rt::BM || block_k != rt::BN)
    return (int)cudaErrorInvalidValue;
  if (d == 128) return rt::launch_attn_fwd<float, 128, false>(a, bhq, s);
  if (d == 112) return rt::launch_attn_fwd<float, 112, false>(a, bhq, s);
  if (d == 64) return rt::launch_attn_fwd<float, 64, false>(a, bhq, s);
  return (int)cudaErrorInvalidValue;
}
