// Split-K flash-decoding for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/decode.py::_decode_kernel (the Pallas TPU
// kernel launched by decode_kernel_call; merge_splits stays outside, as in
// the reference, where it runs as XLA).
//
// Grid (split, kv head, batch).  The q_per_kv query heads sharing a KV head
// (times q_len) are packed into up to 32 rows, loaded once per CTA, so K/V
// are read once per KV head.  A split reads only its live keys
// (min(block_k, length - split·block_k)); a split past the slot's length
// reads no K/V at all and writes identity stats (o = 0, m = -1e30, l = 0).
// Packed row r holds query token r % q_len and sees keys
// < length - (q_len - 1 - r % q_len).  The score width d_score may differ
// from the value width (the fused-K̂ cache).  Each split emits unnormalised
// partials o = Σ exp(s - m)·V, m = rowmax s, l = Σ exp(s - m).
//
// Bound on this card: bytes.  A decode step reads the live K/V once
// (2·length·d·2 bytes per KV head in bf16) for ~4·rows·length·d FLOPs —
// below 10 FLOP/byte, far under the ridge.  bf16, the dtype of every
// full-size config, runs the tensor-core tile decode_tc.cuh (a cp.async K/V
// ring, mma.sync scores, P·V with P split into bf16 hi + lo).  f32 runs the
// FMA loops below (tensor cores would compute f32 as TF32): thread t owns
// key t of the split for the scores (16-byte vector loads along its K row)
// and value column t for P·V, so every live K/V byte is read from device
// memory once per CTA.
#include "decode_tc.cuh"

namespace rt {

constexpr int DEC_THREADS = 128;
constexpr int MAX_ROWS = 32;

struct DecodeArgs {
  const void* q;        // (B, Hkv, rows, ds)
  const void* k;        // (B, Hkv, S, ds)
  const void* v;        // (B, Hkv, S, DV)
  const int* lengths;   // (B,) live tokens, ≤ S
  float* o;             // (B, Hkv, splits, rows, DV)
  float* m;             // (B, Hkv, splits, rows)
  float* l;             // (B, Hkv, splits, rows)
  int hkv;
  int rows;
  int s;
  int ds;
  int block_k;
  int q_len;
  int splits;
  float scale;
};

template <typename T, int DV>
__global__ void __launch_bounds__(DEC_THREADS) decode_kernel(DecodeArgs a) {
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;                   // [rows][ds]
  float* sS = sQ + a.rows * a.ds;     // [rows][block_k] scores, then P

  const int split = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int length = a.lengths[b];
  const int kv0 = split * a.block_k;
  const size_t bh = (size_t)b * a.hkv + h;
  const size_t stat = (bh * a.splits + split) * a.rows;
  float* o = a.o + stat * DV;

  if (kv0 >= length) {  // dead split
    for (int i = tid; i < a.rows * DV; i += DEC_THREADS) o[i] = 0.f;
    for (int i = tid; i < a.rows; i += DEC_THREADS) {
      a.m[stat + i] = NEG_INF;
      a.l[stat + i] = 0.f;
    }
    return;
  }
  const int n_live = min(a.block_k, length - kv0);
  const T* q = static_cast<const T*>(a.q) + bh * a.rows * a.ds;
  const T* k = static_cast<const T*>(a.k) + (bh * a.s + kv0) * a.ds;
  const T* v = static_cast<const T*>(a.v) + (bh * a.s + kv0) * DV;

  for (int i = tid; i < a.rows * a.ds; i += DEC_THREADS) sQ[i] = to_float(q[i]);
  __syncthreads();

  for (int key = tid; key < a.block_k; key += DEC_THREADS) {
    float acc[MAX_ROWS];
#pragma unroll
    for (int r = 0; r < MAX_ROWS; ++r) acc[r] = 0.f;
    if (key < n_live) {
      const T* krow = k + (size_t)key * a.ds;
      for (int kk = 0; kk < a.ds; kk += 8) {
        float kv[8];
        load8(krow + kk, kv);
#pragma unroll
        for (int r = 0; r < MAX_ROWS; ++r) {
          if (r < a.rows) {
            const float4 qa = *reinterpret_cast<const float4*>(sQ + r * a.ds + kk);
            const float4 qb = *reinterpret_cast<const float4*>(sQ + r * a.ds + kk + 4);
            float x = acc[r];
            x = fmaf(qa.x, kv[0], x);
            x = fmaf(qa.y, kv[1], x);
            x = fmaf(qa.z, kv[2], x);
            x = fmaf(qa.w, kv[3], x);
            x = fmaf(qb.x, kv[4], x);
            x = fmaf(qb.y, kv[5], x);
            x = fmaf(qb.z, kv[6], x);
            x = fmaf(qb.w, kv[7], x);
            acc[r] = x;
          }
        }
      }
    }
    const int col = kv0 + key;
#pragma unroll
    for (int r = 0; r < MAX_ROWS; ++r) {
      if (r < a.rows) {
        const int row_len = length - (a.q_len - 1 - r % a.q_len);
        sS[r * a.block_k + key] = (key < n_live && col < row_len) ? acc[r] * a.scale : NEG_INF;
      }
    }
  }
  __syncthreads();

  const int warp = tid >> 5;
  const int lane = tid & 31;
  for (int r = warp; r < a.rows; r += DEC_THREADS / 32) {
    float* srow = sS + r * a.block_k;
    float mx = NEG_INF;
    for (int j = lane; j < a.block_k; j += 32) mx = fmaxf(mx, srow[j]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < a.block_k; j += 32) {
      const float sv = srow[j];
      const float p = sv == NEG_INF ? 0.f : expf(sv - mx);
      srow[j] = p;
      sum += p;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      a.m[stat + r] = mx;
      a.l[stat + r] = sum;
    }
  }
  __syncthreads();

  for (int col = tid; col < DV; col += DEC_THREADS) {
    float acc[MAX_ROWS];
#pragma unroll
    for (int r = 0; r < MAX_ROWS; ++r) acc[r] = 0.f;
    for (int key = 0; key < n_live; ++key) {
      const float vv = to_float(v[(size_t)key * DV + col]);
#pragma unroll
      for (int r = 0; r < MAX_ROWS; ++r) {
        if (r < a.rows) acc[r] = fmaf(sS[r * a.block_k + key], vv, acc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < MAX_ROWS; ++r) {
      if (r < a.rows) o[(size_t)r * DV + col] = acc[r];
    }
  }
}

// The bf16 kernel: the split's K, V and q rows handed to the tensor-core tile.
template <int DV, int KW>
__global__ void __launch_bounds__(tc::DT_THREADS) decode_mma_kernel(DecodeArgs a) {
  using bf16 = __nv_bfloat16;
  const int split = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int length = a.lengths[b];
  const int kv0 = split * a.block_k;
  const size_t bh = (size_t)b * a.hkv + h;
  const size_t stat = (bh * a.splits + split) * a.rows;
  tc::DecodeTile t;
  t.o = a.o + stat * DV;
  t.m = a.m + stat;
  t.l = a.l + stat;
  if (kv0 >= length) {  // dead split
    tc::write_identity<DV>(t.o, t.m, t.l, a.rows);
    return;
  }
  t.q = static_cast<const bf16*>(a.q) + bh * a.rows * a.ds;
  t.k = static_cast<const bf16*>(a.k) + (bh * a.s + kv0) * a.ds;
  t.v = static_cast<const bf16*>(a.v) + (bh * a.s + kv0) * DV;
  t.rows = a.rows;
  t.ds = a.ds;
  t.q_len = a.q_len;
  t.n_live = min(a.block_k, length - kv0);
  t.len0 = length - kv0 - (a.q_len - 1);
  t.scale = a.scale;
  tc::decode_tile<DV, KW>(t);
}

template <int DV>
int launch_decode_mma(const DecodeArgs& a, int b, cudaStream_t stream) {
  const int kw = tc::decode_kw(a.rows);
  const size_t bytes = tc::decode_smem_bytes(a.ds, DV, kw);
  auto kern = kw == 4 ? decode_mma_kernel<DV, 4> : decode_mma_kernel<DV, 2>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.splits, a.hkv, b);
  kern<<<grid, tc::DT_THREADS, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int DV>
int launch_decode(const DecodeArgs& a, int b, cudaStream_t stream) {
  const size_t bytes = (size_t)a.rows * (a.ds + a.block_k) * sizeof(float);
  auto kern = decode_kernel<T, DV>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.splits, a.hkv, b);
  kern<<<grid, DEC_THREADS, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace rt

extern "C" int repro_decode_fwd(const void* q, const void* k, const void* v, const void* lengths,
                                void* o, void* m, void* l, int dtype, int b, int hkv, int rows,
                                int s, int ds, int dv, int block_k, int q_len, float scale,
                                void* stream) {
  if (rows < 1 || rows > rt::MAX_ROWS || ds % 8 != 0 || block_k < 1 || q_len < 1) {
    return (int)cudaErrorInvalidValue;
  }
  rt::DecodeArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.lengths = static_cast<const int*>(lengths);
  a.o = static_cast<float*>(o);
  a.m = static_cast<float*>(m);
  a.l = static_cast<float*>(l);
  a.hkv = hkv;
  a.rows = rows;
  a.s = s;
  a.ds = ds;
  a.block_k = block_k;
  a.q_len = q_len;
  a.splits = (s + block_k - 1) / block_k;
  a.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == rt::DTYPE_BF16) {
    if (dv == 128) return rt::launch_decode_mma<128>(a, b, st);
    if (dv == 112) return rt::launch_decode_mma<112>(a, b, st);
    if (dv == 64) return rt::launch_decode_mma<64>(a, b, st);
  } else if (dtype == rt::DTYPE_F32) {
    if (dv == 128) return rt::launch_decode<float, 128>(a, b, st);
    if (dv == 112) return rt::launch_decode<float, 112>(a, b, st);
    if (dv == 64) return rt::launch_decode<float, 64>(a, b, st);
  }
  return (int)cudaErrorInvalidValue;
}
