// Block-table (paged) split-K flash-decoding for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/paged_decode.py::_paged_decode_kernel (the
// Pallas TPU kernel launched by paged_decode_kernel_call; the cross-split
// merge stays outside, kernels/decode.py::merge_splits).
//
// Grid (logical block j, kv head, request b).  The CTA reads physical block
// block_tables[b, j] straight out of the pool (P, Hkv, bs, ·) — no gather
// copies the request's KV.  Block j is dead when j·bs ≥ length: it reads no
// K/V and writes identity stats (o = 0, m = -1e30, l = 0).  A live block has
// min(bs, length − j·bs) keys; lengths are NOT clamped to the table's
// capacity (a padded chunk window overhangs it), so every offset is bounded
// by the live-key count, never by length alone.  Packed row r holds query
// token r % q_len and sees keys < length − (q_len − 1 − r % q_len); masked
// scores are -1e30 and their P is exactly 0.  The score width d_score may
// differ from the value width (the fused-K̂ pool).  Each split emits
// unnormalised partials o = Σ exp(s − m)·V, m = rowmax s, l = Σ exp(s − m).
//
// Bound on this card: bytes for a decode tick (q_per_kv = 9 rows against
// each live K/V byte, far below the ridge).  bf16, the pools' dtype at full
// size, runs the tensor-core tile decode_tc.cuh, the same tile as the
// contiguous decode kernel: the block's K/V stream through a cp.async ring
// (resident at the serving block of 128) while the packed rows run as
// 16-row m-tiles, keys over warps for a tick, rows over warps for a chunk
// (288 rows at starcoder2-7b).  f32 runs the FMA loops below: the live K
// and V of the block are staged once in shared memory (16-byte loads; K
// rows padded by 16 bytes so the per-key score reads do not collide on
// banks) and every row tile of ≤ 32 packed rows reuses them; thread t owns
// key t for the scores and value column t for P·V, the sums in registers.
// A full tile runs the unrolled row loops unconditionally, a short one
// leaves them after its last row.
#include "decode_tc.cuh"

namespace rt {

constexpr int PD_THREADS = 128;
constexpr int PD_TILE_ROWS = 32;

struct PagedArgs {
  const void* q;            // (B, Hkv, rows, ds)
  const void* k;            // (P, Hkv, bs, ds) pool
  const void* v;            // (P, Hkv, bs, DV) pool
  const int* block_tables;  // (B, max_blocks) physical block ids
  const int* lengths;       // (B,) live tokens, unclamped
  float* o;                 // (B, Hkv, max_blocks, rows, DV)
  float* m;                 // (B, Hkv, max_blocks, rows)
  float* l;                 // (B, Hkv, max_blocks, rows)
  int hkv;
  int rows;
  int ds;
  int bs;
  int max_blocks;
  int q_len;
  float scale;
};

// Row stride of the staged K block, in elements: ds plus 16 bytes.
template <typename T>
__host__ __device__ constexpr int k_stride(int ds) {
  return ds + 16 / (int)sizeof(T);
}

template <typename T, int DV>
size_t paged_smem_bytes(int ds, int bs) {
  return (size_t)bs * (k_stride<T>(ds) + DV) * sizeof(T) +
         (size_t)PD_TILE_ROWS * (ds + bs) * sizeof(float);
}

// Copy n elements (a multiple of 16 bytes) with 16-byte loads; with
// src_row ≠ dst_row the rows (src_row elements wide) land dst_row apart.
template <typename T>
__device__ __forceinline__ void stage(T* dst, const T* src, int n, int src_row, int dst_row) {
  constexpr int VEC = 16 / sizeof(T);
  for (int e = threadIdx.x * VEC; e < n; e += PD_THREADS * VEC) {
    const int row = e / src_row;
    const int col = e - row * src_row;
    *reinterpret_cast<uint4*>(dst + (size_t)row * dst_row + col) =
        *reinterpret_cast<const uint4*>(src + e);
  }
}

// One tile of ≤ 32 packed rows starting at row r0: scores against the staged
// block, softmax stats, P·V.  FULL tiles (nr = 32) run the unrolled row loops
// unconditionally; a short tile (a decode tick's 9 rows, or the last tile)
// leaves each loop after nr rows, so it does nr rows of work, not 32.
template <bool FULL, typename T, int DV>
__device__ __forceinline__ void row_tile(const PagedArgs& a, const T* sK, const T* sV,
                                         const float* sQ, float* sS, int ks, int r0, int nr,
                                         int n_live, int kv0, int length, size_t stat,
                                         float* o) {
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  for (int key = tid; key < a.bs; key += PD_THREADS) {
    float acc[PD_TILE_ROWS];
#pragma unroll
    for (int r = 0; r < PD_TILE_ROWS; ++r) acc[r] = 0.f;
    if (key < n_live) {
      const T* krow = sK + (size_t)key * ks;
      for (int kk = 0; kk < a.ds; kk += 8) {
        float kv[8];
        load8(krow + kk, kv);
#pragma unroll
        for (int r = 0; r < PD_TILE_ROWS; ++r) {
          if (!FULL && r >= nr) break;  // a short tile skips the rows it lacks
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
    const int col = kv0 + key;
#pragma unroll
    for (int r = 0; r < PD_TILE_ROWS; ++r) {
      if (!FULL && r >= nr) break;
      const int row_len = length - (a.q_len - 1 - (r0 + r) % a.q_len);
      sS[r * a.bs + key] = (key < n_live && col < row_len) ? acc[r] * a.scale : NEG_INF;
    }
  }
  __syncthreads();

  for (int r = warp; r < nr; r += PD_THREADS / 32) {
    float* srow = sS + r * a.bs;
    float mx = NEG_INF;
    for (int c = lane; c < a.bs; c += 32) mx = fmaxf(mx, srow[c]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int c = lane; c < a.bs; c += 32) {
      const float sv = srow[c];
      const float p = sv == NEG_INF ? 0.f : expf(sv - mx);
      srow[c] = p;
      sum += p;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      a.m[stat + r0 + r] = mx;
      a.l[stat + r0 + r] = sum;
    }
  }
  __syncthreads();

  for (int c = tid; c < DV; c += PD_THREADS) {
    float acc[PD_TILE_ROWS];
#pragma unroll
    for (int r = 0; r < PD_TILE_ROWS; ++r) acc[r] = 0.f;
    for (int key = 0; key < n_live; ++key) {
      const float vv = to_float(sV[(size_t)key * DV + c]);
#pragma unroll
      for (int r = 0; r < PD_TILE_ROWS; ++r) {
        if (!FULL && r >= nr) break;
        acc[r] = fmaf(sS[r * a.bs + key], vv, acc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < PD_TILE_ROWS; ++r) {
      if (!FULL && r >= nr) break;
      o[(size_t)(r0 + r) * DV + c] = acc[r];
    }
  }
}

template <typename T, int DV>
__global__ void __launch_bounds__(PD_THREADS) paged_decode_kernel(PagedArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ks = k_stride<T>(a.ds);
  T* sK = reinterpret_cast<T*>(smem_raw);                     // [bs][ks]
  T* sV = sK + (size_t)a.bs * ks;                              // [bs][DV]
  float* sQ = reinterpret_cast<float*>(sV + (size_t)a.bs * DV);  // [tile][ds]
  float* sS = sQ + PD_TILE_ROWS * a.ds;                        // [tile][bs]

  const int j = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int length = a.lengths[b];
  const int kv0 = j * a.bs;
  const size_t bh = (size_t)b * a.hkv + h;
  const size_t stat = (bh * a.max_blocks + j) * a.rows;
  float* o = a.o + stat * DV;

  if (kv0 >= length) {  // dead logical block
    for (int i = tid; i < a.rows * DV; i += PD_THREADS) o[i] = 0.f;
    for (int i = tid; i < a.rows; i += PD_THREADS) {
      a.m[stat + i] = NEG_INF;
      a.l[stat + i] = 0.f;
    }
    return;
  }
  const int n_live = min(a.bs, length - kv0);
  const size_t phys = (size_t)a.block_tables[(size_t)b * a.max_blocks + j];
  const size_t blk = phys * a.hkv + h;
  stage(sK, static_cast<const T*>(a.k) + blk * a.bs * a.ds, n_live * a.ds, a.ds, ks);
  stage(sV, static_cast<const T*>(a.v) + blk * a.bs * DV, n_live * DV, DV, DV);
  const T* q = static_cast<const T*>(a.q) + bh * a.rows * a.ds;

  for (int r0 = 0; r0 < a.rows; r0 += PD_TILE_ROWS) {
    const int nr = min(PD_TILE_ROWS, a.rows - r0);
    __syncthreads();  // staging done / the previous tile's P·V done
    for (int i = tid; i < nr * a.ds; i += PD_THREADS) sQ[i] = to_float(q[(size_t)r0 * a.ds + i]);
    __syncthreads();

    if (nr == PD_TILE_ROWS) {
      row_tile<true, T, DV>(a, sK, sV, sQ, sS, ks, r0, nr, n_live, kv0, length, stat, o);
    } else {
      row_tile<false, T, DV>(a, sK, sV, sQ, sS, ks, r0, nr, n_live, kv0, length, stat, o);
    }
  }
}

// The bf16 kernel: block block_tables[b, j] of the pools handed to the
// tensor-core tile.
template <int DV, int KW>
__global__ void __launch_bounds__(tc::DT_THREADS) paged_mma_kernel(PagedArgs a) {
  using bf16 = __nv_bfloat16;
  const int j = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int length = a.lengths[b];
  const int kv0 = j * a.bs;
  const size_t bh = (size_t)b * a.hkv + h;
  const size_t stat = (bh * a.max_blocks + j) * a.rows;
  tc::DecodeTile t;
  t.o = a.o + stat * DV;
  t.m = a.m + stat;
  t.l = a.l + stat;
  if (kv0 >= length) {  // dead logical block
    tc::write_identity<DV>(t.o, t.m, t.l, a.rows);
    return;
  }
  const size_t phys = (size_t)a.block_tables[(size_t)b * a.max_blocks + j];
  const size_t blk = phys * a.hkv + h;
  t.q = static_cast<const bf16*>(a.q) + bh * a.rows * a.ds;
  t.k = static_cast<const bf16*>(a.k) + blk * a.bs * a.ds;
  t.v = static_cast<const bf16*>(a.v) + blk * a.bs * DV;
  t.rows = a.rows;
  t.ds = a.ds;
  t.q_len = a.q_len;
  t.n_live = min(a.bs, length - kv0);
  t.len0 = length - kv0 - (a.q_len - 1);
  t.scale = a.scale;
  tc::decode_tile<DV, KW>(t);
}

template <int DV>
int launch_paged_mma(const PagedArgs& a, int b, cudaStream_t stream) {
  const int kw = tc::decode_kw(a.rows);
  const size_t bytes = tc::decode_smem_bytes(a.ds, DV, kw);
  auto kern = kw == 4   ? paged_mma_kernel<DV, 4>
              : kw == 2 ? paged_mma_kernel<DV, 2>
                        : paged_mma_kernel<DV, 1>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.max_blocks, a.hkv, b);
  kern<<<grid, tc::DT_THREADS, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int DV>
int launch_paged(const PagedArgs& a, int b, cudaStream_t stream) {
  const size_t bytes = paged_smem_bytes<T, DV>(a.ds, a.bs);
  auto kern = paged_decode_kernel<T, DV>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.max_blocks, a.hkv, b);
  kern<<<grid, PD_THREADS, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace rt

extern "C" int repro_paged_decode_fwd(const void* q, const void* k, const void* v,
                                      const void* block_tables, const void* lengths, void* o,
                                      void* m, void* l, int dtype, int b, int hkv, int rows,
                                      int ds, int dv, int bs, int max_blocks, int q_len,
                                      float scale, void* stream) {
  if (rows < 1 || ds % 8 != 0 || bs < 1 || max_blocks < 1 || q_len < 1) {
    return (int)cudaErrorInvalidValue;
  }
  rt::PagedArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.block_tables = static_cast<const int*>(block_tables);
  a.lengths = static_cast<const int*>(lengths);
  a.o = static_cast<float*>(o);
  a.m = static_cast<float*>(m);
  a.l = static_cast<float*>(l);
  a.hkv = hkv;
  a.rows = rows;
  a.ds = ds;
  a.bs = bs;
  a.max_blocks = max_blocks;
  a.q_len = q_len;
  a.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == rt::DTYPE_BF16) {
    if (dv == 128) return rt::launch_paged_mma<128>(a, b, st);
    if (dv == 112) return rt::launch_paged_mma<112>(a, b, st);
    if (dv == 64) return rt::launch_paged_mma<64>(a, b, st);
  } else if (dtype == rt::DTYPE_F32) {
    if (dv == 128) return rt::launch_paged<float, 128>(a, b, st);
    if (dv == 112) return rt::launch_paged<float, 112>(a, b, st);
    if (dv == 64) return rt::launch_paged<float, 64>(a, b, st);
  }
  return (int)cudaErrorInvalidValue;
}
