// The FA-2 backward loops shared by the exact (flash_backward.cu) and the
// DistrAttention (distr_backward.cu) kernels for f32 inputs (bf16 runs on
// the tensor cores: flash_bwd_tc.cuh, distr_bwd_tc.cuh).
//
// Both recompute each score tile from (Q, K) and the forward's per-row LSE,
// and mask P directly: P = mask ? exp(S - LSE) : 0, dS = P * (dO·Vᵀ - D),
// with D = rowsum(dO * O) from the delta kernel.  A row past n_rows loads
// LSE = LSE_PAD (+1e30), so its P is exactly 0; a fully masked row has no
// unmasked entry and gets exactly zero gradient.
//
// dq: one CTA of 128 threads owns DQ_BM = 64 query rows of one (batch, query
//     head) and loops over KV tiles of DQ_BN = 32 keys (causal tile skip),
//     accumulating dQ (dQ̂ for distr) in registers.  Thread (r, c) =
//     (tid / 8, tid % 8) owns rows 4r..4r+3 and keys 4c..4c+3 of a score
//     tile, and output columns 32j + 4c..32j + 4c+3.
// dkv: one CTA owns DKV_BK = 64 keys of one query head and loops over Q
//     tiles of DKV_BQ = 32 rows, starting at the first tile that can see
//     its keys.  Thread (r, c) owns keys 4r..4r+3 and rows 4c..4c+3 of the
//     transposed score tile, and keys 4r..4r+3 × output columns 32j + 4c..
//     dV and the exact dK accumulate in registers.  The distr dK̂ of a tile
//     is scattered through the tile's permutation into an f32 dK tile in
//     shared memory: within one Q block the permutation is a bijection, so
//     the G* members of every fused column land on distinct columns and no
//     two threads touch the same element (no atomics, no inverse gather).
//
// dK and dV come out per query head; the wrapper sums each GQA group.  The
// products are f32 FMA loops on CUDA cores over f32 shared-memory tiles,
// with every operand of a product stored so that a thread reads its four
// rows or four keys as one float4 (transposed tiles, rows padded by four
// floats).  The distr variants re-fuse K̂ = Σ_u K[:, perm[g·G* + u]] per
// (Q block, K tile), as the forward does; it never reaches device memory.
#pragma once

#include "common.cuh"

namespace rt {

constexpr float LSE_PAD = 1e30f;  // LSE of a padded row: exp(s - LSE_PAD) == 0
constexpr int BWD_THREADS = 128;
constexpr int DQ_BM = 64;   // dq: query rows per CTA
constexpr int DQ_BN = 32;   // dq: keys per KV tile
constexpr int DKV_BK = 64;  // dkv: keys per CTA
constexpr int DKV_BQ = 32;  // dkv: query rows per Q tile
constexpr int PAD64 = 64 + 4;  // row stride (floats) of a transposed tile 64 wide
constexpr int PAD32 = 32 + 4;  // row stride (floats) of a transposed tile 32 wide

struct BwdArgs {
  const void* q;       // (BHq, n_rows, ds): Q (flash) or pre-scaled Q̂ (distr)
  const void* k;       // (BHkv, nk, DV)
  const void* v;       // (BHkv, nk, DV)
  const int* perm;     // distr: (BHq, n_perm_blocks, DV) int32
  const void* dout;    // (BHq, n_rows, DV)
  const float* lse;    // (BHq, n_rows)
  const float* delta;  // (BHq, n_rows)
  float* dq;           // (BHq, n_rows, ds)
  float* dk;           // (BHq, nk, DV), per query head
  float* dv;           // (BHq, nk, DV), per query head
  int n_rows;
  int nk;
  int kv_len;          // keys at or past kv_len are masked
  int ds;              // score width: d (flash) or d / G* (distr)
  int q_per_kv;
  int group_size;
  int block_q;         // distr: rows per permutation
  int n_perm_blocks;
  float scale;         // 1 for distr: Q̂ carries the softmax scale
  int causal;
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float at(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

template <int DV, bool DISTR>
__host__ __device__ constexpr size_t dq_smem_floats(int ds) {
  return (size_t)ds * PAD64 + (size_t)DV * PAD64 + (size_t)ds * PAD32 + (size_t)DV * PAD32 +
         (size_t)DQ_BN * ds + (size_t)DQ_BN * PAD64 + (DISTR ? (size_t)DQ_BN * DV + DV : 0);
}

template <int DV, bool DISTR>
__global__ void __launch_bounds__(BWD_THREADS) attn_bwd_dq_kernel(BwdArgs a) {
  extern __shared__ __align__(16) float smem[];
  constexpr int DSMAX = DISTR ? DV / 2 : DV;  // distr: G* >= 2 (the wrapper checks)
  constexpr int OJ = (DSMAX + 31) / 32;  // float4 output chunks per thread and row
  const int ds = a.ds;
  float* sQt = smem;                     // [ds][PAD64]
  float* sdOt = sQt + ds * PAD64;        // [DV][PAD64]
  float* sKt = sdOt + DV * PAD64;        // [ds][PAD32]  K or K̂, transposed
  float* sVt = sKt + ds * PAD32;         // [DV][PAD32]
  float* sK = sVt + DV * PAD32;          // [DQ_BN][ds]  K or K̂, row-major
  float* sdSt = sK + DQ_BN * ds;         // [DQ_BN][PAD64]
  float* sKraw = sdSt + DQ_BN * PAD64;   // [DQ_BN][DV]  distr only
  int* sPerm = reinterpret_cast<int*>(sKraw + DQ_BN * DV);  // [DV] distr only

  const int tid = threadIdx.x;
  const int r = tid >> 3;
  const int c = tid & 7;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * DQ_BM;
  const int bkv = bh / a.q_per_kv;
  const float* q = static_cast<const float*>(a.q) + (size_t)bh * a.n_rows * ds;
  const float* dout = static_cast<const float*>(a.dout) + (size_t)bh * a.n_rows * DV;
  const float* k = static_cast<const float*>(a.k) + (size_t)bkv * a.nk * DV;
  const float* v = static_cast<const float*>(a.v) + (size_t)bkv * a.nk * DV;

  for (int idx = tid; idx < DQ_BM * ds; idx += BWD_THREADS) {
    const int row = idx / ds;
    const int col = idx - row * ds;
    sQt[col * PAD64 + row] = q0 + row < a.n_rows ? q[(size_t)(q0 + row) * ds + col] : 0.f;
  }
  for (int idx = tid; idx < DQ_BM * DV; idx += BWD_THREADS) {
    const int row = idx / DV;
    const int col = idx - row * DV;
    sdOt[col * PAD64 + row] =
        q0 + row < a.n_rows ? dout[(size_t)(q0 + row) * DV + col] : 0.f;
  }
  if (DISTR) {
    // DQ_BM divides block_q (checked by the wrapper): one permutation per CTA.
    const int* perm = a.perm + ((size_t)bh * a.n_perm_blocks + q0 / a.block_q) * DV;
    for (int i = tid; i < DV; i += BWD_THREADS) sPerm[i] = perm[i];
  }
  float lse_r[4], delta_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + r * 4 + i;
    const bool live = row < a.n_rows;
    lse_r[i] = live ? a.lse[(size_t)bh * a.n_rows + row] : LSE_PAD;
    delta_r[i] = live ? a.delta[(size_t)bh * a.n_rows + row] : 0.f;
  }

  int n_tiles = (a.kv_len + DQ_BN - 1) / DQ_BN;
  if (a.causal) {
    const int last_row = min(q0 + DQ_BM, a.n_rows) - 1;
    n_tiles = min(n_tiles, last_row / DQ_BN + 1);  // skip tiles above the diagonal
  }

  float acc[4][OJ * 4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < OJ * 4; ++j) acc[i][j] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int kv0 = t * DQ_BN;
    __syncthreads();  // the previous tile's readers are done with sK* / sVt / sdSt
    // Keys at or past kv_len load as zeros; their P is masked to 0.
    if (DISTR) {
      for (int idx = tid; idx < DQ_BN * DV; idx += BWD_THREADS) {
        const int key = idx / DV;
        const int col = idx - key * DV;
        sKraw[idx] = kv0 + key < a.kv_len ? k[(size_t)(kv0 + key) * DV + col] : 0.f;
      }
    } else {
      for (int idx = tid; idx < DQ_BN * ds; idx += BWD_THREADS) {
        const int key = idx / ds;
        const int col = idx - key * ds;
        const float val = kv0 + key < a.kv_len ? k[(size_t)(kv0 + key) * ds + col] : 0.f;
        sKt[col * PAD32 + key] = val;
        sK[key * ds + col] = val;
      }
    }
    for (int idx = tid; idx < DQ_BN * DV; idx += BWD_THREADS) {
      const int key = idx / DV;
      const int col = idx - key * DV;
      sVt[col * PAD32 + key] = kv0 + key < a.kv_len ? v[(size_t)(kv0 + key) * DV + col] : 0.f;
    }
    __syncthreads();
    if (DISTR) {
      const int g = a.group_size;
      for (int idx = tid; idx < DQ_BN * ds; idx += BWD_THREADS) {
        const int key = idx / ds;
        const int col = idx - key * ds;
        const float* row = sKraw + key * DV;
        const int* pg = sPerm + col * g;
        float sum = 0.f;
        for (int u = 0; u < g; ++u) sum += row[pg[u]];
        sKt[col * PAD32 + key] = sum;
        sK[key * ds + col] = sum;
      }
      __syncthreads();
    }

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < ds; ++kk) {
      const float4 qa = ld4(sQt + kk * PAD64 + r * 4);
      const float4 kb = ld4(sKt + kk * PAD32 + c * 4);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(at(qa, i), at(kb, j), s[i][j]);
    }
#pragma unroll 4
    for (int cc = 0; cc < DV; ++cc) {
      const float4 da = ld4(sdOt + cc * PAD64 + r * 4);
      const float4 vb = ld4(sVt + cc * PAD32 + c * 4);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) dp[i][j] = fmaf(at(da, i), at(vb, j), dp[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + r * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = kv0 + c * 4 + j;
        const bool ok = col < a.kv_len && (!a.causal || col <= row);
        const float p = ok ? expf(s[i][j] * a.scale - lse_r[i]) : 0.f;
        s[i][j] = p * (dp[i][j] - delta_r[i]);  // dS
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      *reinterpret_cast<float4*>(sdSt + (c * 4 + j) * PAD64 + r * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    }
    __syncthreads();

#pragma unroll 4
    for (int key = 0; key < DQ_BN; ++key) {
      const float4 dsv = ld4(sdSt + key * PAD64 + r * 4);
#pragma unroll
      for (int jj = 0; jj < OJ; ++jj) {
        const int col0 = jj * 32 + c * 4;
        if (col0 < ds) {
          const float4 kb = ld4(sK + key * ds + col0);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i][jj * 4 + 0] = fmaf(at(dsv, i), kb.x, acc[i][jj * 4 + 0]);
            acc[i][jj * 4 + 1] = fmaf(at(dsv, i), kb.y, acc[i][jj * 4 + 1]);
            acc[i][jj * 4 + 2] = fmaf(at(dsv, i), kb.z, acc[i][jj * 4 + 2]);
            acc[i][jj * 4 + 3] = fmaf(at(dsv, i), kb.w, acc[i][jj * 4 + 3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + r * 4 + i;
    if (row >= a.n_rows) continue;
    float* out = a.dq + ((size_t)bh * a.n_rows + row) * ds;
#pragma unroll
    for (int jj = 0; jj < OJ; ++jj) {
      const int col0 = jj * 32 + c * 4;
      if (col0 < ds) {
        *reinterpret_cast<float4*>(out + col0) =
            make_float4(acc[i][jj * 4] * a.scale, acc[i][jj * 4 + 1] * a.scale,
                        acc[i][jj * 4 + 2] * a.scale, acc[i][jj * 4 + 3] * a.scale);
      }
    }
  }
}

template <int DV, bool DISTR>
__host__ __device__ constexpr size_t dkv_smem_floats(int ds) {
  return (size_t)ds * PAD64 + (size_t)DV * PAD64 + (size_t)ds * PAD32 + (size_t)DKV_BQ * ds +
         (size_t)DV * PAD32 + (size_t)DKV_BQ * DV + 2 * (size_t)DKV_BQ * PAD64 + 2 * DKV_BQ +
         (DISTR ? (size_t)DKV_BK * DV + DV : 0);
}

template <int DV, bool DISTR>
__global__ void __launch_bounds__(BWD_THREADS) attn_bwd_dkv_kernel(BwdArgs a) {
  extern __shared__ __align__(16) float smem[];
  constexpr int DSMAX = DISTR ? DV / 2 : DV;  // distr: G* >= 2 (the wrapper checks)
  constexpr int OJS = (DSMAX + 31) / 32;  // float4 chunks of a dK (dK̂) row per thread
  constexpr int OJV = (DV + 31) / 32;     // float4 chunks of a dV row per thread
  const int ds = a.ds;
  float* sKt = smem;                      // [ds][PAD64]  K or K̂, transposed
  float* sVt = sKt + ds * PAD64;          // [DV][PAD64]
  float* sQt = sVt + DV * PAD64;          // [ds][PAD32]
  float* sQ = sQt + ds * PAD32;           // [DKV_BQ][ds]
  float* sdOt = sQ + DKV_BQ * ds;         // [DV][PAD32]
  float* sdO = sdOt + DV * PAD32;         // [DKV_BQ][DV]
  float* sP = sdO + DKV_BQ * DV;          // [DKV_BQ][PAD64]  P, row-major over keys
  float* sdS = sP + DKV_BQ * PAD64;       // [DKV_BQ][PAD64]
  float* sLse = sdS + DKV_BQ * PAD64;     // [DKV_BQ]
  float* sDelta = sLse + DKV_BQ;          // [DKV_BQ]
  float* sdK = sDelta + DKV_BQ;           // [DKV_BK][DV]  distr only
  int* sPerm = reinterpret_cast<int*>(sdK + DKV_BK * DV);  // [DV] distr only

  const int tid = threadIdx.x;
  const int r = tid >> 3;
  const int c = tid & 7;
  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * DKV_BK;
  const int bkv = bh / a.q_per_kv;
  const float* q = static_cast<const float*>(a.q) + (size_t)bh * a.n_rows * ds;
  const float* dout = static_cast<const float*>(a.dout) + (size_t)bh * a.n_rows * DV;
  const float* k = static_cast<const float*>(a.k) + (size_t)bkv * a.nk * DV;
  const float* v = static_cast<const float*>(a.v) + (size_t)bkv * a.nk * DV;

  for (int idx = tid; idx < DKV_BK * DV; idx += BWD_THREADS) {
    const int key = idx / DV;
    const int col = idx - key * DV;
    const bool live = k0 + key < a.kv_len;
    sVt[col * PAD64 + key] = live ? v[(size_t)(k0 + key) * DV + col] : 0.f;
    if (!DISTR) sKt[col * PAD64 + key] = live ? k[(size_t)(k0 + key) * DV + col] : 0.f;
    if (DISTR) sdK[idx] = 0.f;
  }

  float accv[4][OJV * 4], acck[4][OJS * 4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < OJV * 4; ++j) accv[i][j] = 0.f;
#pragma unroll
    for (int j = 0; j < OJS * 4; ++j) acck[i][j] = 0.f;
  }

  const int t_end = k0 < a.kv_len ? (a.n_rows + DKV_BQ - 1) / DKV_BQ : 0;  // all keys masked: 0
  const int t_start = a.causal ? k0 / DKV_BQ : 0;  // earlier rows see none of these keys
  int cur_pb = -1;
  for (int t = t_start; t < t_end; ++t) {
    const int row0 = t * DKV_BQ;
    __syncthreads();  // the previous tile's readers are done
    if (DISTR) {
      const int pb = row0 / a.block_q;  // DKV_BQ divides block_q
      if (pb != cur_pb) {
        cur_pb = pb;
        const int* perm = a.perm + ((size_t)bh * a.n_perm_blocks + pb) * DV;
        for (int i = tid; i < DV; i += BWD_THREADS) sPerm[i] = perm[i];
        __syncthreads();
        // Re-fuse K̂ under this Q block's permutation, straight from device
        // memory (the 64 × DV K tile stays in L2 across Q blocks).
        const int g = a.group_size;
        for (int idx = tid; idx < DKV_BK * ds; idx += BWD_THREADS) {
          const int key = idx / ds;
          const int col = idx - key * ds;
          float sum = 0.f;
          if (k0 + key < a.kv_len) {
            const float* krow = k + (size_t)(k0 + key) * DV;
            for (int u = 0; u < g; ++u) sum += krow[sPerm[col * g + u]];
          }
          sKt[col * PAD64 + key] = sum;
        }
      }
    }
    for (int idx = tid; idx < DKV_BQ * ds; idx += BWD_THREADS) {
      const int row = idx / ds;
      const int col = idx - row * ds;
      const float val = row0 + row < a.n_rows ? q[(size_t)(row0 + row) * ds + col] : 0.f;
      sQt[col * PAD32 + row] = val;
      sQ[idx] = val;
    }
    for (int idx = tid; idx < DKV_BQ * DV; idx += BWD_THREADS) {
      const int row = idx / DV;
      const int col = idx - row * DV;
      const float val =
          row0 + row < a.n_rows ? dout[(size_t)(row0 + row) * DV + col] : 0.f;
      sdOt[col * PAD32 + row] = val;
      sdO[idx] = val;
    }
    if (tid < DKV_BQ) {
      const int row = row0 + tid;
      const bool live = row < a.n_rows;
      sLse[tid] = live ? a.lse[(size_t)bh * a.n_rows + row] : LSE_PAD;
      sDelta[tid] = live ? a.delta[(size_t)bh * a.n_rows + row] : 0.f;
    }
    __syncthreads();

    // Transposed tile: s[jk][iq] = S[row 4c+iq][key 4r+jk].
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < ds; ++kk) {
      const float4 ka = ld4(sKt + kk * PAD64 + r * 4);
      const float4 qb = ld4(sQt + kk * PAD32 + c * 4);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(at(ka, i), at(qb, j), s[i][j]);
    }
#pragma unroll 4
    for (int cc = 0; cc < DV; ++cc) {
      const float4 va = ld4(sVt + cc * PAD64 + r * 4);
      const float4 db = ld4(sdOt + cc * PAD32 + c * 4);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) dp[i][j] = fmaf(at(va, i), at(db, j), dp[i][j]);
    }
#pragma unroll
    for (int jk = 0; jk < 4; ++jk) {
      const int key = k0 + r * 4 + jk;
#pragma unroll
      for (int iq = 0; iq < 4; ++iq) {
        const int row = row0 + c * 4 + iq;
        const bool ok = key < a.kv_len && (!a.causal || key <= row);
        const float p = ok ? expf(s[jk][iq] * a.scale - sLse[c * 4 + iq]) : 0.f;
        s[jk][iq] = p;
        dp[jk][iq] = p * (dp[jk][iq] - sDelta[c * 4 + iq]);  // dS
      }
    }
#pragma unroll
    for (int iq = 0; iq < 4; ++iq) {
      *reinterpret_cast<float4*>(sP + (c * 4 + iq) * PAD64 + r * 4) =
          make_float4(s[0][iq], s[1][iq], s[2][iq], s[3][iq]);
      *reinterpret_cast<float4*>(sdS + (c * 4 + iq) * PAD64 + r * 4) =
          make_float4(dp[0][iq], dp[1][iq], dp[2][iq], dp[3][iq]);
    }
    __syncthreads();

    if (DISTR) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < OJS * 4; ++j) acck[i][j] = 0.f;
    }
#pragma unroll 2
    for (int i = 0; i < DKV_BQ; ++i) {
      const float4 pv = ld4(sP + i * PAD64 + r * 4);
      const float4 dsv = ld4(sdS + i * PAD64 + r * 4);
#pragma unroll
      for (int jj = 0; jj < OJV; ++jj) {
        if constexpr (DV % 32 != 0) {  // d = 112: the last chunk is half of the threads'
          if (jj * 32 + c * 4 >= DV) continue;
        }
        const float4 ob = ld4(sdO + i * DV + jj * 32 + c * 4);
#pragma unroll
        for (int jk = 0; jk < 4; ++jk) {
          accv[jk][jj * 4 + 0] = fmaf(at(pv, jk), ob.x, accv[jk][jj * 4 + 0]);
          accv[jk][jj * 4 + 1] = fmaf(at(pv, jk), ob.y, accv[jk][jj * 4 + 1]);
          accv[jk][jj * 4 + 2] = fmaf(at(pv, jk), ob.z, accv[jk][jj * 4 + 2]);
          accv[jk][jj * 4 + 3] = fmaf(at(pv, jk), ob.w, accv[jk][jj * 4 + 3]);
        }
      }
#pragma unroll
      for (int jj = 0; jj < OJS; ++jj) {
        const int col0 = jj * 32 + c * 4;
        if (col0 < ds) {
          const float4 qb = ld4(sQ + i * ds + col0);
#pragma unroll
          for (int jk = 0; jk < 4; ++jk) {
            acck[jk][jj * 4 + 0] = fmaf(at(dsv, jk), qb.x, acck[jk][jj * 4 + 0]);
            acck[jk][jj * 4 + 1] = fmaf(at(dsv, jk), qb.y, acck[jk][jj * 4 + 1]);
            acck[jk][jj * 4 + 2] = fmaf(at(dsv, jk), qb.z, acck[jk][jj * 4 + 2]);
            acck[jk][jj * 4 + 3] = fmaf(at(dsv, jk), qb.w, acck[jk][jj * 4 + 3]);
          }
        }
      }
    }
    if (DISTR) {
      // dK[key][perm[g·G* + u]] += dK̂[key][g] for every member u: the
      // segment-sum transpose and the un-permutation in one scatter.
      const int g = a.group_size;
#pragma unroll
      for (int jj = 0; jj < OJS; ++jj) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int col = jj * 32 + c * 4 + u;
          if (col < ds) {
            const int* pg = sPerm + col * g;
            for (int m = 0; m < g; ++m) {
              const int dst = pg[m];
#pragma unroll
              for (int jk = 0; jk < 4; ++jk) sdK[(r * 4 + jk) * DV + dst] += acck[jk][jj * 4 + u];
            }
          }
        }
      }
    }
  }

  __syncthreads();
#pragma unroll
  for (int jk = 0; jk < 4; ++jk) {
    const int key = k0 + r * 4 + jk;
    if (key >= a.nk) continue;
    float* dvrow = a.dv + ((size_t)bh * a.nk + key) * DV;
#pragma unroll
    for (int jj = 0; jj < OJV; ++jj) {
      if constexpr (DV % 32 != 0) {
        if (jj * 32 + c * 4 >= DV) continue;
      }
      *reinterpret_cast<float4*>(dvrow + jj * 32 + c * 4) = make_float4(
          accv[jk][jj * 4], accv[jk][jj * 4 + 1], accv[jk][jj * 4 + 2], accv[jk][jj * 4 + 3]);
    }
    if (!DISTR) {
      float* dkrow = a.dk + ((size_t)bh * a.nk + key) * DV;
#pragma unroll
      for (int jj = 0; jj < OJS; ++jj) {
        if constexpr (DV % 32 != 0) {
          if (jj * 32 + c * 4 >= DV) continue;
        }
        *reinterpret_cast<float4*>(dkrow + jj * 32 + c * 4) =
            make_float4(acck[jk][jj * 4] * a.scale, acck[jk][jj * 4 + 1] * a.scale,
                        acck[jk][jj * 4 + 2] * a.scale, acck[jk][jj * 4 + 3] * a.scale);
      }
    }
  }
  if (DISTR) {
    for (int idx = tid; idx < DKV_BK * DV; idx += BWD_THREADS) {
      const int key = idx / DV;
      if (k0 + key < a.nk) a.dk[((size_t)bh * a.nk + k0) * DV + idx] = sdK[idx];
    }
  }
}

template <int DV, bool DISTR, bool DKV>
int launch_attn_bwd(const BwdArgs& a, int bhq, cudaStream_t stream) {
  size_t bytes;
  void (*kern)(BwdArgs);
  if constexpr (DKV) {
    bytes = dkv_smem_floats<DV, DISTR>(a.ds) * sizeof(float);
    kern = attn_bwd_dkv_kernel<DV, DISTR>;
  } else {
    bytes = dq_smem_floats<DV, DISTR>(a.ds) * sizeof(float);
    kern = attn_bwd_dq_kernel<DV, DISTR>;
  }
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = DKV ? (a.nk + DKV_BK - 1) / DKV_BK : (a.n_rows + DQ_BM - 1) / DQ_BM;
  const dim3 grid(n_tiles, bhq);
  kern<<<grid, BWD_THREADS, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

inline BwdArgs bwd_args(const void* q, const void* k, const void* v, const void* perm,
                        const void* dout, const void* lse, const void* delta, void* dq, void* dk,
                        void* dv, int n_rows, int nk, int kv_len, int ds, int q_per_kv,
                        int group_size, int block_q, int n_perm_blocks, float scale, int causal) {
  BwdArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.perm = static_cast<const int*>(perm);
  a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.dq = static_cast<float*>(dq);
  a.dk = static_cast<float*>(dk);
  a.dv = static_cast<float*>(dv);
  a.n_rows = n_rows;
  a.nk = nk;
  a.kv_len = kv_len;
  a.ds = ds;
  a.q_per_kv = q_per_kv;
  a.group_size = group_size;
  a.block_q = block_q;
  a.n_perm_blocks = n_perm_blocks;
  a.scale = scale;
  a.causal = causal;
  return a;
}

}  // namespace rt
