// The FA-2 forward loop on CUDA-core FMA: the f32 path of the exact kernel
// (flash_attention.cu) and of the DistrAttention kernel
// (distr_attention.cu).  Their bf16 paths run on the tensor cores
// (flash_fwd_tc.cuh, distr_fwd_tc.cuh); in f32 the tensor cores would
// compute TF32, a different result.
//
// One CTA of 128 threads owns BM = 64 query rows of one (batch, query head)
// and walks the KV sequence in tiles of BN = 32 keys, keeping the online
// softmax state (m, l) and the f32 output accumulator in registers.  Nothing
// carries between CTAs; the KV walk is a loop inside the block.
//
// Thread (r, c) = (tid / 8, tid % 8) owns query rows 4r..4r+3, score
// columns 4c..4c+3 of a tile, and output columns 32j + 4c..32j + 4c+3 for
// every j with 32j + 4c < DV: a width that is not a multiple of 32
// (DV = 112) leaves the last float4 chunk to the first threads of the row
// group.  The eight threads of a row group are eight consecutive lanes, so
// the row max and row sum reduce with three xor-shuffles.
//
// Shared memory, all f32: Q and the score-side K tile are stored transposed
// (feature-major) so that every thread reads its four rows / four keys as
// one float4; P is written transposed for the same reason in the PV loop.
// Rows are padded by four floats.  The distr variant also stages the raw K
// tile and the Q block's permutation, and builds the fused tile
// K̂[j][g] = Σ_u K[j][perm[g·G + u]] in shared memory: K̂ depends on the
// (Q block, K tile) pair and never reaches device memory.
#pragma once

#include "common.cuh"

namespace rt {

constexpr int BM = 64;          // query rows per CTA
constexpr int BN = 32;          // keys per KV tile
constexpr int ATTN_THREADS = 128;
constexpr int QPAD = BM + 4;    // row stride (floats) of the transposed Q / P tiles
constexpr int KPAD = BN + 4;    // row stride (floats) of the transposed K tile

struct AttnArgs {
  const void* q;      // (BHq, n_rows, ds)
  const void* k;      // (BHkv, nk, ds) flash; (BHkv, nk, DV) distr
  const void* v;      // (BHkv, nk, DV)
  const int* perm;    // distr: (BHq, n_perm_blocks, DV) int32
  void* o;            // (BHq, n_rows, DV), q's dtype
  float* lse;         // optional (BHq, n_rows) f32
  int n_rows;
  int nk;
  int kv_len;         // keys at or past kv_len are masked
  int ds;             // score width: d (flash) or d / G* (distr)
  int q_per_kv;
  int group_size;
  int block_q;        // distr: rows per permutation
  int n_perm_blocks;
  float scale;
  int causal;
};

template <int DV, bool DISTR>
__host__ __device__ constexpr size_t attn_smem_floats(int ds) {
  return (size_t)ds * QPAD + (size_t)ds * KPAD + (size_t)BN * DV + (size_t)BN * QPAD +
         (DISTR ? (size_t)BN * DV + DV : 0);
}

template <typename T, int DV, bool DISTR>
__global__ void __launch_bounds__(ATTN_THREADS) attn_fwd_kernel(AttnArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int ds = a.ds;
  const int dk = DISTR ? DV : ds;  // width of the K rows in device memory
  float* sQt = smem;                // [ds][QPAD]
  float* sKt = sQt + ds * QPAD;     // [ds][KPAD]   K (flash) or fused K̂ (distr)
  float* sV = sKt + ds * KPAD;      // [BN][DV]
  float* sPt = sV + BN * DV;        // [BN][QPAD]
  float* sKraw = sPt + BN * QPAD;   // [BN][DV]     distr only
  int* sPerm = reinterpret_cast<int*>(sKraw + BN * DV);  // [DV] distr only

  const int tid = threadIdx.x;
  const int r = tid >> 3;
  const int c = tid & 7;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BM;
  const int bkv = bh / a.q_per_kv;
  const T* q = static_cast<const T*>(a.q) + (size_t)bh * a.n_rows * ds;
  const T* k = static_cast<const T*>(a.k) + (size_t)bkv * a.nk * dk;
  const T* v = static_cast<const T*>(a.v) + (size_t)bkv * a.nk * DV;

  for (int idx = tid; idx < BM * ds; idx += ATTN_THREADS) {
    const int row = idx / ds;
    const int col = idx - row * ds;
    float val = 0.f;
    if (q0 + row < a.n_rows) val = to_float(q[(size_t)(q0 + row) * ds + col]);
    sQt[col * QPAD + row] = val;
  }
  if (DISTR) {
    // BM divides block_q (checked by the wrapper): one permutation per CTA.
    const int* perm = a.perm + ((size_t)bh * a.n_perm_blocks + q0 / a.block_q) * DV;
    for (int i = tid; i < DV; i += ATTN_THREADS) sPerm[i] = perm[i];
  }

  int n_tiles = (a.kv_len + BN - 1) / BN;
  if (a.causal) {
    const int last_row = min(q0 + BM, a.n_rows) - 1;
    n_tiles = min(n_tiles, last_row / BN + 1);  // skip tiles above the diagonal
  }

  static_assert(DV % 4 == 0, "output columns are owned in float4 chunks");
  constexpr int OJ = (DV + 31) / 32;  // float4 output chunks per thread and row, at most
  // Whether this thread owns output chunk jj (always, when 32 divides DV).
  auto owns = [c](int jj) { return DV % 32 == 0 || jj * 32 + c * 4 < DV; };
  float m_i[4], l_i[4], acc[4][OJ * 4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = NEG_INF;
    l_i[i] = 0.f;
#pragma unroll
    for (int j = 0; j < OJ * 4; ++j) acc[i][j] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int kv0 = t * BN;
    __syncthreads();  // the previous tile's readers are done with sK / sV / sP
    // Keys at or past kv_len load as zeros: masked P is 0 and 0 · V stays 0.
    if (DISTR) {
      for (int idx = tid; idx < BN * DV; idx += ATTN_THREADS) {
        const int key = idx / DV;
        const int col = idx - key * DV;
        sKraw[idx] = kv0 + key < a.kv_len ? to_float(k[(size_t)(kv0 + key) * DV + col]) : 0.f;
      }
    } else {
      for (int idx = tid; idx < BN * ds; idx += ATTN_THREADS) {
        const int key = idx / ds;
        const int col = idx - key * ds;
        sKt[col * KPAD + key] =
            kv0 + key < a.kv_len ? to_float(k[(size_t)(kv0 + key) * ds + col]) : 0.f;
      }
    }
    for (int idx = tid; idx < BN * DV; idx += ATTN_THREADS) {
      const int key = idx / DV;
      const int col = idx - key * DV;
      sV[idx] = kv0 + key < a.kv_len ? to_float(v[(size_t)(kv0 + key) * DV + col]) : 0.f;
    }
    __syncthreads();
    if (DISTR) {
      // The paper's fusion: gather K's columns by the permutation, sum runs of G*.
      const int g = a.group_size;
      for (int idx = tid; idx < BN * ds; idx += ATTN_THREADS) {
        const int key = idx / ds;
        const int col = idx - key * ds;
        const float* row = sKraw + key * DV;
        const int* pg = sPerm + col * g;
        float sum = 0.f;
        for (int u = 0; u < g; ++u) sum += row[pg[u]];
        sKt[col * KPAD + key] = sum;
      }
      __syncthreads();
    }

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < ds; ++kk) {
      const float4 qa = *reinterpret_cast<const float4*>(sQt + kk * QPAD + r * 4);
      const float4 kb = *reinterpret_cast<const float4*>(sKt + kk * KPAD + c * 4);
      const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
      const float kv[4] = {kb.x, kb.y, kb.z, kb.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + r * 4 + i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = kv0 + c * 4 + j;
        const bool ok = col < a.kv_len && (!a.causal || col <= row);
        s[i][j] = ok ? s[i][j] * a.scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m_i[i], mx);
      const float alpha = expf(m_i[i] - m_new);
      float ls = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = s[i][j] == NEG_INF ? 0.f : expf(s[i][j] - m_new);
        s[i][j] = p;
        ls += p;
      }
      ls += __shfl_xor_sync(0xffffffffu, ls, 1);
      ls += __shfl_xor_sync(0xffffffffu, ls, 2);
      ls += __shfl_xor_sync(0xffffffffu, ls, 4);
      l_i[i] = l_i[i] * alpha + ls;
      m_i[i] = m_new;
#pragma unroll
      for (int j = 0; j < OJ * 4; ++j) acc[i][j] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      *reinterpret_cast<float4*>(sPt + (c * 4 + j) * QPAD + r * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    }
    __syncthreads();

#pragma unroll 4
    for (int key = 0; key < BN; ++key) {
      const float4 pa = *reinterpret_cast<const float4*>(sPt + key * QPAD + r * 4);
      const float pv[4] = {pa.x, pa.y, pa.z, pa.w};
#pragma unroll
      for (int jj = 0; jj < OJ; ++jj) {
        if (!owns(jj)) continue;
        const float4 vb = *reinterpret_cast<const float4*>(sV + key * DV + jj * 32 + c * 4);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][jj * 4 + 0] = fmaf(pv[i], vb.x, acc[i][jj * 4 + 0]);
          acc[i][jj * 4 + 1] = fmaf(pv[i], vb.y, acc[i][jj * 4 + 1]);
          acc[i][jj * 4 + 2] = fmaf(pv[i], vb.z, acc[i][jj * 4 + 2]);
          acc[i][jj * 4 + 3] = fmaf(pv[i], vb.w, acc[i][jj * 4 + 3]);
        }
      }
    }
  }

  T* o = static_cast<T*>(a.o) + (size_t)bh * a.n_rows * DV;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + r * 4 + i;
    if (row >= a.n_rows) continue;
    // A row that saw no key (l = 0) writes O = 0.
    const float denom = l_i[i] == 0.f ? 1.f : l_i[i];
    T* orow = o + (size_t)row * DV;
#pragma unroll
    for (int jj = 0; jj < OJ; ++jj) {
      if (!owns(jj)) continue;
#pragma unroll
      for (int u = 0; u < 4; ++u) orow[jj * 32 + c * 4 + u] = from_float<T>(acc[i][jj * 4 + u] / denom);
    }
    if (a.lse != nullptr && c == 0) {
      a.lse[(size_t)bh * a.n_rows + row] = l_i[i] == 0.f ? NEG_INF : m_i[i] + logf(denom);
    }
  }
}

template <typename T, int DV, bool DISTR>
int launch_attn_fwd(const AttnArgs& a, int bhq, cudaStream_t stream) {
  const size_t bytes = attn_smem_floats<DV, DISTR>(a.ds) * sizeof(float);
  auto kern = attn_fwd_kernel<T, DV, DISTR>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.n_rows + BM - 1) / BM, bhq);
  kern<<<grid, ATTN_THREADS, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace rt
