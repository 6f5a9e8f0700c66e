// DistrAttention backward on Hopper's tensor cores, bf16 in, f32 out
// (sm_90a): dQ̂ in the sampled space, and dK / dV per query head.
//
// Replaces: src/repro/kernels/backward.py::_distr_dq_kernel and
// ::_distr_dkv_kernel for bf16 inputs (distr_backward.cu routes f32 to the
// FMA tile, attention_bwd_tile.cuh).
//
// Q̂ arrives sampled and pre-scaled (width ds = d/G*), with one permutation
// per block_q rows.  Let Q̃ be Q̂ expanded to full width through its block's
// permutation, Q̃[:, perm[g·G* + u]] = Q̂[:, g] for u < G*.  The permutation
// is a bijection, so
//   S   = Q̂·K̂ᵀ = Q̃·Kᵀ,
//   dQ̂[:, g] = (dS·K̂)[:, g] = Σ_u (dS·K)[:, perm[g·G* + u]],
//   dK  = dSᵀ·Q̃ (the reference's replicate-then-inv_perm gather of dK̂),
// and dP, dV are the flash ones.  So distr_expand_q_kernel writes Q̃ (bf16,
// BHq × N × d) into scratch the wrapper allocates, and the two kernels are
// the flash backward's walks (flash_bwd_tc.cuh) over Q̃ at scale 1 (Q̂
// carries the scale): dkv exactly, dq with a store that sums each fused
// group's G* columns of dQ̃.  Q̃ holds bf16 values exactly, so the
// accuracy argument of the flash walks carries over: S and dP from bf16
// inputs only, P and dS split into bf16 hi + lo as A operands.
//
// The key tile is a template argument (KEYS: dq's K/V tile, dkv's CTA),
// 64 (the static tile) or 128 where it builds without a spill
// (distr_dq_r64.cu, distr_dkv.cu list them).  The rows stay fixed: dq's
// CTA holds 64 rows of one permutation block (64 | block_q, which the
// tuner never varies in the backward: it is the LSH grouping), dkv's Q
// tile dkv_rows<D>().
//
// Bound on this card: operations.  The function's work has the score-side
// products (S, and dQ̂ or dK̂) at width d/G*; this design runs them at d,
// so it sits further from that bound than the flash walks from theirs.
// The expansion is one pass of 2·B·Hq·N·(ds + d) bytes, once per wrapper
// call (each of dq and dkv expands its own).
#pragma once

#include "flash_bwd_tc.cuh"

namespace rt {
namespace tc {

using bf16 = __nv_bfloat16;

constexpr int EXPAND_ROWS = 64;  // rows of Q̂ a CTA expands (64 | block_q)

// Q̃ of EXPAND_ROWS rows of one (batch, query head), inside one permutation
// block.  Q̂'s rows (one contiguous span of 128·ds bytes) and each column's
// source are staged in shared memory; each thread then writes Q̃ in 16-byte
// chunks.  n_rows is a multiple of 64 (the wrapper checks 64 | block_q).
template <int D>
__global__ void __launch_bounds__(BWD_THREADS) distr_expand_q_kernel(BwdArgs a, bf16* q_t) {
  __shared__ int src_col[D];                                  // Q̂ column of each Q̃ column
  __shared__ __align__(16) bf16 sq[EXPAND_ROWS * (D / 2)];    // ds ≤ D/2 (G* ≥ 2)
  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * EXPAND_ROWS;
  const int ds = a.ds;
  const int* perm = a.perm + ((size_t)bh * a.n_perm_blocks + q0 / a.block_q) * D;
  for (int j = tid; j < D; j += BWD_THREADS) src_col[perm[j]] = j / a.group_size;
  const bf16* qh = static_cast<const bf16*>(a.q) + ((size_t)bh * a.n_rows + q0) * ds;
  for (int off = tid * 8; off < EXPAND_ROWS * ds; off += BWD_THREADS * 8)
    *reinterpret_cast<uint4*>(sq + off) = *reinterpret_cast<const uint4*>(qh + off);
  __syncthreads();
  bf16* out = q_t + ((size_t)bh * a.n_rows + q0) * D;
  constexpr int CHUNKS = D / 8;
#pragma unroll 4
  for (int i = tid; i < EXPAND_ROWS * CHUNKS; i += BWD_THREADS) {
    const int row = i / CHUNKS;
    const int c0 = (i - row * CHUNKS) * 8;
    const bf16* r = sq + row * ds;
    uint4 w;
    uint32_t* wp = reinterpret_cast<uint32_t*>(&w);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      __nv_bfloat162 pair;
      pair.x = r[src_col[c0 + 2 * u]];
      pair.y = r[src_col[c0 + 2 * u + 1]];
      wp[u] = *reinterpret_cast<const uint32_t*>(&pair);
    }
    *reinterpret_cast<uint4*>(out + row * D + c0) = w;
  }
}

// The distr dq's store: dQ̃ (64 × D f32) staged in shared memory, which the
// walk's last __syncthreads() freed, then dQ̂[row][g] = Σ_u dQ̃[row][perm[g·G*
// + u]] in f32, consecutive threads on consecutive g.  Rows padded by 8
// floats, so each half-warp's float2 stores of four rows fill 32 banks.
template <int D>
struct DistrDqStore {
  static constexpr int LDF = D + 8;
  static_assert(DQ_ROWS * LDF * sizeof(float) + D * sizeof(int) <= dq_smem_bytes<D>(),
                "the staged dQ̃ and the permutation fit the walk's shared memory");
  __device__ __forceinline__ void store(const BwdArgs& a, const float (&acc)[D / 8][4], int bh,
                                        int q0, int r_lo) const {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    float* sdq = reinterpret_cast<float*>(smem_raw);           // [DQ_ROWS][LDF]
    int* sperm = reinterpret_cast<int*>(sdq + DQ_ROWS * LDF);  // [D]
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int* perm = a.perm + ((size_t)bh * a.n_perm_blocks + q0 / a.block_q) * D;
    for (int i = tid; i < D; i += BWD_THREADS) sperm[i] = perm[i];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float* row = sdq + (r_lo - q0 + h * 8) * LDF + (lane & 3) * 2;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<float2*>(row + j * 8) = make_float2(acc[j][2 * h], acc[j][2 * h + 1]);
    }
    __syncthreads();
    // Thread t sums column t % ds of rows t / ds + k · (128 / ds), so
    // consecutive threads write consecutive floats.  At d ∈ {64, 128}, ds =
    // d/G* is a power of 2 that divides the 128 threads; at d = 112 it need
    // not (56 at G* = 2), and the threads past the last whole multiple of ds
    // sit out.
    const int ds = a.ds;
    const int g = a.group_size;
    int col;
    if constexpr ((D & (D - 1)) == 0) {
      col = tid & (ds - 1);
    } else {
      if (tid >= BWD_THREADS / ds * ds) return;
      col = tid % ds;
    }
    const int* pg = sperm + col * g;
    float* out = a.dq + ((size_t)bh * a.n_rows + q0) * ds + col;
    const int rows = min(DQ_ROWS, a.n_rows - q0);
    for (int row = tid / ds; row < rows; row += BWD_THREADS / ds) {
      const float* src = sdq + row * LDF;
      float sum = 0.f;
      for (int u = 0; u < g; ++u) sum += src[pg[u]];
      out[row * ds] = sum;
    }
  }
};

template <int D, int KEYS>
__global__ void __launch_bounds__(BWD_THREADS) distr_bwd_dq_mma_kernel(BwdArgs a) {
  bwd_dq_mma_walk<D, DQ_ROWS, KEYS>(a, DistrDqStore<D>{});
}

template <int D, int KEYS>
__global__ void __launch_bounds__(KEYS / 16 * 32) distr_bwd_dkv_mma_kernel(BwdArgs a) {
  bwd_dkv_mma_walk<D, dkv_rows<D>(), KEYS>(a);
}

// Launch a walk kernel of the tile <D, KEYS> over Q̃ in a.q.
template <int D, int KEYS, bool DKV>
int launch_distr_walk(const BwdArgs& a, int bhq, cudaStream_t stream) {
  if constexpr (DKV) {
    return launch_bwd_walk<D, dkv_rows<D>(), KEYS, true>(distr_bwd_dkv_mma_kernel<D, KEYS>, a,
                                                         bhq, stream);
  } else {
    return launch_bwd_walk<D, DQ_ROWS, KEYS, false>(distr_bwd_dq_mma_kernel<D, KEYS>, a, bhq,
                                                    stream);
  }
}

// The walks' instantiations, one source each (distr_dq_r64.cu,
// distr_dkv.cu), so that the build compiles them in parallel: launch the
// (d, keys) tile over Q̃ in a.q, or return cudaErrorInvalidValue for a tile
// that was not compiled.
int distr_dq_r64(const BwdArgs& a, int d, int keys, int bhq, cudaStream_t stream);
int distr_dkv(const BwdArgs& a, int d, int keys, int bhq, cudaStream_t stream);

template <int D>
int launch_distr_expand(const BwdArgs& a, bf16* q_t, int bhq, cudaStream_t stream) {
  if (a.n_rows == 0) return (int)cudaSuccess;
  distr_expand_q_kernel<D><<<dim3(bhq, a.n_rows / EXPAND_ROWS), BWD_THREADS, 0, stream>>>(a, q_t);
  return (int)cudaGetLastError();
}

// Expand Q̂ into q_t, then run the dq (DKV = false) or dkv walk of the
// (rows, keys) tile over it.  a.q is Q̂ on entry; a.scale must be 1.  The
// rows are the walk's fixed ones: any other tile is refused before the
// expansion runs.
template <bool DKV>
int dispatch_distr_bwd_mma(BwdArgs a, void* q_t, int d, int rows, int keys, int bhq,
                           cudaStream_t stream) {
  bf16* qt = static_cast<bf16*>(q_t);
  const int fixed_rows = DKV ? (d > 64 ? dkv_rows<128>() : dkv_rows<64>()) : DQ_ROWS;
  if (rows != fixed_rows) return (int)cudaErrorInvalidValue;
  int err = (int)cudaErrorInvalidValue;
  if (d == 128) err = launch_distr_expand<128>(a, qt, bhq, stream);
  if (d == 112) err = launch_distr_expand<112>(a, qt, bhq, stream);
  if (d == 64) err = launch_distr_expand<64>(a, qt, bhq, stream);
  if (err != (int)cudaSuccess) return err;
  a.q = q_t;
  return DKV ? distr_dkv(a, d, keys, bhq, stream) : distr_dq_r64(a, d, keys, bhq, stream);
}

}  // namespace tc
}  // namespace rt
