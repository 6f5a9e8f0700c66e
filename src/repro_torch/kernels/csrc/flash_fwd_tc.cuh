// Exact FA-2 forward on Hopper's tensor cores, bf16 in and out (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention.py::_flash_kernel for bf16
// inputs (flash_attention.cu routes f32 to the FMA tile, attention_tile.cuh).
//
// Bound on this card: operations.  Causal N = 2048, d = 128, 36 heads is
// 38.7 GFLOP against 38 MB, 0.0391 ms at 989 TFLOP/s.  The design is FA-2's
// (Dao 2023, §3) on mma.sync rather than wgmma: both products run as
// mma.sync.m16n8k16 bf16 → f32 with operands from ldmatrix, P never leaves
// registers, and the K/V tiles stream through a two-stage cp.async ring so
// that the next tile's loads overlap this tile's products.  What it leaves
// to later work: wgmma (the only path to the full tensor-core rate), TMA and
// warp-specialised producers.
//
// The walk (fwd_mma_walk) is shared with the bf16 DistrAttention forward
// (distr_fwd_tc.cuh): a policy class fills its Q tile, and everything else
// (K/V ring, scores, softmax, P·V, masks, epilogue) is one code.
//
// The tile is a template argument of the walk: a CTA of BM/16 warps owns
// BM query rows of one (batch, query head), 16 rows a warp, and walks the
// keys in tiles of BN.  The static tile, the one REPRO_TUNE=off runs, is
// BM = BN = 64 (4 warps); the tuner (tune/autotune.py) sweeps BM, BN ∈
// {64, 128} where they build without a spill (flash_fwd_r64.cu,
// flash_fwd_r128.cu list them).  A warp keeps its Q fragments (d/16 k-steps
// × 4 registers), its 16 × BN f32 scores and its 16 × d f32 output in
// registers.  In the m16n8k16 layouts, lane l holds
// rows l/4 and l/4 + 8 of a fragment, and columns 2(l%4) and 2(l%4) + 1 of
// each 8-wide n-tile; so a row's values lie in a quad of lanes, and the
// accumulator of two adjacent n-tiles of S is, packed to bf16, the A operand
// of one k-step of P·V.
//
// Shared memory, bf16, rows padded by 8 elements (16 bytes) so that the 8
// row addresses of each ldmatrix phase fall in distinct bank groups: Q
// (BM × (d + 8)), then K and V, each 2 stages of BN × (d + 8).  At d = 128
// and the static tile that is 87,040 bytes and 231 registers a thread: two
// CTAs an SM.  The grid
// is (heads, row blocks) with the last row block first, so under a causal
// mask the CTAs with the most key tiles start first.
//
// Softmax: exponentials are one FFMA (scale · log2 e folded in) and one
// ex2.approx a score; the row max is taken on the raw scores.  Keys at or
// past kv_len and, when causal, keys past the row take NEG_INF, on the
// tiles that cross kv_len or the warp's diagonal only.  A row whose keys so
// far are all masked has m = NEG_INF; its exponentials are taken against 0
// instead, so exp2(NEG_INF · scale · log2 e) gives P = 0 exactly (never a
// product with a mask, which would give inf · 0).  Keys at or past kv_len
// load as zeros (cp.async's zero-fill from a clamped in-bounds address), so
// memory past nk is never read.
#pragma once

#include "attention_tile.cuh"
#include "mma_sync.cuh"

namespace rt {
namespace tc {

constexpr int BM = 64;  // the static tile: query rows per CTA
constexpr int BN = 64;  // the static tile: keys per KV tile
constexpr int THREADS = warp_threads<BM>();

using bf16 = __nv_bfloat16;

// How a walk fills its Q tile (BM_ × (D + 8)).  A policy QK gives load_q(),
// which issues the tile's loads beside the first K/V tile's and may use
// ring stage 1 of K (idle until the walk starts) as scratch, and finish_q(),
// which runs after they landed and the prologue's __syncthreads().  The
// flash forward's: Q through cp.async, nothing to finish.
template <int D, int BM_ = BM>
struct FlashQK {
  __device__ __forceinline__ void load_q(const AttnArgs& a, bf16* sQ, bf16*, int bh, int q0) {
    constexpr int CHUNKS = D / 8;
    constexpr int T = warp_threads<BM_>();
    static_assert(BM_ * CHUNKS % T == 0, "every thread loads the same number of chunks");
    const bf16* q = static_cast<const bf16*>(a.q) + (size_t)bh * a.n_rows * D;
#pragma unroll
    for (int it = 0; it < BM_ * CHUNKS / T; ++it) {
      const int i = threadIdx.x + it * T;
      const int row = i / CHUNKS;
      const int col = (i - row * CHUNKS) * 8;
      const size_t src = (size_t)min(q0 + row, a.n_rows - 1) * D + col;
      cp_async16(smem_addr(sQ + row * (D + 8) + col), q + src, q0 + row < a.n_rows);
    }
  }
  __device__ __forceinline__ void finish_q(const AttnArgs&, bf16*, bf16*) {}
};

// Bytes of dynamic shared memory: Q, then two stages each of K and V.
template <int D, int BM_ = BM, int BN_ = BN>
constexpr size_t smem_bytes() {
  return (size_t)(BM_ + 4 * BN_) * (D + 8) * sizeof(__nv_bfloat16);
}

// One CTA's walk over the keys: its BM_ rows of one (batch, query head)
// against every key tile of BN_ keys they see, at head dim D, its Q tile
// as QK fills it.
template <int D, int BM_, int BN_, class QK>
__device__ __forceinline__ void fwd_mma_walk(const AttnArgs& a, QK& qk) {
  static_assert(D % 16 == 0, "head dim must be a multiple of the mma depth");
  static_assert(BM_ % 16 == 0 && BN_ % 16 == 0, "tiles of whole warps and k-steps");
  constexpr int THREADS = warp_threads<BM_>();
  constexpr int BM = BM_;
  constexpr int BN = BN_;
  constexpr int LD = D + 8;         // shared-memory row stride, elements
  constexpr int CHUNKS = D / 8;     // 16-byte chunks a row
  constexpr int KSTEPS = D / 16;    // k-steps of Q·Kᵀ
  constexpr int NT_S = BN / 8;      // n-tiles of a warp's scores
  constexpr int NT_O = D / 8;       // n-tiles of a warp's output
  constexpr int KV_CHUNKS = BN * CHUNKS;  // a K (or V) tile's 16-byte chunks
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // [BM][LD]
  bf16* sK = sQ + BM * LD;                       // [2][BN][LD]
  bf16* sV = sK + 2 * BN * LD;                   // [2][BN][LD]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  // Heads vary fastest and row blocks run from the last (most causal key
  // tiles) to the first, so the longest CTAs start first and the card's
  // tail is short ones; CTAs of one KV head are neighbours in L2.
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;
  const int bkv = bh / a.q_per_kv;
  const bf16* k = static_cast<const bf16*>(a.k) + (size_t)bkv * a.nk * D;
  const bf16* v = static_cast<const bf16*>(a.v) + (size_t)bkv * a.nk * D;

  int n_tiles = (a.kv_len + BN - 1) / BN;
  if (a.causal) {
    const int last_row = min(q0 + BM, a.n_rows) - 1;
    n_tiles = min(n_tiles, last_row / BN + 1);  // skip tiles above the diagonal
  }

  // Keys at or past kv_len land as zeros, read from a clamped address.  A
  // tile whose chunks are not whole rounds of the threads (d = 112 with 8
  // warps to 64 keys: 3.5 rounds) skips the idle threads of its last one;
  // the guard is compiled only there.
  auto load_kv = [&](int t, int stage) {
    bf16* dk = sK + stage * BN * LD;
    bf16* dv = sV + stage * BN * LD;
#pragma unroll
    for (int it = 0; it < (KV_CHUNKS + THREADS - 1) / THREADS; ++it) {
      const int i = tid + it * THREADS;
      if constexpr (KV_CHUNKS % THREADS != 0) {
        if (i >= KV_CHUNKS) break;
      }
      const int row = i / CHUNKS;
      const int col = (i - row * CHUNKS) * 8;
      const int key = t * BN + row;
      const size_t src = (size_t)min(key, a.kv_len - 1) * D + col;
      cp_async16(smem_addr(dk + row * LD + col), k + src, key < a.kv_len);
      cp_async16(smem_addr(dv + row * LD + col), v + src, key < a.kv_len);
    }
  };

  // Lane l's rows of the warp's fragments: r_lo = row of c0, c1; r_lo + 8 of c2, c3.
  const int r_lo = q0 + warp * 16 + (lane >> 2);
  float m_i[2] = {NEG_INF, NEG_INF};  // running max, log2 units of scale · s
  float l_i[2] = {0.f, 0.f};          // this lane's share of the running sum
  float acc[NT_O][4];
#pragma unroll
  for (int j = 0; j < NT_O; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  if (n_tiles > 0) {
    qk.load_q(a, sQ, sK, bh, q0);
    load_kv(0, 0);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    qk.finish_q(a, sQ, sK);
  }

  // Q's A fragments, held for the whole walk.  ldmatrix.x4 matrices: rows
  // 0-7 / 8-15 of the warp's 16, columns k0 / k0 + 8: a0..a3 of m16n8k16.
  uint32_t qf[KSTEPS][4];
  {
    const uint32_t base =
        smem_addr(sQ + (warp * 16 + (lane & 15)) * LD + (lane >> 4) * 8);
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk)
      ldsm_x4(base + kk * 16 * sizeof(bf16), qf[kk][0], qf[kk][1], qf[kk][2], qf[kk][3]);
  }
  const float sl2 = a.scale * LOG2E;
  // Lane offsets of the K (no .trans) and V (.trans) ldmatrix.x4 addresses:
  // K: matrices (keys +0, cols +0), (+0, +8), (+8, +0), (+8, +8) give b0, b1
  // of two adjacent key n-tiles; V: (keys +0, cols +0), (+8, +0), (+0, +8),
  // (+8, +8) give b0, b1 of two adjacent output n-tiles.
  const int k_off = ((lane >> 4) * 8 + (lane & 7)) * LD + ((lane >> 3) & 1) * 8;
  const int v_off = (((lane >> 3) & 1) * 8 + (lane & 7)) * LD + (lane >> 4) * 8;

  for (int t = 0; t < n_tiles; ++t) {
    const int stage = t & 1;
    // The next tile's loads go out before this tile's products.  Its stage
    // was last read in iteration t - 1, which ended in __syncthreads().
    if (t + 1 < n_tiles) load_kv(t + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    // S = Q Kᵀ: 16 × BN a warp, in BN/8 n-tiles of 8 keys.
    float s[NT_S][4];
#pragma unroll
    for (int j = 0; j < NT_S; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    const uint32_t k_base = smem_addr(sK + stage * BN * LD + k_off);
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
      for (int jp = 0; jp < NT_S / 2; ++jp) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4(k_base + (jp * 16 * LD + kk * 16) * sizeof(bf16), b0, b1, b2, b3);
        mma_bf16(s[2 * jp], qf[kk], b0, b1);
        mma_bf16(s[2 * jp + 1], qf[kk], b2, b3);
      }
    }

    // Online softmax in log2 units.  Masks only where the tile crosses
    // kv_len or this warp's diagonal; the row max is taken on the raw
    // scores (scale > 0) and the scale folds into one FFMA a score.
    const int kv0 = t * BN;
    const bool masked =
        kv0 + BN > a.kv_len || (a.causal && kv0 + BN - 1 > q0 + warp * 16);
    if (masked) {
#pragma unroll
      for (int j = 0; j < NT_S; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = kv0 + j * 8 + (lane & 3) * 2 + (e & 1);
          const int row = r_lo + (e >> 1) * 8;
          if (col >= a.kv_len || (a.causal && col > row)) s[j][e] = NEG_INF;
        }
      }
    }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < NT_S; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * h], s[j][2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_i[h], mx == NEG_INF ? NEG_INF : mx * sl2);
      // All keys so far masked: take exponentials against 0, so masked
      // entries give exp2(NEG_INF · sl2) = 0 and not exp2(0) = 1.
      const float base = m_new == NEG_INF ? 0.f : m_new;
      alpha[h] = exp2_approx(m_i[h] - base);
      m_i[h] = m_new;
      float ls = 0.f;
#pragma unroll
      for (int j = 0; j < NT_S; ++j) {
        s[j][2 * h] = exp2_approx(fmaf(s[j][2 * h], sl2, -base));
        s[j][2 * h + 1] = exp2_approx(fmaf(s[j][2 * h + 1], sl2, -base));
        ls += s[j][2 * h] + s[j][2 * h + 1];
      }
      l_i[h] = l_i[h] * alpha[h] + ls;
    }
#pragma unroll
    for (int j = 0; j < NT_O; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }

    // O += P V: P's accumulator registers, rounded to bf16, are the A
    // fragments of BN/16 k-steps of 16 keys.
    const uint32_t v_base = smem_addr(sV + stage * BN * LD + v_off);
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int jp = 0; jp < NT_O / 2; ++jp) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4_trans(v_base + (kk * 16 * LD + jp * 16) * sizeof(bf16), b0, b1, b2, b3);
        mma_bf16(acc[2 * jp], pa, b0, b1);
        mma_bf16(acc[2 * jp + 1], pa, b2, b3);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  bf16* o = static_cast<bf16*>(a.o) + (size_t)bh * a.n_rows * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_i[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = r_lo + h * 8;
    if (row >= a.n_rows) continue;
    // A row that saw no key (l = 0) writes O = 0 and LSE = NEG_INF.
    const float inv = l == 0.f ? 1.f : 1.f / l;
    bf16* orow = o + (size_t)row * D + (lane & 3) * 2;
#pragma unroll
    for (int j = 0; j < NT_O; ++j) {
      *reinterpret_cast<uint32_t*>(orow + j * 8) =
          pack_bf16(acc[j][2 * h] * inv, acc[j][2 * h + 1] * inv);
    }
    if (a.lse != nullptr && (lane & 3) == 0) {
      a.lse[(size_t)bh * a.n_rows + row] = l == 0.f ? NEG_INF : m_i[h] * LN2 + logf(l);
    }
  }
}

template <int D, int BM_, int BN_>
__global__ void __launch_bounds__(BM_ / 16 * 32) attn_fwd_mma_kernel(AttnArgs a) {
  FlashQK<D, BM_> qk;
  fwd_mma_walk<D, BM_, BN_>(a, qk);
}

// Launch a walk kernel of tile BM_ × BN_ on a grid of (heads, row blocks).
template <int D, int BM_, int BN_>
int launch_walk(void (*kern)(AttnArgs), const AttnArgs& a, int bhq, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<D, BM_, BN_>();
  static_assert(bytes <= 232448, "a tile over the opt-in shared memory of a block");
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(bhq, (a.n_rows + BM_ - 1) / BM_);
  kern<<<grid, warp_threads<BM_>(), bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

// The flash forward's instantiations of BM = 64 and 128 rows, each in a
// source of its own (flash_fwd_r64.cu, flash_fwd_r128.cu) so that the
// build compiles them in parallel: launch the (d, bn) tile there, or
// return cudaErrorInvalidValue for a tile that was not compiled.
int flash_fwd_r64(const AttnArgs& a, int d, int bn, int bhq, cudaStream_t stream);
int flash_fwd_r128(const AttnArgs& a, int d, int bn, int bhq, cudaStream_t stream);

inline int dispatch_attn_fwd_mma(const AttnArgs& a, int d, int bm, int bn, int bhq,
                                 cudaStream_t stream) {
  if (bm == 64) return flash_fwd_r64(a, d, bn, bhq, stream);
  if (bm == 128) return flash_fwd_r128(a, d, bn, bhq, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace tc
}  // namespace rt
