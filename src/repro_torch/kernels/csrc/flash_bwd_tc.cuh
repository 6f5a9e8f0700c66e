// Exact FA-2 backward on Hopper's tensor cores, bf16 in, f32 out (sm_90a):
// dQ, and dK / dV per query head; and, on the same two walks, the bf16
// DistrAttention backward (distr_bwd_tc.cuh).
//
// Replaces: src/repro/kernels/backward.py::_flash_dq_kernel and
// ::_flash_dkv_kernel for bf16 inputs (flash_backward.cu routes f32 to the
// FMA tile, attention_bwd_tile.cuh).
//
// Bound on this card: operations.  Per causal (row, key) pair dq does 3
// products (S, dP, dQ: 6·d FLOPs) and dkv 4 (S, dP, dV, dK: 8·d), against
// O(N·d) bytes per head.  The design is FA-2's backward (Dao 2023, Alg. 2)
// on mma.sync.m16n8k16 (bf16 → f32) with operands from ldmatrix, in the
// operand layouts of the forward (flash_fwd_tc.cuh); P and dS never leave
// registers, and the streamed tiles go through a two-stage cp.async ring.
// What it leaves to later work: wgmma, TMA and warp-specialised producers.
//
// The walks (bwd_dq_mma_walk, bwd_dkv_mma_walk) read Q at width D from
// a.q and are shared with the DistrAttention backward, which hands them Q̂
// expanded to full width.  dq's one policy point is how its accumulator
// leaves the CTA: FlashDqStore writes scale · dQ at width D.  The walks
// take the kernel's arguments by value: through a reference, ptxas gave
// the flash kernels up to 200 more instructions and dkv 18-24 more
// registers (168 → 192 at d = 64: one CTA an SM fewer), 7-12% slower; by
// value their SASS is the one-kernel version's, instruction for
// instruction (PERF.md §6).
//
// The tiles are template arguments of the walks; the static tiles, the
// ones REPRO_TUNE=off runs, are the sizes below, and the tuner
// (tune/autotune.py) sweeps dq's ROWS, KEYS ∈ {64, 128} and dkv's R ∈ {32,
// 64} × KEYS ∈ {64, 128} where they build without a spill (flash_dq_r*.cu,
// flash_dkv_r*.cu list them).  A CTA has 16 rows (dq) or keys (dkv) a warp.
//
// dq: one CTA of 4 warps owns 64 query rows of one (batch, query head), 16
//     rows a warp, and walks the keys in tiles of 64 (causal tile skip).
//     S = Q·Kᵀ and dP = dO·Vᵀ take A from ldmatrix on the row-major Q / dO
//     tile and B from ldmatrix (no .trans) on the row-major K / V tile;
//     dQ += dS·K takes dS from the accumulators of two adjacent n-tiles and
//     K's B operand from ldmatrix.trans.  dQ (16 × d f32 a warp) stays in
//     registers and leaves once, through the store policy.  K/V stream
//     through the ring; the last row block starts first (it has the most
//     key tiles).
// dkv: one CTA of 4 warps owns 64 keys of one query head, 16 keys a warp,
//     and walks the Q tiles (64 rows at d = 64, 32 at d = 112 and 128, so
//     that dK, dV and two score tiles fit the registers) from the first one
//     that can see its keys.  It computes the transposed scores, so nothing goes
//     through shared memory: Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ take A from K / V and
//     B from the row-major Q / dO tile; dV += Pᵀ·dO and dK += dSᵀ·Q take the
//     packed accumulators as A and dO's / Q's B operand from ldmatrix.trans.
//     LSE and D are per column: each Q tile brings its rows' values into
//     shared memory beside Q and dO.  Q, dO, LSE and D stream through the
//     ring; key block 0 starts first (under a causal mask it sees every row).
//
// Accuracy: S and dP take bf16 inputs only, so they differ from the f32
// plain version only in summation order.  The products that take P or dS
// would lose about 2^-9 of relative error a term if P and dS were rounded to
// bf16, which the backward's 1e-4 check does not allow; so each such A
// operand is split, hi = bf16(x) and lo = bf16(x - hi), and both go into the
// same f32 accumulator (about 2^-17 left).  dq issues 4 products, dkv 6.
//
// Masks are selects, never products: keys at or past kv_len and, when
// causal, key > row, on the tiles that cross them only.  Rows at or past N
// load LSE = LSE_PAD, so their P is exactly 0; Q, dO, K and V past their
// ends load as zeros (cp.async's zero-fill from a clamped in-bounds
// address), so memory past a buffer is never read.  kv_len = 0 gives zero
// dQ, dK and dV.  Exponentials are one FFMA (scale · log2 e folded in) and
// one ex2.approx.
//
// Shared memory, bf16 rows padded by 8 elements as in the forward: dq holds
// Q and dO (rows × (d + 8) each) and 2 stages of K and V (keys × (d + 8)
// each): 104,448 bytes at d = 128, 92,160 at d = 112, 55,296 at d = 64 on
// the static tile.  dkv holds K and V and 2 stages of Q, dO (rows × (d +
// 8) each), LSE and D (f32): 70,144 bytes at d = 128, 61,952 at d = 112,
// 56,320 at d = 64 on the static tile.
//
// d = 112 (zamba2-7b's heads) is 7 mma depths and 14 chunks of 16 bytes a
// row.  A tile whose rows are as many as the CTA's warps hold (Q and dO in
// dq, K and V in dkv) loads in whole rounds of the threads; a streamed one
// whose rows are fewer or more may not (dkv's Q tile of 32 rows × 14
// chunks is 3.5 rounds of 128 threads), and its last round is partial.
// The guard that skips its idle threads is compiled only where the rounds
// are not whole (``if constexpr``), so the other tiles keep their SASS.
#pragma once

#include "attention_bwd_tile.cuh"
#include "mma_sync.cuh"

namespace rt {
namespace tc {

constexpr int DQ_ROWS = 64;   // dq's static tile: query rows per CTA, 16 a warp
constexpr int DQ_KEYS = 64;   // dq's static tile: keys per K/V tile
constexpr int DKV_KEYS = 64;  // dkv's static tile: keys per CTA, 16 a warp

// dkv's static tile: query rows per Q tile.
template <int D>
__host__ __device__ constexpr int dkv_rows() {
  return D > 64 ? 32 : 64;
}

template <int D, int ROWS = DQ_ROWS, int KEYS = DQ_KEYS>
constexpr size_t dq_smem_bytes() {
  return (size_t)(2 * ROWS + 4 * KEYS) * (D + 8) * sizeof(__nv_bfloat16);
}

template <int D, int R = dkv_rows<D>(), int KEYS = DKV_KEYS>
constexpr size_t dkv_smem_bytes() {
  return (size_t)(2 * KEYS + 4 * R) * (D + 8) * sizeof(__nv_bfloat16) + 4 * R * sizeof(float);
}

// 4 bytes global → shared (cp.async.ca: the only form below 16 bytes).
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src) : "memory");
}

// The flash dq's store: dQ = scale · acc, straight from the fragments at
// width D (lane l holds rows r_lo, r_lo + 8 of the (batch, head) and columns
// 2(l%4), 2(l%4) + 1 of each 8-wide n-tile).
template <int D>
struct FlashDqStore {
  __device__ __forceinline__ void store(const BwdArgs& a, const float (&acc)[D / 8][4], int bh,
                                        int, int r_lo) const {
    const int lane = threadIdx.x & 31;
    float* dq = a.dq + (size_t)bh * a.n_rows * D;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r_lo + h * 8;
      if (row >= a.n_rows) continue;
      float* out = dq + (size_t)row * D + (lane & 3) * 2;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<float2*>(out + j * 8) =
            make_float2(acc[j][2 * h] * a.scale, acc[j][2 * h + 1] * a.scale);
      }
    }
  }
};

// One dq CTA: its ROWS rows of one (batch, query head) against every key
// tile of KEYS keys they see; the accumulator leaves through st.store()
// after the last tile's __syncthreads(), when shared memory is free.
template <int D, int ROWS, int KEYS, class Store>
__device__ __forceinline__ void bwd_dq_mma_walk(const BwdArgs a, const Store& st) {
  static_assert(D % 16 == 0, "head dim must be a multiple of the mma depth");
  static_assert(ROWS % 16 == 0 && KEYS % 16 == 0, "tiles of whole warps and k-steps");
  constexpr int BWD_THREADS = warp_threads<ROWS>();
  constexpr int DQ_ROWS = ROWS;
  constexpr int DQ_KEYS = KEYS;
  static_assert(DQ_ROWS * (D / 8) % BWD_THREADS == 0,
                "every thread loads the same number of the Q / dO tile's 16-byte chunks");
  constexpr int KV_CHUNKS = DQ_KEYS * (D / 8);  // a K (or V) tile's 16-byte chunks
  constexpr int LD = D + 8;          // shared-memory row stride, elements
  constexpr int CHUNKS = D / 8;      // 16-byte chunks a row
  constexpr int KSTEPS = D / 16;     // k-steps of Q·Kᵀ and dO·Vᵀ
  constexpr int NT_S = DQ_KEYS / 8;  // n-tiles of a warp's scores
  constexpr int NT_O = D / 8;        // n-tiles of a warp's dQ
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // [DQ_ROWS][LD]
  bf16* sdO = sQ + DQ_ROWS * LD;                 // [DQ_ROWS][LD]
  bf16* sK = sdO + DQ_ROWS * LD;                 // [2][DQ_KEYS][LD]
  bf16* sV = sK + 2 * DQ_KEYS * LD;              // [2][DQ_KEYS][LD]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * DQ_ROWS;
  const int bkv = bh / a.q_per_kv;
  const bf16* q = static_cast<const bf16*>(a.q) + (size_t)bh * a.n_rows * D;
  const bf16* dout = static_cast<const bf16*>(a.dout) + (size_t)bh * a.n_rows * D;
  const bf16* k = static_cast<const bf16*>(a.k) + (size_t)bkv * a.nk * D;
  const bf16* v = static_cast<const bf16*>(a.v) + (size_t)bkv * a.nk * D;

  int n_tiles = (a.kv_len + DQ_KEYS - 1) / DQ_KEYS;
  if (a.causal) {
    const int last_row = min(q0 + DQ_ROWS, a.n_rows) - 1;
    n_tiles = min(n_tiles, last_row / DQ_KEYS + 1);  // skip tiles above the diagonal
  }

  auto load_kv = [&](int t, int stage) {
    bf16* dk = sK + stage * DQ_KEYS * LD;
    bf16* dv = sV + stage * DQ_KEYS * LD;
#pragma unroll
    for (int it = 0; it < (KV_CHUNKS + BWD_THREADS - 1) / BWD_THREADS; ++it) {
      const int i = tid + it * BWD_THREADS;
      if constexpr (KV_CHUNKS % BWD_THREADS != 0) {
        if (i >= KV_CHUNKS) break;
      }
      const int row = i / CHUNKS;
      const int col = (i - row * CHUNKS) * 8;
      const int key = t * DQ_KEYS + row;
      const size_t src = (size_t)min(key, a.kv_len - 1) * D + col;
      cp_async16(smem_addr(dk + row * LD + col), k + src, key < a.kv_len);
      cp_async16(smem_addr(dv + row * LD + col), v + src, key < a.kv_len);
    }
  };

  if (n_tiles > 0) {
#pragma unroll
    for (int it = 0; it < DQ_ROWS * CHUNKS / BWD_THREADS; ++it) {
      const int i = tid + it * BWD_THREADS;
      const int row = i / CHUNKS;
      const int col = (i - row * CHUNKS) * 8;
      const size_t src = (size_t)min(q0 + row, a.n_rows - 1) * D + col;
      cp_async16(smem_addr(sQ + row * LD + col), q + src, q0 + row < a.n_rows);
      cp_async16(smem_addr(sdO + row * LD + col), dout + src, q0 + row < a.n_rows);
    }
    load_kv(0, 0);
    cp_async_commit();
  }

  // Lane l's rows: r_lo of c0, c1 and r_lo + 8 of c2, c3.  A row past N
  // takes LSE_PAD, so its P is exactly 0.
  const int r_lo = q0 + warp * 16 + (lane >> 2);
  float nlse[2], dlt[2];  // -LSE · log2 e and D of the two rows
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r_lo + h * 8;
    const bool live = row < a.n_rows;
    nlse[h] = -(live ? a.lse[(size_t)bh * a.n_rows + row] : LSE_PAD) * LOG2E;
    dlt[h] = live ? a.delta[(size_t)bh * a.n_rows + row] : 0.f;
  }
  const float sl2 = a.scale * LOG2E;
  float acc[NT_O][4];
#pragma unroll
  for (int j = 0; j < NT_O; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  const uint32_t q_frag = smem_addr(sQ + warp * 16 * LD + a_lane_off(lane, LD));
  const uint32_t do_frag = smem_addr(sdO + warp * 16 * LD + a_lane_off(lane, LD));
  const int b_off = b_lane_off(lane, LD);
  const int bt_off = bt_lane_off(lane, LD);

  for (int t = 0; t < n_tiles; ++t) {
    const int stage = t & 1;
    // The next tile's loads go out before this tile's products.  Its stage
    // was last read in iteration t - 1, which ended in __syncthreads().
    if (t + 1 < n_tiles) load_kv(t + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    // S = Q Kᵀ and dP = dO Vᵀ: 16 × KEYS a warp each, in n-tiles of 8 keys.
    float s[NT_S][4], dp[NT_S][4];
#pragma unroll
    for (int j = 0; j < NT_S; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
    }
    const uint32_t k_tile = smem_addr(sK + stage * DQ_KEYS * LD + b_off);
    const uint32_t v_tile = smem_addr(sV + stage * DQ_KEYS * LD + b_off);
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      uint32_t qa[4], da[4];
      ldsm_x4(q_frag + kk * 16 * sizeof(bf16), qa[0], qa[1], qa[2], qa[3]);
      ldsm_x4(do_frag + kk * 16 * sizeof(bf16), da[0], da[1], da[2], da[3]);
#pragma unroll
      for (int jp = 0; jp < NT_S / 2; ++jp) {
        const uint32_t off = (jp * 16 * LD + kk * 16) * sizeof(bf16);
        uint32_t b0, b1, b2, b3;
        ldsm_x4(k_tile + off, b0, b1, b2, b3);
        mma_bf16(s[2 * jp], qa, b0, b1);
        mma_bf16(s[2 * jp + 1], qa, b2, b3);
        ldsm_x4(v_tile + off, b0, b1, b2, b3);
        mma_bf16(dp[2 * jp], da, b0, b1);
        mma_bf16(dp[2 * jp + 1], da, b2, b3);
      }
    }

    // P from the saved LSE, masked by select, then dS = P (dP - D) in s.
    const int kv0 = t * DQ_KEYS;
    const bool masked =
        kv0 + DQ_KEYS > a.kv_len || (a.causal && kv0 + DQ_KEYS - 1 > q0 + warp * 16);
#pragma unroll
    for (int j = 0; j < NT_S; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2_approx(fmaf(s[j][e], sl2, nlse[e >> 1]));
        if (masked) {
          const int col = kv0 + j * 8 + (lane & 3) * 2 + (e & 1);
          const int row = r_lo + (e >> 1) * 8;
          if (col >= a.kv_len || (a.causal && col > row)) p = 0.f;
        }
        s[j][e] = p * (dp[j][e] - dlt[e >> 1]);
      }
    }

    // dQ += dS K: dS as hi + lo A fragments of KEYS/16 k-steps of 16 keys.
    const uint32_t kt_tile = smem_addr(sK + stage * DQ_KEYS * LD + bt_off);
#pragma unroll
    for (int kk = 0; kk < DQ_KEYS / 16; ++kk) {
      uint32_t hi[4], lo[4];
      split_a(s, kk, hi, lo);
#pragma unroll
      for (int jp = 0; jp < NT_O / 2; ++jp) {
        mma_split(acc[2 * jp], acc[2 * jp + 1], hi, lo,
                  kt_tile + (kk * 16 * LD + jp * 16) * sizeof(bf16));
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  st.store(a, acc, bh, q0, r_lo);
}

template <int D, int ROWS, int KEYS>
__global__ void __launch_bounds__(ROWS / 16 * 32) attn_bwd_dq_mma_kernel(BwdArgs a) {
  bwd_dq_mma_walk<D, ROWS, KEYS>(a, FlashDqStore<D>{});
}

// One dkv CTA: its KEYS keys of one query head against every Q tile of R
// rows that sees them.
template <int D, int R, int KEYS>
__device__ __forceinline__ void bwd_dkv_mma_walk(const BwdArgs a) {
  static_assert(D % 16 == 0 && R % 16 == 0 && KEYS % 16 == 0,
                "head dim and tiles must be multiples of 16");
  constexpr int BWD_THREADS = warp_threads<KEYS>();
  constexpr int DKV_KEYS = KEYS;
  static_assert(DKV_KEYS * (D / 8) % BWD_THREADS == 0 && R <= BWD_THREADS,
                "every thread loads the same number of the K / V tile's 16-byte chunks");
  constexpr int LD = D + 8;       // shared-memory row stride, elements
  constexpr int CHUNKS = D / 8;   // 16-byte chunks a row
  constexpr int KSTEPS = D / 16;  // k-steps of K·Qᵀ and V·dOᵀ
  constexpr int NT_S = R / 8;     // n-tiles of a warp's transposed scores
  constexpr int NT_O = D / 8;     // n-tiles of a warp's dK and dV
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);           // [DKV_KEYS][LD]
  bf16* sV = sK + DKV_KEYS * LD;                          // [DKV_KEYS][LD]
  bf16* sQ = sV + DKV_KEYS * LD;                          // [2][R][LD]
  bf16* sdO = sQ + 2 * R * LD;                            // [2][R][LD]
  float* sLse = reinterpret_cast<float*>(sdO + 2 * R * LD);  // [2][R]
  float* sDelta = sLse + 2 * R;                           // [2][R]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * DKV_KEYS;
  const int bkv = bh / a.q_per_kv;
  const bf16* q = static_cast<const bf16*>(a.q) + (size_t)bh * a.n_rows * D;
  const bf16* dout = static_cast<const bf16*>(a.dout) + (size_t)bh * a.n_rows * D;
  const bf16* k = static_cast<const bf16*>(a.k) + (size_t)bkv * a.nk * D;
  const bf16* v = static_cast<const bf16*>(a.v) + (size_t)bkv * a.nk * D;
  const float* lse = a.lse + (size_t)bh * a.n_rows;
  const float* delta = a.delta + (size_t)bh * a.n_rows;

  const int t_start = a.causal ? k0 / R : 0;  // earlier rows see none of these keys
  const int t_end = k0 < a.kv_len ? (a.n_rows + R - 1) / R : 0;  // all keys masked: none

  // Rows at or past N land as zeros, with LSE = LSE_PAD and D = 0.  The
  // tile's R · CHUNKS chunks may end in a partial round of the threads
  // (d = 112), whose idle threads skip it.
  constexpr int Q_CHUNKS = R * CHUNKS;
  auto load_q = [&](int t, int stage) {
    bf16* dq_ = sQ + stage * R * LD;
    bf16* ddo = sdO + stage * R * LD;
#pragma unroll
    for (int it = 0; it < (Q_CHUNKS + BWD_THREADS - 1) / BWD_THREADS; ++it) {
      const int i = tid + it * BWD_THREADS;
      if constexpr (Q_CHUNKS % BWD_THREADS != 0) {
        if (i >= Q_CHUNKS) break;
      }
      const int row = i / CHUNKS;
      const int col = (i - row * CHUNKS) * 8;
      const int r = t * R + row;
      const size_t src = (size_t)min(r, a.n_rows - 1) * D + col;
      cp_async16(smem_addr(dq_ + row * LD + col), q + src, r < a.n_rows);
      cp_async16(smem_addr(ddo + row * LD + col), dout + src, r < a.n_rows);
    }
    if (tid < R) {
      const int r = t * R + tid;
      float* l = sLse + stage * R + tid;
      float* dd = sDelta + stage * R + tid;
      if (r < a.n_rows) {
        cp_async4(smem_addr(l), lse + r);
        cp_async4(smem_addr(dd), delta + r);
      } else {
        *l = LSE_PAD;
        *dd = 0.f;
      }
    }
  };

  if (t_start < t_end) {
    // Keys at or past kv_len land as zeros (kv_len > k0 here).
#pragma unroll
    for (int it = 0; it < DKV_KEYS * CHUNKS / BWD_THREADS; ++it) {
      const int i = tid + it * BWD_THREADS;
      const int row = i / CHUNKS;
      const int col = (i - row * CHUNKS) * 8;
      const int key = k0 + row;
      const size_t src = (size_t)min(key, a.kv_len - 1) * D + col;
      cp_async16(smem_addr(sK + row * LD + col), k + src, key < a.kv_len);
      cp_async16(smem_addr(sV + row * LD + col), v + src, key < a.kv_len);
    }
    load_q(t_start, 0);
    cp_async_commit();
  }

  // Lane l's keys: key_lo of c0, c1 and key_lo + 8 of c2, c3; its columns
  // (query rows) are 2(l%4), 2(l%4) + 1 of each n-tile.
  const int key_lo = k0 + warp * 16 + (lane >> 2);
  const int key_last = k0 + warp * 16 + 15;
  const float sl2 = a.scale * LOG2E;
  float accv[NT_O][4], acck[NT_O][4];
#pragma unroll
  for (int j = 0; j < NT_O; ++j) {
    accv[j][0] = accv[j][1] = accv[j][2] = accv[j][3] = 0.f;
    acck[j][0] = acck[j][1] = acck[j][2] = acck[j][3] = 0.f;
  }

  const uint32_t k_frag = smem_addr(sK + warp * 16 * LD + a_lane_off(lane, LD));
  const uint32_t v_frag = smem_addr(sV + warp * 16 * LD + a_lane_off(lane, LD));
  const int b_off = b_lane_off(lane, LD);
  const int bt_off = bt_lane_off(lane, LD);

  for (int t = t_start; t < t_end; ++t) {
    const int stage = (t - t_start) & 1;
    if (t + 1 < t_end) load_q(t + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    // Sᵀ = K Qᵀ and dPᵀ = V dOᵀ: 16 keys × R rows a warp each.
    float s[NT_S][4], dp[NT_S][4];
#pragma unroll
    for (int j = 0; j < NT_S; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
    }
    const uint32_t q_tile = smem_addr(sQ + stage * R * LD + b_off);
    const uint32_t do_tile = smem_addr(sdO + stage * R * LD + b_off);
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      uint32_t ka[4], va[4];
      ldsm_x4(k_frag + kk * 16 * sizeof(bf16), ka[0], ka[1], ka[2], ka[3]);
      ldsm_x4(v_frag + kk * 16 * sizeof(bf16), va[0], va[1], va[2], va[3]);
#pragma unroll
      for (int jp = 0; jp < NT_S / 2; ++jp) {
        const uint32_t off = (jp * 16 * LD + kk * 16) * sizeof(bf16);
        uint32_t b0, b1, b2, b3;
        ldsm_x4(q_tile + off, b0, b1, b2, b3);
        mma_bf16(s[2 * jp], ka, b0, b1);
        mma_bf16(s[2 * jp + 1], ka, b2, b3);
        ldsm_x4(do_tile + off, b0, b1, b2, b3);
        mma_bf16(dp[2 * jp], va, b0, b1);
        mma_bf16(dp[2 * jp + 1], va, b2, b3);
      }
    }

    // Pᵀ in s and dSᵀ = Pᵀ (dPᵀ - D) in dp, with each column's LSE and D.
    const int row0 = t * R;
    const bool masked = key_last >= a.kv_len || (a.causal && key_last > row0);
    const float* lse_t = sLse + stage * R + (lane & 3) * 2;
    const float* dlt_t = sDelta + stage * R + (lane & 3) * 2;
#pragma unroll
    for (int j = 0; j < NT_S; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(lse_t + j * 8);
      const float2 d2 = *reinterpret_cast<const float2*>(dlt_t + j * 8);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float l = (e & 1) ? l2.y : l2.x;
        float p = exp2_approx(fmaf(s[j][e], sl2, -l * LOG2E));
        if (masked) {
          const int key = key_lo + (e >> 1) * 8;
          const int row = row0 + j * 8 + (lane & 3) * 2 + (e & 1);
          if (key >= a.kv_len || (a.causal && key > row)) p = 0.f;
        }
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] - ((e & 1) ? d2.y : d2.x));
      }
    }

    // dV += Pᵀ dO and dK += dSᵀ Q: hi + lo A fragments of R/16 k-steps.
    const uint32_t do_t = smem_addr(sdO + stage * R * LD + bt_off);
    const uint32_t q_t = smem_addr(sQ + stage * R * LD + bt_off);
#pragma unroll
    for (int kk = 0; kk < R / 16; ++kk) {
      uint32_t ph[4], pl[4], dh[4], dl[4];
      split_a(s, kk, ph, pl);
      split_a(dp, kk, dh, dl);
#pragma unroll
      for (int jp = 0; jp < NT_O / 2; ++jp) {
        const uint32_t off = (kk * 16 * LD + jp * 16) * sizeof(bf16);
        mma_split(accv[2 * jp], accv[2 * jp + 1], ph, pl, do_t + off);
        mma_split(acck[2 * jp], acck[2 * jp + 1], dh, dl, q_t + off);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = key_lo + h * 8;
    if (key >= a.nk) continue;
    float* dvrow = a.dv + ((size_t)bh * a.nk + key) * D + (lane & 3) * 2;
    float* dkrow = a.dk + ((size_t)bh * a.nk + key) * D + (lane & 3) * 2;
#pragma unroll
    for (int j = 0; j < NT_O; ++j) {
      *reinterpret_cast<float2*>(dvrow + j * 8) = make_float2(accv[j][2 * h], accv[j][2 * h + 1]);
      *reinterpret_cast<float2*>(dkrow + j * 8) =
          make_float2(acck[j][2 * h] * a.scale, acck[j][2 * h + 1] * a.scale);
    }
  }
}

template <int D, int R, int KEYS>
__global__ void __launch_bounds__(KEYS / 16 * 32) attn_bwd_dkv_mma_kernel(BwdArgs a) {
  bwd_dkv_mma_walk<D, R, KEYS>(a);
}

// Launch a dq (DKV = false) or dkv kernel of the walks above, flash's or
// DistrAttention's, on the walk's grid and shared memory: ROWS query rows
// (dq's CTA; dkv's Q tile) and KEYS keys (dq's K/V tile; dkv's CTA).
template <int D, int ROWS, int KEYS, bool DKV>
int launch_bwd_walk(void (*kern)(BwdArgs), const BwdArgs& a, int bhq, cudaStream_t stream) {
  constexpr size_t bytes = DKV ? dkv_smem_bytes<D, ROWS, KEYS>() : dq_smem_bytes<D, ROWS, KEYS>();
  static_assert(bytes <= 232448, "a tile over the opt-in shared memory of a block");
  const int blocks = DKV ? (a.nk + KEYS - 1) / KEYS : (a.n_rows + ROWS - 1) / ROWS;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  // Heads vary fastest, so CTAs of one KV head are neighbours in L2.
  const dim3 grid(bhq, blocks);
  kern<<<grid, warp_threads<DKV ? KEYS : ROWS>(), bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

// The flash backward's instantiations, one source for each walk and row
// tile (flash_dq_r64.cu, flash_dq_r128.cu, flash_dkv_r32.cu,
// flash_dkv_r64.cu) so that the build compiles them in parallel: launch
// the (d, keys) tile there, or return cudaErrorInvalidValue for a tile
// that was not compiled.
int flash_dq_r64(const BwdArgs& a, int d, int keys, int bhq, cudaStream_t stream);
int flash_dq_r128(const BwdArgs& a, int d, int keys, int bhq, cudaStream_t stream);
int flash_dkv_r32(const BwdArgs& a, int d, int keys, int bhq, cudaStream_t stream);
int flash_dkv_r64(const BwdArgs& a, int d, int keys, int bhq, cudaStream_t stream);

template <bool DKV>
int dispatch_attn_bwd_mma(const BwdArgs& a, int d, int rows, int keys, int bhq,
                          cudaStream_t stream) {
  if (!DKV && rows == 64) return flash_dq_r64(a, d, keys, bhq, stream);
  if (!DKV && rows == 128) return flash_dq_r128(a, d, keys, bhq, stream);
  if (DKV && rows == 32) return flash_dkv_r32(a, d, keys, bhq, stream);
  if (DKV && rows == 64) return flash_dkv_r64(a, d, keys, bhq, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace tc
}  // namespace rt
