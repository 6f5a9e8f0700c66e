// Split-K decode on Hopper's tensor cores, bf16 in, f32 partials out
// (sm_90a): the one tile of the bf16 contiguous decode kernel (decode.cu)
// and the bf16 paged decode kernel (paged_decode.cu).
//
// Replaces, for bf16 inputs: src/repro/kernels/decode.py::_decode_kernel and
// src/repro/kernels/paged_decode.py::_paged_decode_kernel (their f32 inputs
// stay on the FMA loops of decode.cu and paged_decode.cu).
//
// Contract (both kernels): one CTA per (split, kv head, batch) owns the
// split's n_live ≥ 1 keys (K rows of ds, V rows of DV, contiguous) and all
// `rows` packed query rows of its kv head; packed row r is query token
// r % q_len and sees keys < length − (q_len − 1 − r % q_len).  It writes
// unnormalised partials o = Σ exp(s − m)·V, m = rowmax s (the split's exact
// max of s = scale · q·k), l = Σ exp(s − m).  A masked score is −1e30 and
// its P is exactly 0, also in a row that sees none of the split's keys
// (o = 0, m = −1e30, l = 0).  A dead split writes that identity for every
// row (write_identity).
//
// Bound on this card: bytes for a decode tick (9 rows, or 1 at zamba2-7b,
// against every live K/V byte: far below the ridge); for a 288-row chunk
// the tensor work comes close to the bytes.  The design:
// - Loads: the split's K and V stream in tiles of 64 keys through a
//   2-stage cp.async ring, each tile's Q rows with it.  A split of at most
//   two tiles (the serving block of 128) stays resident: both tiles go out
//   at once and every round of m-tiles reuses them.  Rows past n_live,
//   columns past ds and Q rows past `rows` land as zeros (cp.async
//   zero-fill), so a P·V product never meets stale pool memory (0 · NaN).
// - S = Q·Kᵀ on mma.sync.m16n8k16 (bf16 → f32: exact products), operands
//   from ldmatrix in the layouts of flash_fwd_tc.cuh.  Rows pad to 16-row
//   m-tiles; ds pads to a multiple of 16 with zero columns in shared memory
//   (d/G* = 56 adds exactly 0).
// - P·V on mma.sync with P split into bf16 hi + lo (mma_split): P rounded
//   to bf16 alone carries ~2^-9 of relative error, which misses the 1e-4
//   the partials are held to; hi + lo leaves ~2^-17.  V comes in through
//   ldmatrix.trans.
// - Work split, KW warps per m-tile: one m-tile (rows ≤ 16, a tick) takes
//   keys over warps (KW = 4, 16 keys a warp of each tile), two take KW = 2,
//   more take rows over warps (KW = 1, an m-tile a warp a round).  The KW
//   warps of an m-tile merge (m, l, o) through shared memory at the end.
// - Every o partial leaves in 16-byte stores: lane pairs trade halves of
//   their accumulator fragments so each lane holds 4 adjacent columns.
//
// Shared memory, bf16, rows padded by 8 elements as in the forward: 2
// stages of K (64 × (16·⌈ds/16⌉ + 8)) and V (64 × (DV + 8)), and 2 buffers
// of a round's Q rows (16·4/KW × the K stride).  At ds = DV = 128: 78,336
// bytes (KW = 4), 87,040 (KW = 2), 104,448 (KW = 1): two CTAs an SM.
#pragma once

#include "common.cuh"
#include "mma_sync.cuh"

namespace rt {
namespace tc {

constexpr int DT_KEYS = 64;  // keys per K/V tile
constexpr int DT_WARPS = 4;
constexpr int DT_THREADS = DT_WARPS * 32;

// Warps sharing an m-tile (keys over warps) for a packed row count.
inline int decode_kw(int rows) {
  const int n_mt = (rows + 15) / 16;
  return n_mt == 1 ? 4 : n_mt == 2 ? 2 : 1;
}

inline size_t decode_smem_bytes(int ds, int dv, int kw) {
  const int ldk = 16 * ((ds + 15) / 16) + 8;
  const int q_rows = 16 * (DT_WARPS / kw);
  return (size_t)2 * (DT_KEYS * (ldk + dv + 8) + q_rows * ldk) * sizeof(__nv_bfloat16);
}

struct DecodeTile {
  const __nv_bfloat16* q;  // (rows, ds) of this (batch, kv head)
  const __nv_bfloat16* k;  // (n_live, ds): the split's keys
  const __nv_bfloat16* v;  // (n_live, DV)
  float* o;                // (rows, DV) partials of this split
  float* m;                // (rows,)
  float* l;                // (rows,)
  int rows;
  int ds;
  int q_len;
  int n_live;
  int len0;  // length − kv0 − (q_len − 1): row r sees split keys < len0 + r % q_len
  float scale;
};

// A dead split: o = 0, m = −1e30, l = 0 for every row.
template <int DV>
__device__ __forceinline__ void write_identity(float* o, float* m, float* l, int rows) {
  float4* o4 = reinterpret_cast<float4*>(o);
  for (int i = threadIdx.x; i < rows * DV / 4; i += DT_THREADS) {
    o4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int i = threadIdx.x; i < rows; i += DT_THREADS) {
    m[i] = NEG_INF;
    l[i] = 0.f;
  }
}

template <int DV, int KW>
__device__ __forceinline__ void decode_tile(const DecodeTile& a) {
  static_assert(DV % 16 == 0, "value width must be a multiple of the mma depth");
  static_assert(KW == 1 || KW == 2 || KW == 4, "warps per m-tile");
  static_assert(DT_KEYS * (DV / 8) % DT_THREADS == 0, "V chunks split evenly over the threads");
  using bf16 = __nv_bfloat16;
  constexpr int MW = DT_WARPS / KW;    // m-tiles a round
  constexpr int QR = 16 * MW;          // Q rows staged a round
  constexpr int KPW = DT_KEYS / KW;    // keys a warp takes of each tile
  constexpr int NT_S = KPW / 8;        // n-tiles of a warp's scores
  constexpr int NT_O = DV / 8;         // n-tiles of a warp's output
  constexpr int LDV = DV + 8;
  constexpr int VCHUNKS = DV / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ks = (a.ds + 15) >> 4;     // k-steps of Q·Kᵀ
  const int ldk = 16 * ks + 8;
  const int kchunks = 2 * ks;          // 16-byte chunks of a staged K or Q row
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);  // [2][DT_KEYS][ldk]
  bf16* sV = sK + 2 * DT_KEYS * ldk;             // [2][DT_KEYS][LDV]
  bf16* sQ = sV + 2 * DT_KEYS * LDV;             // [2][QR][ldk]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int mg = warp / KW;  // m-tile of the round
  const int kg = warp % KW;  // share of each key tile
  const int n_tiles = (a.n_live + DT_KEYS - 1) / DT_KEYS;
  const int n_mt = (a.rows + 15) >> 4;
  const int total = (n_mt + MW - 1) / MW * n_tiles;
  const bool resident = n_tiles <= 2;

  // Load step g: key tile g % n_tiles of round g / n_tiles, and the
  // round's Q rows with its first tile.  A resident split loads its tiles
  // in round 0 only, tile t into stage t.
  auto load = [&](int g) {
    if (g >= total) return;
    const int r = g / n_tiles;
    const int t = g - r * n_tiles;
    if (t == 0) {
      bf16* dq = sQ + (r & 1) * QR * ldk;
      for (int i = tid; i < QR * kchunks; i += DT_THREADS) {
        const int row = i / kchunks;
        const int c = i - row * kchunks;
        const int qrow = r * QR + row;
        const bool ok = qrow < a.rows && c * 8 < a.ds;
        cp_async16(smem_addr(dq + row * ldk + c * 8), ok ? a.q + (size_t)qrow * a.ds + c * 8 : a.q,
                   ok);
      }
    }
    if (resident && r > 0) return;
    const int stage = resident ? t : (g & 1);
    bf16* dk = sK + stage * DT_KEYS * ldk;
    bf16* dv = sV + stage * DT_KEYS * LDV;
    const int key0 = t * DT_KEYS;
    for (int i = tid; i < DT_KEYS * kchunks; i += DT_THREADS) {
      const int row = i / kchunks;
      const int c = i - row * kchunks;
      const int key = key0 + row;
      const bool ok = key < a.n_live && c * 8 < a.ds;
      cp_async16(smem_addr(dk + row * ldk + c * 8), ok ? a.k + (size_t)key * a.ds + c * 8 : a.k,
                 ok);
    }
#pragma unroll
    for (int it = 0; it < DT_KEYS * VCHUNKS / DT_THREADS; ++it) {
      const int i = tid + it * DT_THREADS;
      const int row = i / VCHUNKS;
      const int c = i - row * VCHUNKS;
      const int key = key0 + row;
      const bool ok = key < a.n_live;
      cp_async16(smem_addr(dv + row * LDV + c * 8), ok ? a.v + (size_t)key * DV + c * 8 : a.v, ok);
    }
  };

  // Lane l holds rows l/4 (c0, c1) and l/4 + 8 (c2, c3) of each fragment.
  const int g_row = lane >> 2;
  const int t4 = lane & 3;
  const float sl2 = a.scale * LOG2E;
  float acc[NT_O][4];
  float m_i[2] = {NEG_INF, NEG_INF};  // running max of the raw scores q·k
  float l_i[2] = {0.f, 0.f};          // this lane's share of the running sum
  int lim[2] = {0, 0};                // split keys each of the lane's rows sees
#pragma unroll
  for (int j = 0; j < NT_O; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  load(0);
  cp_async_commit();
  for (int g = 0; g < total; ++g) {
    // The next step's loads go out before this step's products.  Its
    // stage was last read in step g − 1, which ended in __syncthreads().
    load(g + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    const int r = g / n_tiles;
    const int t = g - r * n_tiles;
    const int stage = resident ? t : (g & 1);
    const int mt = r * MW + mg;
    if (t == 0) {  // a new m-tile
#pragma unroll
      for (int j = 0; j < NT_O; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        m_i[h] = NEG_INF;
        l_i[h] = 0.f;
        lim[h] = min(a.n_live, a.len0 + (mt * 16 + g_row + 8 * h) % a.q_len);
      }
    }
    if (mt < n_mt) {
      // S = Q Kᵀ over this warp's KPW keys of the tile.
      float s[NT_S][4];
#pragma unroll
      for (int j = 0; j < NT_S; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const uint32_t q_addr =
          smem_addr(sQ + ((r & 1) * QR + mg * 16) * ldk + a_lane_off(lane, ldk));
      const uint32_t k_addr =
          smem_addr(sK + (stage * DT_KEYS + kg * KPW) * ldk + b_lane_off(lane, ldk));
      for (int kk = 0; kk < ks; ++kk) {
        uint32_t qa[4];
        ldsm_x4(q_addr + kk * 16 * sizeof(bf16), qa[0], qa[1], qa[2], qa[3]);
#pragma unroll
        for (int jp = 0; jp < NT_S / 2; ++jp) {
          uint32_t b0, b1, b2, b3;
          ldsm_x4(k_addr + (jp * 16 * ldk + kk * 16) * sizeof(bf16), b0, b1, b2, b3);
          mma_bf16(s[2 * jp], qa, b0, b1);
          mma_bf16(s[2 * jp + 1], qa, b2, b3);
        }
      }

      // Mask, then the online softmax in raw-score units: the exponent
      // (s − m)·scale·log2 e is one FFMA, and a masked score's P is 0 by
      // select, never by a product with the mask.
      const int key0 = t * DT_KEYS + kg * KPW + 2 * t4;
      float alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = NEG_INF;
#pragma unroll
        for (int j = 0; j < NT_S; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (key0 + j * 8 + e >= lim[h]) s[j][2 * h + e] = NEG_INF;
            mx = fmaxf(mx, s[j][2 * h + e]);
          }
        }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_i[h], mx);
        alpha[h] = exp2_approx((m_i[h] - m_new) * sl2);
        m_i[h] = m_new;
        const float base = m_new * sl2;
        float ls = 0.f;
#pragma unroll
        for (int j = 0; j < NT_S; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float sv = s[j][2 * h + e];
            const float p = sv == NEG_INF ? 0.f : exp2_approx(fmaf(sv, sl2, -base));
            s[j][2 * h + e] = p;
            ls += p;
          }
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

      // O += (P_hi + P_lo) V over the warp's keys, 16 a k-step.
      const uint32_t v_addr =
          smem_addr(sV + (stage * DT_KEYS + kg * KPW) * LDV + bt_lane_off(lane, LDV));
#pragma unroll
      for (int kk = 0; kk < KPW / 16; ++kk) {
        uint32_t hi[4], lo[4];
        split_a(s, kk, hi, lo);
#pragma unroll
        for (int jp = 0; jp < NT_O / 2; ++jp) {
          mma_split(acc[2 * jp], acc[2 * jp + 1], hi, lo,
                    v_addr + (kk * 16 * LDV + jp * 16) * sizeof(bf16));
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled

    if (t != n_tiles - 1) continue;
    // The m-tile is done: the lane's share of l over its quad, then the KW
    // warps of the m-tile merge.  decode_kw picks KW > 1 only for one or
    // two m-tiles, a single round, so the ring is idle and holds the
    // merge's scratch.
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l_i[h] += __shfl_xor_sync(0xffffffffu, l_i[h], 1);
      l_i[h] += __shfl_xor_sync(0xffffffffu, l_i[h], 2);
    }
    if (KW > 1) {
      float* sM = reinterpret_cast<float*>(smem_raw);  // [DT_WARPS][16]
      float* sL = sM + DT_WARPS * 16;                   // [DT_WARPS][16]
      float* sO = sL + DT_WARPS * 16;                   // [DT_WARPS][16][DV]
      if (t4 == 0) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          sM[warp * 16 + g_row + 8 * h] = m_i[h];
          sL[warp * 16 + g_row + 8 * h] = l_i[h];
        }
      }
      __syncthreads();
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = g_row + 8 * h;
        float mx = NEG_INF;
#pragma unroll
        for (int w = 0; w < KW; ++w) mx = fmaxf(mx, sM[(mg * KW + w) * 16 + row]);
        // A warp whose keys were all masked has m = −1e30 and weight 0.
        const float f = exp2_approx((m_i[h] - mx) * sl2);
#pragma unroll
        for (int j = 0; j < NT_O; ++j) {
          acc[j][2 * h] *= f;
          acc[j][2 * h + 1] *= f;
        }
        if (kg > 0) {
#pragma unroll
          for (int j = 0; j < NT_O; ++j) {
            *reinterpret_cast<float2*>(sO + (warp * 16 + row) * DV + j * 8 + 2 * t4) =
                make_float2(acc[j][2 * h], acc[j][2 * h + 1]);
          }
        } else {
          float lsum = 0.f;
#pragma unroll
          for (int w = 0; w < KW; ++w) {
            const int i = (mg * KW + w) * 16 + row;
            lsum += exp2_approx((sM[i] - mx) * sl2) * sL[i];
          }
          m_i[h] = mx;
          l_i[h] = lsum;
        }
      }
      __syncthreads();
      if (kg == 0) {
#pragma unroll
        for (int w = 1; w < KW; ++w) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float* src = sO + ((warp + w) * 16 + g_row + 8 * h) * DV + 2 * t4;
#pragma unroll
            for (int j = 0; j < NT_O; ++j) {
              const float2 x = *reinterpret_cast<const float2*>(src + j * 8);
              acc[j][2 * h] += x.x;
              acc[j][2 * h + 1] += x.y;
            }
          }
        }
      }
    }
    if (kg != 0 || mt >= n_mt) continue;
    // Write the m-tile.  Lanes t4 and t4 ^ 1 trade halves: the even lane
    // writes 4 columns of row g_row, the odd lane the same 4 of g_row + 8.
    const bool odd = t4 & 1;
    const int row = mt * 16 + g_row + (odd ? 8 : 0);
    float* orow = a.o + (size_t)row * DV + 2 * (t4 & 2);
#pragma unroll
    for (int j = 0; j < NT_O; ++j) {
      const float x = __shfl_xor_sync(0xffffffffu, odd ? acc[j][0] : acc[j][2], 1);
      const float y = __shfl_xor_sync(0xffffffffu, odd ? acc[j][1] : acc[j][3], 1);
      const float4 w = odd ? make_float4(x, y, acc[j][2], acc[j][3])
                           : make_float4(acc[j][0], acc[j][1], x, y);
      if (row < a.rows) *reinterpret_cast<float4*>(orow + j * 8) = w;
    }
    if (t4 == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rr = mt * 16 + g_row + 8 * h;
        if (rr < a.rows) {
          a.m[rr] = m_i[h] == NEG_INF ? NEG_INF : m_i[h] * a.scale;
          a.l[rr] = l_i[h];
        }
      }
    }
  }
  cp_async_wait<0>();
}

}  // namespace tc
}  // namespace rt
