// Mamba-2 chunked SSD on Hopper's tensor cores, bf16 x / b / c in, bf16 y and
// f32 state out (sm_90a).
//
// Replaces, for bf16 inputs: src/repro/kernels/ssd.py::_ssd_kernel (ssd.cu
// routes f32 to the FMA kernel ssd_kernel<float>).  Per chunk of Q steps,
// with a_cum the inclusive cumsum of the log-decays:
//   y_i = Σ_{j≤i} (c_i·b_j) e^{a_cum_i − a_cum_j} x_j + e^{a_cum_i} c_iᵀH
//   H  ← e^{a_cum_last} H + Σ_j e^{a_cum_last − a_cum_j} b_j x_jᵀ
//
// Bound on this card: bytes (≈ 2.8 FLOP a byte at zamba2-7b's shape, far
// under the ridge).  The intra-chunk product is causal attention without
// the softmax: scores S = C·Bᵀ, weights G = S ∘ L, output G·X.  So the walk
// is the flash forward's (flash_fwd_tc.cuh), with a key block of 16:
// - One CTA of 8 warps owns one (batch · head, slice of W of the P columns)
//   and walks the chunks in order.  y's and H's columns are independent
//   given C·Bᵀ, so each slice recomputes only the scores.  W is 32 where
//   that grid covers the card's SMs, else 16 (ssd_slice_width): at P = 64
//   that is 2 or 4 CTAs a head.  W = 64 (one CTA an SM) was no faster
//   than 32 at any measured shape, and 16 where 32 covers the card takes
//   more than one wave (PERF.md).
// - A warp owns one 16-row block of the chunk (⌈Q/16⌉ ≤ 8).  Warps w and
//   w + 4 share a scheduler and take blocks w and 7 − w, so the causal
//   triangle's work is even over the schedulers.  Its C fragments (A
//   operand, k = S) stay in registers for the chunk.  For each key block
//   of 16 on or below the diagonal: S on mma.sync.m16n8k16 with B's rows from ldmatrix (as
//   K in flash); the decay e^{a_cum_i − a_cum_j} (one ex2.approx) applied
//   in registers, and above the diagonal G *selected* to 0, never
//   multiplied, since the exponential overflows there under strong decays;
//   G split into bf16 hi + lo as the A operand of G·X, X through
//   ldmatrix.trans (as V in flash).  The diagonal block is peeled off the
//   walk, so the others run without the select.
// - The walk is latency-bound, so nothing in it is decided at run time
//   that need not be: the k-steps over S are a template argument (a
//   run-time count put a branch and a WARPSYNC around every k-step's
//   mma.sync, and cost a fifth of the time), each product loads all its B
//   fragments before its first mma.sync and issues the hi parts before the
//   lo parts, and 8 warps a CTA (two CTAs an SM at S ≤ 64) give each
//   scheduler 4 warps to switch between.
// - The carried state's term e^{a_cum_i} C·H is one more product a row
//   block, ahead of G·X, with H in shared memory as bf16 hi + lo (the B
//   operand, k = S).
// - The state update (B∘w)ᵀ·X takes its A operand from the chunk's B tile
//   through ldmatrix.trans, scales it per k-column by w_j in registers and
//   splits it hi + lo.  Its f32 accumulators are H itself: warp w holds
//   m-tile w of H (KS ≤ 8 of them) in registers across the chunks,
//   and after each chunk rewrites it to shared memory as hi + lo for the
//   next chunk's C·H.
// - Each hi + lo split leaves ~2^-17 of relative error where plain bf16
//   leaves ~2^-9: the CPU emulation (tests/test_torch_ssd_tc.py) puts y at
//   6.2 (G) and 2.2 (H) and the state at 8.1 (B∘w) times its allowance
//   with plain bf16 at zamba2-7b's widths, and at ≤ 0.37 and ≤ 0.015 with
//   all three split.
// - The chunk's b, c, x slice and a stream through a 2-stage cp.async
//   ring: chunk c + 1 loads while chunk c computes.  Each warp runs the
//   cumsum as a shuffle scan into its own copy of a_cum · log2 e and w, so
//   the scan needs no CTA barrier; two __syncthreads a chunk remain (tiles
//   landed; every warp done with H before it is rewritten).
//
// Ragged edges: a chunk's rows pad to a multiple of 16, the state width S
// to 64 or 128 (the k-steps KS are compile-time), and a slice may overhang
// P.  Rows past the chunk's live steps load a = 0, b = c = x = 0
// (cp.async zero-fill), so they leave the state unchanged and write no y;
// columns past S or P load as 0.  So chunk need not divide by 16 nor N by
// chunk, and S = 8 still works.  w_j
// takes a_cum_last from the last live step itself, so w = 1 there exactly.
// Copies are 16 bytes when P and S divide by 8, else 8.
//
// Shared memory: b and c, 2 stages each of Qp × (Sp + 8) bf16 (Qp and
// Sp = 16·KS the padded chunk and state width), the x slice 2 × Qp × (W + 8), H hi and
// lo Sp × (W + 8), a 2 × Qp f32, and per warp 2 × Qp f32.  At zamba2-7b's
// shape (Q = 128, S = 64) that is 113,664 bytes at W = 32: two CTAs an SM.
#pragma once

#include "common.cuh"
#include "mma_sync.cuh"

namespace rt {

// Arguments of the SSD kernels (ssd.cu and this tile).
struct SsdArgs {
  const void* x;    // (BH, N, P)
  const float* a;   // (BH, N) log-decays
  const void* b;    // (BG, N, S)
  const void* c;    // (BG, N, S)
  void* y;          // (BH, N, P), x's dtype
  float* state;     // (BH, S, P) f32, or null
  int n;
  int p;
  int s;
  int heads_per_group;
  int chunk;        // Q: a multiple of 4, at most 128
  int band;         // FMA kernel: rows of the score tile built at once
};

namespace tc {

constexpr int SSD_TC_WARPS = 8;  // a warp for each 16-row block of a chunk ≤ 128
constexpr int SSD_TC_THREADS = SSD_TC_WARPS * 32;

__host__ __device__ inline int round16(int v) { return (v + 15) & ~15; }

// Dynamic shared memory of ssd_mma_kernel<w, sp / 16> at chunk q.
__host__ __device__ inline size_t ssd_mma_smem_bytes(int q, int sp, int w) {
  const size_t qp = round16(q);
  return 2 * 2 * qp * (sp + 8) * 2 + 2 * qp * (w + 8) * 2 + 2 * sp * (w + 8) * 2 +
         2 * qp * 4 + SSD_TC_WARPS * 2 * qp * 4;
}

// The P-slice width: 32 where the grid of (batch · head, slice) still
// covers the card's SMs, else 16 (and 16 where P is).
inline int ssd_slice_width(int bh, int p, int sms) {
  return p > 16 && bh * ((p + 31) / 32) >= sms ? 32 : 16;
}

// 8 or 4 bytes global → shared through L1; zero-filled and nothing read
// when valid is false (src must still be a valid address).
template <int BYTES>
__device__ __forceinline__ void cp_async_ca(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst), "l"(src),
               "n"(BYTES), "r"(valid ? BYTES : 0)
               : "memory");
}

// The inclusive cumsum of one chunk's log-decays (sa, zero past the live
// steps), as a shuffle scan in one warp: four steps a lane.  Writes
// a_cum · log2 e and w_j = e^{a_cum_last − a_cum_j} for the chunk's qp rows
// and returns e^{a_cum_last}, a_cum_last being the last live step's value.
__device__ __forceinline__ float ssd_chunk_scan(const float* sa, int qp, int live, float* a2,
                                                float* w, int lane) {
  float acum[4];
  float run = 0.f;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int j = lane * 4 + u;
    run += j < qp ? sa[j] : 0.f;
    acum[u] = run;
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += o;
  }
  const float excl = incl - run;
#pragma unroll
  for (int u = 0; u < 4; ++u) acum[u] += excl;
  const int jl = live - 1;
  const int ul = jl & 3;
  const float mine = ul == 0 ? acum[0] : ul == 1 ? acum[1] : ul == 2 ? acum[2] : acum[3];
  const float last = __shfl_sync(0xffffffffu, mine, jl >> 2);
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int j = lane * 4 + u;
    if (j < qp) {
      a2[j] = acum[u] * LOG2E;
      w[j] = exp2_approx((last - acum[u]) * LOG2E);
    }
  }
  return exp2_approx(last * LOG2E);
}

// hi + lo of an A fragment register of bf16 pairs scaled by (w.x, w.y).
__device__ __forceinline__ void scale_split(uint32_t v, float2 w, uint32_t& hi, uint32_t& lo) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
  split_bf16(f.x * w.x, f.y * w.y, hi, lo);
}

// c[2jp], c[2jp + 1] += a · B over a warp's NT n-tiles, B's n-tile pairs
// from one ldmatrix.x4.trans each (b); every product is independent of the
// next, so they issue back to back.
template <int NT>
__device__ __forceinline__ void mma_pairs(float (&c)[NT][4], const uint32_t (&a)[4],
                                          const uint32_t (&b)[NT / 2][4]) {
#pragma unroll
  for (int jp = 0; jp < NT / 2; ++jp) {
    mma_bf16(c[2 * jp], a, b[jp][0], b[jp][1]);
    mma_bf16(c[2 * jp + 1], a, b[jp][2], b[jp][3]);
  }
}

// The NT/2 ldmatrix.x4.trans B fragments of a k-step of 16 rows at addr
// (rows of stride ld elements, n-tile pairs 16 columns apart).
template <int NT>
__device__ __forceinline__ void ldsm_b_trans(uint32_t addr, uint32_t (&b)[NT / 2][4]) {
#pragma unroll
  for (int jp = 0; jp < NT / 2; ++jp)
    ldsm_x4_trans(addr + jp * 16 * sizeof(__nv_bfloat16), b[jp][0], b[jp][1], b[jp][2],
                  b[jp][3]);
}

// W: the P-slice width; KS: k-steps of 16 over the state width S, which
// is zero-filled to 16·KS (4: S ≤ 64, two CTAs an SM; 8: S ≤ 128).
template <int W, int KS>
__global__ void __launch_bounds__(SSD_TC_THREADS, KS <= 4 ? 2 : 1) ssd_mma_kernel(SsdArgs a) {
  static_assert(W == 16 || W == 32, "a slice is 16 or 32 columns");
  using bf16 = __nv_bfloat16;
  constexpr int NT = W / 8;   // n-tiles of a warp's y and H fragments
  constexpr int LDX = W + 8;  // row stride of the x slice and of H
  constexpr int SP = 16 * KS;  // the state width, zero-filled
  constexpr int LDS = SP + 8;  // row stride of the b and c tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int Q = a.chunk, QP = round16(Q), S = a.s;
  bf16* sB = reinterpret_cast<bf16*>(smem_raw);  // [2][QP][LDS]
  bf16* sC = sB + 2 * QP * LDS;                  // [2][QP][LDS]
  bf16* sX = sC + 2 * QP * LDS;                  // [2][QP][LDX]
  bf16* sHhi = sX + 2 * QP * LDX;                // [SP][LDX]
  bf16* sHlo = sHhi + SP * LDX;                  // [SP][LDX]
  float* sA = reinterpret_cast<float*>(sHlo + SP * LDX);  // [2][QP] log-decays
  float* sA2 = sA + 2 * QP;                      // [warps][QP] a_cum · log2 e
  float* sW = sA2 + SSD_TC_WARPS * QP;           // [warps][QP] w_j

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // fragment rows g and g + 8
  const int q = lane & 3;   // fragment columns 2q, 2q + 1 of each n-tile
  const int n_slices = (a.p + W - 1) / W;
  const int bh = blockIdx.x / n_slices;
  const int p0 = (blockIdx.x - bh * n_slices) * W;
  const int bg = bh / a.heads_per_group;
  const bf16* x = static_cast<const bf16*>(a.x) + (size_t)bh * a.n * a.p;
  const float* av = a.a + (size_t)bh * a.n;
  const bf16* bp = static_cast<const bf16*>(a.b) + (size_t)bg * a.n * S;
  const bf16* cp = static_cast<const bf16*>(a.c) + (size_t)bg * a.n * S;
  bf16* y = static_cast<bf16*>(a.y) + (size_t)bh * a.n * a.p;
  const bool wide = a.p % 8 == 0 && S % 8 == 0;  // 16-byte copies, else 8
  const int vec = wide ? 8 : 4;

  auto copy = [&](bf16* dst, const bf16* src, bool ok) {
    if (wide)
      cp_async16(smem_addr(dst), src, ok);
    else
      cp_async_ca<8>(smem_addr(dst), src, ok);
  };
  // Chunk ch into ring stage st: rows past the live steps, columns past S
  // or P land as zeros, read from the tensor's first element.
  auto load_chunk = [&](int ch, int st) {
    const int t0 = ch * Q;
    const int live = min(Q, a.n - t0);
    bf16* dB = sB + st * QP * LDS;
    bf16* dC = sC + st * QP * LDS;
    bf16* dX = sX + st * QP * LDX;
    const int per_s = SP / vec, per_x = W / vec;  // copies a row
    for (int i = tid; i < QP * per_s; i += SSD_TC_THREADS) {
      const int row = i / per_s;
      const int col = (i - row * per_s) * vec;
      const bool ok = row < live && col < S;
      const size_t src = ok ? (size_t)(t0 + row) * S + col : 0;
      copy(dB + row * LDS + col, bp + src, ok);
      copy(dC + row * LDS + col, cp + src, ok);
    }
    for (int i = tid; i < QP * per_x; i += SSD_TC_THREADS) {
      const int row = i / per_x;
      const int col = (i - row * per_x) * vec;
      const bool ok = row < live && p0 + col < a.p;
      const size_t src = ok ? (size_t)(t0 + row) * a.p + p0 + col : 0;
      copy(dX + row * LDX + col, x + src, ok);
    }
    for (int i = tid; i < QP; i += SSD_TC_THREADS)
      cp_async_ca<4>(smem_addr(sA + st * QP + i), av + (i < live ? t0 + i : 0), i < live);
  };

  // This warp's row block: warps w and w + 4 share a scheduler and take
  // blocks w and 7 − w, so each scheduler's causal work is the same.  Its
  // m-tile of the carried state H (f32, W columns): rows 16·warp.
  const int rb = warp < 4 ? warp : 11 - warp;
  const bool has_rows = rb < QP / 16;
  const bool has_h = warp < KS;
  float hreg[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) hreg[j][0] = hreg[j][1] = hreg[j][2] = hreg[j][3] = 0.f;
  float* a2 = sA2 + warp * QP;
  float* wv = sW + warp * QP;
  const int n_chunks = (a.n + Q - 1) / Q;

  load_chunk(0, 0);
  cp_async_commit();
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int st = ch & 1;
    const int t0 = ch * Q;
    const int live = min(Q, a.n - t0);
    cp_async_wait<0>();
    __syncthreads();  // the chunk landed; every warp is done with the other stage
    if (ch + 1 < n_chunks) load_chunk(ch + 1, st ^ 1);
    cp_async_commit();

    const float decay = ssd_chunk_scan(sA + st * QP, QP, live, a2, wv, lane);
    __syncwarp();
    const uint32_t b_base = smem_addr(sB + st * QP * LDS + b_lane_off(lane, LDS));
    const uint32_t x_base = smem_addr(sX + st * QP * LDX + bt_lane_off(lane, LDX));

    if (has_rows && rb * 16 < live) {
      uint32_t cf[KS][4];
      const uint32_t c_base = smem_addr(sC + (st * QP + rb * 16) * LDS + a_lane_off(lane, LDS));
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        ldsm_x4(c_base + kk * 32, cf[kk][0], cf[kk][1], cf[kk][2], cf[kk][3]);
      const int r0 = rb * 16 + g;  // chunk rows r0 and r0 + 8
      const float a2r[2] = {a2[r0], a2[r0 + 8]};
      float acc[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

      if (ch > 0) {  // e^{a_cum_i} C·H, H = hi + lo
        const uint32_t h_off = bt_lane_off(lane, LDX);
        const uint32_t hi_base = smem_addr(sHhi + h_off);
        const uint32_t lo_base = smem_addr(sHlo + h_off);
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          uint32_t hb[NT / 2][4], lb[NT / 2][4];
          ldsm_b_trans<NT>(hi_base + kk * 16 * LDX * sizeof(bf16), hb);
          ldsm_b_trans<NT>(lo_base + kk * 16 * LDX * sizeof(bf16), lb);
          mma_pairs<NT>(acc, cf[kk], hb);
          mma_pairs<NT>(acc, cf[kk], lb);
        }
        const float e0 = exp2_approx(a2r[0]), e1 = exp2_approx(a2r[1]);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          acc[j][0] *= e0;
          acc[j][1] *= e0;
          acc[j][2] *= e1;
          acc[j][3] *= e1;
        }
      }

      // G·X over the key blocks on and below the diagonal; the diagonal
      // block last, the only one that selects.
      auto key_block = [&](int kb, bool diag) {
        float s[2][4] = {};
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          uint32_t b0, b1, b2, b3;
          ldsm_x4(b_base + (kb * 16 * LDS + kk * 16) * sizeof(bf16), b0, b1, b2, b3);
          mma_bf16(s[0], cf[kk], b0, b1);
          mma_bf16(s[1], cf[kk], b2, b3);
        }
        uint32_t xb[NT / 2][4];
        ldsm_b_trans<NT>(x_base + kb * 16 * LDX * sizeof(bf16), xb);
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const int j0 = kb * 16 + t * 8 + 2 * q;
          const float2 a2c = *reinterpret_cast<const float2*>(a2 + j0);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[t][e] *= exp2_approx(a2r[e >> 1] - ((e & 1) ? a2c.y : a2c.x));
            // Above the diagonal the product may be inf · 0: select.
            if (diag && j0 + (e & 1) > r0 + (e >> 1) * 8) s[t][e] = 0.f;
          }
        }
        uint32_t hi[4], lo[4];
        split_a<2>(s, 0, hi, lo);
        mma_pairs<NT>(acc, hi, xb);
        mma_pairs<NT>(acc, lo, xb);
      };
      for (int kb = 0; kb < rb; ++kb) key_block(kb, false);
      key_block(rb, true);

#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r0 + h * 8;
        if (row >= live) continue;
        bf16* yrow = y + (size_t)(t0 + row) * a.p + p0 + 2 * q;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          if (p0 + j * 8 + 2 * q < a.p)
            *reinterpret_cast<uint32_t*>(yrow + j * 8) =
                pack_bf16(acc[j][2 * h], acc[j][2 * h + 1]);
        }
      }
    }

    // H ← e^{a_cum_last} H + (B∘w)ᵀ X over the chunk's live k-steps; A is
    // the B tile through ldmatrix.trans, each k-column scaled by w_j.
    if (has_h) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) hreg[j][e] *= decay;
      const uint32_t bt_base = b_base + warp * 16 * sizeof(bf16);
      const int kb_n = (live + 15) / 16;
#pragma unroll 2
      for (int kb = 0; kb < kb_n; ++kb) {
        uint32_t r[4], xb[NT / 2][4];
        ldsm_x4_trans(bt_base + kb * 16 * LDS * sizeof(bf16), r[0], r[1], r[2], r[3]);
        ldsm_b_trans<NT>(x_base + kb * 16 * LDX * sizeof(bf16), xb);
        const float2 w_lo = *reinterpret_cast<const float2*>(wv + kb * 16 + 2 * q);
        const float2 w_hi = *reinterpret_cast<const float2*>(wv + kb * 16 + 8 + 2 * q);
        uint32_t hi[4], lo[4];
        scale_split(r[0], w_lo, hi[0], lo[0]);
        scale_split(r[1], w_lo, hi[1], lo[1]);
        scale_split(r[2], w_hi, hi[2], lo[2]);
        scale_split(r[3], w_hi, hi[3], lo[3]);
        mma_pairs<NT>(hreg, hi, xb);
        mma_pairs<NT>(hreg, lo, xb);
      }
    }

    if (ch + 1 == n_chunks) break;
    __syncthreads();  // every warp is done reading H for this chunk
    if (has_h) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int idx = (warp * 16 + g + h * 8) * LDX + j * 8 + 2 * q;
          split_bf16(hreg[j][2 * h], hreg[j][2 * h + 1], *reinterpret_cast<uint32_t*>(sHhi + idx),
                     *reinterpret_cast<uint32_t*>(sHlo + idx));
        }
      }
    }
  }

  if (a.state != nullptr && has_h) {
    float* stp = a.state + (size_t)bh * S * a.p;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = p0 + j * 8 + 2 * q;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = warp * 16 + g + h * 8;
        if (row < S && col < a.p)
          *reinterpret_cast<float2*>(stp + (size_t)row * a.p + col) =
              make_float2(hreg[j][2 * h], hreg[j][2 * h + 1]);
      }
    }
  }
}

template <int W, int KS>
int launch_ssd_mma(const SsdArgs& a, int bh, cudaStream_t stream) {
  const size_t bytes = ssd_mma_smem_bytes(a.chunk, 16 * KS, W);
  auto kern = ssd_mma_kernel<W, KS>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  kern<<<bh * ((a.p + W - 1) / W), SSD_TC_THREADS, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

// The bf16 SSD on the tensor cores, at the slice width for this grid.
inline int dispatch_ssd_mma(const SsdArgs& a, int bh, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const bool narrow = round16(a.s) <= 64;
  if (ssd_slice_width(bh, a.p, sms) == 32)
    return narrow ? launch_ssd_mma<32, 4>(a, bh, stream) : launch_ssd_mma<32, 8>(a, bh, stream);
  return narrow ? launch_ssd_mma<16, 4>(a, bh, stream) : launch_ssd_mma<16, 8>(a, bh, stream);
}

}  // namespace tc
}  // namespace rt
