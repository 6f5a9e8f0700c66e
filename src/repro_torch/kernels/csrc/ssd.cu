// Mamba-2 chunked SSD (state-space duality) forward for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/ssd.py::_ssd_kernel (the Pallas TPU kernel
// launched by ssd_kernel_call, grid (B·H, N/chunk) with the chunk axis
// sequential and the (S × P) state in VMEM scratch).
//
// One CTA owns one (batch · head) and walks its chunks in order with the
// (S × P) f32 state resident in shared memory: the loop takes the place of
// the TPU's sequential grid axis.  Per chunk of Q ≤ 128 steps, with
// a_cum the inclusive cumsum of the log-decays:
//   scores G[i][j] = (c_i · b_j) · exp(a_cum_i − a_cum_j) for j ≤ i, else 0
//   y_i = Σ_j G[i][j] x_j + exp(a_cum_i) · c_iᵀ H
//   H  ← exp(a_cum_last) · H + Σ_j exp(a_cum_last − a_cum_j) · b_j x_jᵀ
// Head bh reads b / c group bh / heads_per_group.  The final state is
// written when asked for.
//
// Correctness by design: exp(a_cum_i − a_cum_j) overflows to inf above the
// diagonal under strong decays, so G is *selected* there (never a 0/1 mask
// times inf).  The ragged tail is masked here, not padded in device memory:
// rows past N load a = 0, b = c = x = 0, so they leave the state untouched
// and the final state is the state at N; their y is not written.
//
// bf16 inputs run on the tensor cores (ssd_tc.cuh, one CTA per head and
// slice of P); this file's kernel takes f32 inputs.
//
// Bound on this card: bytes.  At zamba2-7b's shape (S = P = 64, Q = 128)
// the work is ~2.8 FLOP per input byte, far under the ~295 FLOP/byte bf16
// ridge.  This kernel stages each chunk as f32 tiles in shared memory (b
// and c feature-major) and runs all four products as f32 FMA loops on
// 4 × 4 register tiles; with one CTA per head the CUDA-core rate and
// shared-memory traffic bound it, not the bytes.  The score tile is built
// in row bands (64 rows, 32 at S = 128) so that S = 128 fits the 227 KB of
// shared memory.
#include "ssd_tc.cuh"

namespace rt {

constexpr int SSD_THREADS = 256;
constexpr int SSD_MAX_CHUNK = 128;
constexpr size_t SSD_MAX_SMEM = 232448;

__host__ __device__ inline size_t ssd_smem_floats(int q, int p, int s, int band) {
  // sX [Q][P], sBt / sCt [S][Q + 4], sGt [Q][band], sH [S][P], sAcum / sW [Q]
  return (size_t)q * p + 2 * (size_t)s * (q + 4) + (size_t)q * band + (size_t)s * p + 2 * (size_t)q;
}

__device__ __forceinline__ void fma4x4(float (&acc)[4][4], const float4 u, const float4 v) {
  const float uu[4] = {u.x, u.y, u.z, u.w};
  const float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(uu[i], vv[j], acc[i][j]);
}

template <typename T>
__global__ void __launch_bounds__(SSD_THREADS) ssd_kernel(SsdArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int Q = a.chunk, P = a.p, S = a.s, BR = a.band;
  const int QS = Q + 4;  // row stride of the feature-major b / c tiles
  float* sX = smem;              // [Q][P]
  float* sBt = sX + Q * P;       // [S][QS]
  float* sCt = sBt + S * QS;     // [S][QS]
  float* sGt = sCt + S * QS;     // [Q][BR]  the band of G, transposed (key-major)
  float* sH = sGt + Q * BR;      // [S][P]   the carried state
  float* sAcum = sH + S * P;     // [Q]
  float* sW = sAcum + Q;         // [Q]      exp(a_cum_last − a_cum_j)

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int bg = bh / a.heads_per_group;
  const T* x = static_cast<const T*>(a.x) + (size_t)bh * a.n * P;
  const float* av = a.a + (size_t)bh * a.n;
  const T* bp = static_cast<const T*>(a.b) + (size_t)bg * a.n * S;
  const T* cp = static_cast<const T*>(a.c) + (size_t)bg * a.n * S;
  T* y = static_cast<T*>(a.y) + (size_t)bh * a.n * P;
  const int p4 = P / 4;

  for (int i = tid; i < S * P; i += SSD_THREADS) sH[i] = 0.f;
  float decay = 1.f;  // exp(a_cum_last) of the current chunk (every thread holds it)

  const int n_chunks = (a.n + Q - 1) / Q;
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int t0 = ch * Q;
    const int live = min(Q, a.n - t0);  // steps of this chunk inside the sequence
    __syncthreads();  // the previous chunk is done with the tiles and has updated sH

    for (int idx = tid; idx < Q * P; idx += SSD_THREADS) {
      sX[idx] = idx / P < live ? to_float(x[(size_t)t0 * P + idx]) : 0.f;
    }
    for (int idx = tid; idx < Q * S; idx += SSD_THREADS) {
      const int j = idx / S;
      const int col = idx - j * S;
      const bool ok = j < live;
      sBt[col * QS + j] = ok ? to_float(bp[(size_t)t0 * S + idx]) : 0.f;
      sCt[col * QS + j] = ok ? to_float(cp[(size_t)t0 * S + idx]) : 0.f;
    }
    if (tid < 32) {
      // Inclusive cumsum of the chunk's log-decays in one warp: four steps a
      // lane, then a shuffle scan of the lane totals.  Pad steps add a = 0.
      float v[4];
      float run = 0.f;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = tid * 4 + u;
        run += j < live ? av[t0 + j] : 0.f;
        v[u] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += o;
      }
      const float excl = incl - run;
      const float last = __shfl_sync(0xffffffffu, incl, 31);  // pads add 0: a_cum at the last live step
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = tid * 4 + u;
        if (j < Q) {
          sAcum[j] = excl + v[u];
          sW[j] = expf(last - (excl + v[u]));
        }
      }
    }
    __syncthreads();
    decay = expf(sAcum[Q - 1]);  // pad steps add 0: the decay over the live steps

    for (int i0 = 0; i0 < live; i0 += BR) {
      const int rows = min(BR, Q - i0);
      // (1) G for rows i0 .. i0 + rows − 1 against keys j < i0 + rows,
      //     4 × 4 tiles; tiles wholly above the diagonal are never read.
      const int ti_n = rows / 4;
      const int tj_n = (i0 + rows) / 4;
      for (int tile = tid; tile < ti_n * tj_n; tile += SSD_THREADS) {
        const int ti = tile / tj_n;
        const int j = (tile - ti * tj_n) * 4;
        const int il = ti * 4;
        const int i = i0 + il;
        if (j > i + 3) continue;
        float acc[4][4] = {};
        for (int k = 0; k < S; ++k) {
          fma4x4(acc, *reinterpret_cast<const float4*>(sCt + k * QS + i),
                 *reinterpret_cast<const float4*>(sBt + k * QS + j));
        }
        float g[4][4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int w = 0; w < 4; ++w)
            g[u][w] = (j + w <= i + u) ? acc[u][w] * expf(sAcum[i + u] - sAcum[j + w]) : 0.f;
#pragma unroll
        for (int w = 0; w < 4; ++w)
          *reinterpret_cast<float4*>(sGt + (j + w) * BR + il) =
              make_float4(g[0][w], g[1][w], g[2][w], g[3][w]);
      }
      __syncthreads();
      // (2) y for the band's live rows: G·X plus the carried state's term.
      for (int tile = tid; tile < ti_n * p4; tile += SSD_THREADS) {
        const int ti = tile / p4;
        const int pc = (tile - ti * p4) * 4;
        const int il = ti * 4;
        const int i = i0 + il;
        if (i >= live) continue;
        float acc[4][4] = {};
        float acc_h[4][4] = {};
        for (int j = 0; j < i + 4; ++j) {
          fma4x4(acc, *reinterpret_cast<const float4*>(sGt + j * BR + il),
                 *reinterpret_cast<const float4*>(sX + j * P + pc));
        }
        for (int k = 0; k < S; ++k) {
          fma4x4(acc_h, *reinterpret_cast<const float4*>(sCt + k * QS + i),
                 *reinterpret_cast<const float4*>(sH + k * P + pc));
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (i + u >= live) break;
          const float e = expf(sAcum[i + u]);
          T* yrow = y + (size_t)(t0 + i + u) * P + pc;
#pragma unroll
          for (int w = 0; w < 4; ++w) yrow[w] = from_float<T>(fmaf(e, acc_h[u][w], acc[u][w]));
        }
      }
      __syncthreads();  // the next band rewrites sGt; the state update rewrites sH
    }

    // (3) H ← exp(a_cum_last)·H + Σ_j w_j b_j x_jᵀ over the live steps.
    for (int tile = tid; tile < (S / 4) * p4; tile += SSD_THREADS) {
      const int s0 = (tile / p4) * 4;
      const int pc = (tile - (s0 / 4) * p4) * 4;
      float acc[4][4] = {};
      for (int j = 0; j < live; ++j) {
        const float wj = sW[j];
        const float4 bw = make_float4(sBt[s0 * QS + j] * wj, sBt[(s0 + 1) * QS + j] * wj,
                                      sBt[(s0 + 2) * QS + j] * wj, sBt[(s0 + 3) * QS + j] * wj);
        fma4x4(acc, bw, *reinterpret_cast<const float4*>(sX + j * P + pc));
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float4* h = reinterpret_cast<float4*>(sH + (s0 + u) * P + pc);
        const float4 old = *h;
        *h = make_float4(fmaf(decay, old.x, acc[u][0]), fmaf(decay, old.y, acc[u][1]),
                         fmaf(decay, old.z, acc[u][2]), fmaf(decay, old.w, acc[u][3]));
      }
    }
  }

  if (a.state != nullptr) {
    __syncthreads();
    float* st = a.state + (size_t)bh * S * P;
    for (int i = tid; i < S * P; i += SSD_THREADS) st[i] = sH[i];
  }
}

template <typename T>
int launch_ssd(const SsdArgs& a, int bh, size_t bytes, cudaStream_t stream) {
  auto kern = ssd_kernel<T>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  kern<<<bh, SSD_THREADS, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace rt

extern "C" int repro_ssd_fwd(const void* x, const void* a, const void* b, const void* c, void* y,
                             void* state, int dtype, int bh, int n, int p, int s,
                             int heads_per_group, int chunk, void* stream) {
  if (chunk < 4 || chunk > rt::SSD_MAX_CHUNK || chunk % 4 || p % 4 || s % 4 || p < 4 || s < 4 ||
      heads_per_group < 1)
    return (int)cudaErrorInvalidValue;
  rt::SsdArgs args;
  args.x = x;
  args.a = static_cast<const float*>(a);
  args.b = b;
  args.c = c;
  args.y = y;
  args.state = static_cast<float*>(state);
  args.n = n;
  args.p = p;
  args.s = s;
  args.heads_per_group = heads_per_group;
  args.chunk = chunk;
  args.band = 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == rt::DTYPE_BF16) return rt::tc::dispatch_ssd_mma(args, bh, st);
  if (dtype != rt::DTYPE_F32) return (int)cudaErrorInvalidValue;
  // f32: the widest score band that fits: 64 rows, else 32 (S = 128), else 4.
  int band = chunk < 64 ? chunk : 64;
  while (band > 4 && rt::ssd_smem_floats(chunk, p, s, band) * sizeof(float) > rt::SSD_MAX_SMEM)
    band = band > 32 ? 32 : band - 4;
  args.band = band;
  const size_t bytes = rt::ssd_smem_floats(chunk, p, s, band) * sizeof(float);
  if (bytes > rt::SSD_MAX_SMEM) return (int)cudaErrorInvalidValue;
  return rt::launch_ssd<float>(args, bh, bytes, st);
}
