// D = rowsum(dO * O), the per-row residual of the attention backward, for
// Hopper (sm_90a).
//
// Replaces: src/repro/kernels/backward.py::_delta_kernel (the Pallas TPU
// kernel launched by delta_kernel_call).
//
// Bound on this card: bytes.  The work is one multiply-add per element read
// (2 operations per 4 bytes of bf16 input), far below the ~295 FLOP/byte
// bf16 ridge, and nothing is reused, so neither the tensor cores nor shared
// memory have a part: the kernel is as fast as it keeps HBM busy.  Rows are
// (BHq · N) runs of d elements, d a multiple of 8.
//
// Design:
// * LPR lanes a row, the least power of two that covers d in 8-element
//   vectors, held to 8..32 (d <= 64: 8, d <= 128: 16, above: 32); a warp
//   covers 32 / LPR rows a row-step.  Each lane loads eight elements of O
//   and of dO as 16-byte vectors (one each in bf16, two in f32),
//   neighbouring lanes on neighbouring addresses.  A lane whose columns lie
//   past d (d = 112: lanes 14-15 of each 16) forms no address and adds 0;
//   above d = 256 the 32 lanes loop over the columns.
// * U row-steps a warp a pass (4 in bf16: 16 rows at d = 64), unrolled.
//   Rows past the end are masked by predicate, never by an early return,
//   so every shuffle runs full-warp.  ptxas issues each row-step's loads
//   after the last one's multiplies, so a warp holds 1 KB in flight; the
//   576 blocks of the minicpm-2b headline (35 warps an SM) still hold
//   4.6 MB, more than the ~2.7 MB HBM3 needs.  Loads forced ahead of all
//   multiplies (predicated PTX), U = 2 and U = 8 measured no faster.
// * A grid-stride loop over the warps' row tiles, on no more blocks than
//   the card holds at once (the occupancy query), each warp making the same
//   number of passes, so warps stay resident and no block wave ramps up or
//   tails off.
// * log2(LPR) xor-shuffles reduce each row's segment; its first lane
//   writes the row's f32 sum.
// * O is loaded with a streaming hint (ld.global.cs): no backward kernel
//   reads it again; dO keeps the default policy, since dq and dkv read it
//   next.
#include "common.cuh"

namespace {

constexpr int DELTA_THREADS = 256;  // eight warps
constexpr int DELTA_WARPS = DELTA_THREADS / 32;

// Row-steps a warp takes a pass, U: U 16-byte vectors of each input a lane
// in bf16, the same bytes in f32.
template <typename T>
constexpr int DELTA_U = 8 / (int)sizeof(T);

// Eight elements of T as 16-byte vectors: one in bf16, two in f32.
template <typename T>
constexpr int VECS = (int)sizeof(T) / 2;

template <bool STREAM, typename T>
__device__ __forceinline__ void load_vecs(const T* p, uint4 (&v)[VECS<T>]) {
  const uint4* q = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int i = 0; i < VECS<T>; ++i) {
    if constexpr (STREAM) v[i] = __ldcs(q + i);
    else v[i] = q[i];
  }
}

__device__ __forceinline__ float dot8(const uint4 (&a)[1], const uint4 (&b)[1], float acc) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(b);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 fx = __bfloat1622float2(x[i]), fy = __bfloat1622float2(y[i]);
    acc = fmaf(fx.x, fy.x, acc);
    acc = fmaf(fx.y, fy.y, acc);
  }
  return acc;
}

__device__ __forceinline__ float dot8(const uint4 (&a)[2], const uint4 (&b)[2], float acc) {
  const float* x = reinterpret_cast<const float*>(a);
  const float* y = reinterpret_cast<const float*>(b);
#pragma unroll
  for (int i = 0; i < 8; ++i) acc = fmaf(x[i], y[i], acc);
  return acc;
}

template <typename T, int LPR, int U>
__global__ void __launch_bounds__(DELTA_THREADS)
    delta_kernel(const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ out,
                 int rows, int d) {
  constexpr int STEP = 32 / LPR;  // rows a warp covers in one row-step
  constexpr int TILE = STEP * U;  // rows a warp covers in one pass
  const int lane = threadIdx.x & 31;
  const int seg = lane / LPR, sl = lane % LPR;
  const int tiles = (rows + TILE - 1) / TILE;
  const int warps = gridDim.x * DELTA_WARPS;
  for (int tile = blockIdx.x * DELTA_WARPS + (threadIdx.x >> 5); tile < tiles; tile += warps) {
    const int row0 = tile * TILE + seg;
    float acc[U];
#pragma unroll
    for (int u = 0; u < U; ++u) acc[u] = 0.f;
    for (int c0 = 0; c0 < d; c0 += LPR * 8) {
      const int col = c0 + sl * 8;
      uint4 a[U][VECS<T>], b[U][VECS<T>];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int row = row0 + u * STEP;
        if (col < d && row < rows) {
          const size_t off = (size_t)row * d + col;
          load_vecs<true>(o + off, a[u]);
          load_vecs<false>(dout + off, b[u]);
        } else {
#pragma unroll
          for (int i = 0; i < VECS<T>; ++i) a[u][i] = b[u][i] = make_uint4(0, 0, 0, 0);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) acc[u] = dot8(a[u], b[u], acc[u]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int off = LPR / 2; off > 0; off >>= 1)
        acc[u] += __shfl_xor_sync(0xffffffffu, acc[u], off);
      const int row = row0 + u * STEP;
      if (sl == 0 && row < rows) out[row] = acc[u];
    }
  }
}

// Blocks of the kernel the whole card holds at once (0 if the query fails).
template <typename Kernel>
int resident_blocks(Kernel kernel) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, DELTA_THREADS, 0) !=
          cudaSuccess)
    return 0;
  return sms * per_sm;
}

template <typename T, int LPR>
int launch_delta(const void* o, const void* dout, void* out, int rows, int d, cudaStream_t stream) {
  constexpr int U = DELTA_U<T>;
  static const int resident = resident_blocks(delta_kernel<T, LPR, U>);
  if (resident <= 0) return (int)cudaErrorInvalidConfiguration;
  // Tiles of 32 / LPR · U rows, shared evenly: each warp makes `passes`
  // of them, on the fewest blocks that cover the rows.
  const int tiles = (rows + 32 / LPR * U - 1) / (32 / LPR * U);
  const int passes = (tiles + resident * DELTA_WARPS - 1) / (resident * DELTA_WARPS);
  const int blocks = (tiles + passes * DELTA_WARPS - 1) / (passes * DELTA_WARPS);
  delta_kernel<T, LPR, U><<<blocks, DELTA_THREADS, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), static_cast<float*>(out), rows, d);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_delta(const void* o, const void* dout, void* out, int rows, int d, cudaStream_t s) {
  if (d <= 64) return launch_delta<T, 8>(o, dout, out, rows, d, s);
  if (d <= 128) return launch_delta<T, 16>(o, dout, out, rows, d, s);
  return launch_delta<T, 32>(o, dout, out, rows, d, s);
}

}  // namespace

extern "C" int repro_delta(const void* o, const void* dout, void* out, int dtype, int rows, int d,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == rt::DTYPE_BF16) return dispatch_delta<__nv_bfloat16>(o, dout, out, rows, d, s);
  if (dtype == rt::DTYPE_F32) return dispatch_delta<float>(o, dout, out, rows, d, s);
  return (int)cudaErrorInvalidValue;
}
