// D = rowsum(dO * O), the per-row residual of the attention backward, for
// Hopper (sm_90a).
//
// Replaces: src/repro/kernels/backward.py::_delta_kernel (the Pallas TPU
// kernel launched by delta_kernel_call).
//
// One warp per row: each lane loads eight consecutive elements of O and of
// dO as one 16-byte vector, multiplies in f32, and the warp reduces with
// xor-shuffles; lane 0 writes the row's f32 sum.  Rows are (BHq · N) long
// runs of d elements, d a multiple of 8.
//
// Bound on this card: bytes.  The work is one multiply-add per element read
// (2 operations per 4 bytes of bf16 input), far below the ~295 FLOP/byte
// bf16 ridge, so the kernel is only as fast as it streams O and dO.  The
// design keeps every load a full 16-byte vector, with consecutive lanes on
// consecutive addresses, and writes 4 bytes per row.
#include "common.cuh"

namespace {

constexpr int DELTA_THREADS = 256;  // eight rows per block

template <typename T>
__global__ void __launch_bounds__(DELTA_THREADS)
    delta_kernel(const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ out,
                 int rows, int d) {
  const int row = (blockIdx.x * DELTA_THREADS + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // the whole warp leaves together
  const T* orow = o + (size_t)row * d;
  const T* drow = dout + (size_t)row * d;
  float acc = 0.f;
  for (int col = lane * 8; col < d; col += 32 * 8) {
    float a[8], b[8];
    rt::load8(orow + col, a);
    rt::load8(drow + col, b);
#pragma unroll
    for (int u = 0; u < 8; ++u) acc = fmaf(a[u], b[u], acc);
  }
  acc = rt::warp_sum(acc);
  if (lane == 0) out[row] = acc;
}

template <typename T>
int launch_delta(const void* o, const void* dout, void* out, int rows, int d, cudaStream_t stream) {
  const int blocks = (rows + DELTA_THREADS / 32 - 1) / (DELTA_THREADS / 32);
  delta_kernel<T><<<blocks, DELTA_THREADS, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), static_cast<float*>(out), rows, d);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int repro_delta(const void* o, const void* dout, void* out, int dtype, int rows, int d,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == rt::DTYPE_BF16) return launch_delta<__nv_bfloat16>(o, dout, out, rows, d, s);
  if (dtype == rt::DTYPE_F32) return launch_delta<float>(o, dout, out, rows, d, s);
  return (int)cudaErrorInvalidValue;
}
