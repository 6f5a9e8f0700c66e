// Fragment helpers shared by the tensor-core attention kernels
// (flash_fwd_tc.cuh, flash_bwd_tc.cuh, decode_tc.cuh; distr_fwd_tc.cuh
// through the first): cp.async copies into shared memory, ldmatrix operand loads and their lane offsets,
// mma.sync.m16n8k16 (bf16 in, f32 accumulate), a one-instruction exp2,
// bf16x2 packing, and the bf16 hi + lo split of an f32 A operand.
//
// In the m16n8k16 layouts, lane l holds rows l/4 and l/4 + 8 of an A or C
// fragment, and columns 2(l%4) and 2(l%4) + 1 of each 8-wide n-tile; so the
// accumulator of two adjacent n-tiles, packed to bf16, is the A operand of
// one k-step of the next product.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace rt {
namespace tc {

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Threads of a CTA whose warps own 16 rows (or keys) each of its ROWS.
template <int ROWS>
__host__ __device__ constexpr int warp_threads() {
  return ROWS / 16 * 32;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global → shared; with valid = false the destination is zero-filled
// and nothing is read (src must still be a valid address).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                        uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t& r0, uint32_t& r1,
                                              uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

// c += a · b on one m16n8k16 tile: bf16 operands, f32 accumulator.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x in one MUFU instruction; 2^(-huge) = +0.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two f32 as one bf16x2 register, lo in the low half (the lower column).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// x0, x1 ≈ hi + lo: hi = bf16(x), lo = bf16(x - hi), each as bf16x2.
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x0 - hf.x, x1 - hf.y);
}

// The hi and lo A fragments of k-step kk of a product whose A is a warp's
// 16-row accumulator c: n-tiles 2kk and 2kk + 1 are the k-step's 16 columns.
template <int NT>
__device__ __forceinline__ void split_a(const float (&c)[NT][4], int kk, uint32_t (&hi)[4],
                                        uint32_t (&lo)[4]) {
  split_bf16(c[2 * kk][0], c[2 * kk][1], hi[0], lo[0]);
  split_bf16(c[2 * kk][2], c[2 * kk][3], hi[1], lo[1]);
  split_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1], hi[2], lo[2]);
  split_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3], hi[3], lo[3]);
}

// c0, c1 += (hi + lo) · B, with B's two adjacent n-tiles from one
// ldmatrix.x4.trans at addr.
__device__ __forceinline__ void mma_split(float (&c0)[4], float (&c1)[4], const uint32_t (&hi)[4],
                                          const uint32_t (&lo)[4], uint32_t addr) {
  uint32_t b0, b1, b2, b3;
  ldsm_x4_trans(addr, b0, b1, b2, b3);
  mma_bf16(c0, hi, b0, b1);
  mma_bf16(c1, hi, b2, b3);
  mma_bf16(c0, lo, b0, b1);
  mma_bf16(c1, lo, b2, b3);
}

// Lane offsets (elements) of the ldmatrix.x4 addresses in a tile of row
// stride ld.  A: rows 0-7 / 8-15 of the warp's 16, columns +0 / +8 give
// a0..a3.  B from rows (no .trans): matrices (rows +0, cols +0), (+0, +8),
// (+8, +0), (+8, +8) give b0, b1 of two adjacent n-tiles of rows.  B with
// .trans: (rows +0, cols +0), (+8, +0), (+0, +8), (+8, +8) give b0, b1 of
// two adjacent n-tiles of columns.
__device__ __forceinline__ int a_lane_off(int lane, int ld) {
  return (lane & 15) * ld + (lane >> 4) * 8;
}
__device__ __forceinline__ int b_lane_off(int lane, int ld) {
  return ((lane >> 4) * 8 + (lane & 7)) * ld + ((lane >> 3) & 1) * 8;
}
__device__ __forceinline__ int bt_lane_off(int lane, int ld) {
  return (((lane >> 3) & 1) * 8 + (lane & 7)) * ld + (lane >> 4) * 8;
}

}  // namespace tc
}  // namespace rt
