// bf16 tensor-core building blocks for Hopper (sm_90a), warp-level
// (mma.sync, not wgmma): the products of ce_bwd_wide_tc_kernel and
// ce_fwd_wide_tc_kernel (streaming_ce.cu). Every fragment is that of
// mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32, for lane l of a
// warp, g = l >> 2 and t = l & 3:
//   A (16 x 16, row-major)  a[0]: (row g,     k 2t, 2t+1)  a[1]: (row g + 8, k 2t, 2t+1)
//                           a[2]: (row g,     k 2t+8, +9)  a[3]: (row g + 8, k 2t+8, +9)
//   B (16 x 8, by column)   b[0]: (k 2t, 2t+1, column g)   b[1]: (k 2t+8, 2t+9, column g)
//   C (16 x 8, fp32)        c[0], c[1]: (row g, columns 2t, 2t+1)
//                           c[2], c[3]: (row g + 8, columns 2t, 2t+1)
// Each 32-bit register holds two bf16 values, the lower index in the low
// half. Products of two bf16 values are exact; the sum is fp32 in the
// tensor core's own order.
//
// The fragments come from bf16 tiles in shared memory through ldmatrix,
// whose x4 form reads four 8 x 8 matrices, lanes 8i .. 8i + 7 giving the
// addresses of matrix i's eight rows (16 bytes each). A lane receives one
// register per matrix: (row g, elements 2t, 2t+1) of it as stored, or
// with .trans (elements 2t, 2t+1 of column g), the stored matrix
// transposed. The *_row and *_col helpers below give lane l's row and
// column for the fragment layouts this file's users need.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace tc {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c += a . b on the tensor cores, fp32 accumulators.
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Where lane l points ldmatrix_x4, relative to a fragment's first row and
// column in a row-major tile, for:
//   A of a [M][K] tile (rows m, k along the row): ldmatrix_x4 -> a[0..3]
__device__ __forceinline__ int a_row(int l) { return l & 15; }
__device__ __forceinline__ int a_col(int l) { return (l >> 4) << 3; }
//   B of an [N][K] tile, two n8 fragments: ldmatrix_x4 -> (b[0], b[1]) of
//   columns 0..7, then of columns 8..15; and, the same addresses, A of a
//   [K][M] tile (the product's A transposed): ldmatrix_x4_trans -> a[0..3]
__device__ __forceinline__ int b_row(int l) { return (l & 7) + ((l >> 4) << 3); }
__device__ __forceinline__ int b_col(int l) { return ((l >> 3) & 1) << 3; }
//   B of a [K][N] tile, two n8 fragments: ldmatrix_x4_trans -> the same
__device__ __forceinline__ int bt_row(int l) { return (l & 7) + (((l >> 3) & 1) << 3); }
__device__ __forceinline__ int bt_col(int l) { return (l >> 4) << 3; }

// 16-byte cp.async.cg (through L2 only) of a global source into shared memory.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

// Wait until at most N of this thread's cp.async commit groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Two fp32 values rounded to bf16 (nearest, ties to even), packed: a low.
__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}

}  // namespace tc
