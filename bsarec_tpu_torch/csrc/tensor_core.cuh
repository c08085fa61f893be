// Tensor-core building blocks for Hopper (sm_90a), warp-level (mma.sync,
// not wgmma): the products of ce_bwd_wide_tc_kernel, ce_fwd_wide_tc_kernel,
// ce_bwd_onchip_tc_kernel and ce_fwd_onchip_tc_kernel (bf16; the last two
// on this file's on-chip skeleton, at its end) and of
// ce_bwd_wide_tf32_kernel and ce_fwd_wide_tf32_kernel (fp32 in 3xTF32, the
// second half of this file) in streaming_ce.cu, and of
// rank_wide_tf32_kernel (3xTF32) in streaming_rank.cu. The bf16
// fragments are those of
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

// 16-byte cp.async.cg of src, or 16 zero bytes when !full (src is then not
// read, but must still be a valid address).
__device__ __forceinline__ void cp_async_16_zfill(void* dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(full ? 16 : 0)
               : "memory");
}

// ---- fp32 products in 3xTF32 ---------------------------------------------------
// mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 takes one 32-bit
// value a register, for lane l, g = l >> 2 and t = l & 3:
//   A (16 x 8, row-major)   a[0]: (row g, k t)      a[1]: (row g + 8, k t)
//                           a[2]: (row g, k t + 4)  a[3]: (row g + 8, k t + 4)
//   B (8 x 8, by column)    b[0]: (k t, column g)   b[1]: (k t + 4, column g)
//   C (16 x 8, fp32)        as the bf16 form's.
// The tensor core reads the top 19 bits of each operand (sign, exponent,
// 10 mantissa bits: TF32, the rest truncated) and sums in fp32. 3xTF32
// keeps fp32 accuracy: x = hi + lo with hi = x rounded to TF32 (nearest,
// ties away from zero) and lo = x - hi (exact in fp32), and a . b taken as
// lo_a . hi_b + hi_a . lo_b + hi_a . hi_b; the lo . lo term left out is
// 2^-22 of a product at most. Any permutation of k applied to A and B
// alike gives the same sum, and a permutation of A's rows or B's columns
// moves C's with it: the users pick the ones that let a lane load two
// neighbours at once.
//
// ldmatrix reads fp32 tiles too: each 16-byte row of an 8 x 8 b16 matrix is
// four fp32 values, and lane l receives (row g, fp32 column t) of it, the
// A and B fragments above for a tile stored with k along the row.
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const float* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
// The fp32 columns of a_col and b_col (lane l's row is a_row or b_row).
__device__ __forceinline__ int a_col32(int l) { return (l >> 4) << 2; }
__device__ __forceinline__ int b_col32(int l) { return ((l >> 3) & 1) << 2; }

// x (fp32 bits) into hi and lo as above. hi is cvt.rna.tf32.f32's result
// on every finite x, taken in two integer instructions: half a TF32 ulp
// added to the magnitude's bits, the 13 low bits cleared (a carry moves
// into the exponent as rounding up should). The cvt form gives the same
// bits and is slower on the H100 (tools/ablate_ce_tc.py, PERF.md).
__device__ __forceinline__ void split_tf32(uint32_t x, uint32_t& hi, uint32_t& lo) {
  hi = (x + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(__uint_as_float(x) - __uint_as_float(hi));
}

// c += a . b, one TF32 pass.
__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One pass over every i < M, j < N of c[i][j] += a[i] . b[j]: pass 0 takes
// lo . hi, pass 1 hi . lo, pass 2 hi . hi.
template <int M, int N>
__device__ __forceinline__ void mma_pass(int pass, float (&c)[M][N][4], const uint32_t (&ah)[M][4],
                                         const uint32_t (&al)[M][4], const uint32_t (&bh)[N][2],
                                         const uint32_t (&bl)[N][2]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) mma_tf32(c[i][j], pass == 0 ? al[i] : ah[i], pass == 1 ? bl[j] : bh[j]);
}

// c[i][j] += a[i] . b[j] in 3xTF32 from the split operands: the two small
// terms first, then the large one (the order of CUTLASS's
// mma_tensor_op_fast_f32.h), pass by pass, so that consecutive MMAs write
// different accumulators and none waits on the one before.
//
// Keep each c a short sum, and add the short sums in fp32, one rounding
// each: a tensor core aligns every addend of its sum to the largest, C
// included, and truncates the rest, so a sum carried through many MMAs
// loses up to an ulp of the running total to each of them, and a total
// that one large term dominates drifts.
template <int M, int N>
__device__ __forceinline__ void mma_3xtf32(float (&c)[M][N][4], const uint32_t (&ah)[M][4],
                                           const uint32_t (&al)[M][4], const uint32_t (&bh)[N][2],
                                           const uint32_t (&bl)[N][2]) {
#pragma unroll
  for (int pass = 0; pass < 3; ++pass) mma_pass(pass, c, ah, al, bh, bl);
}

// ---- the wide sweeps over S . T^T in 3xTF32 ---------------------------------------
// ce_fwd_wide_tf32_kernel (streaming_ce.cu) and rank_wide_tf32_kernel
// (streaming_rank.cu) share one geometry: one block of 256 threads per SM, a
// group of WIDE_ROWS batch rows against tiles of WIDE_COLS catalog columns,
// 8 warps as 4 x 2 warp tiles of 64 x 64; the state and table rows, as they
// are stored, WIDE_HC hidden columns a step, by cp.async through a ring of
// WIDE_STAGES slots, rows WIDE_LD floats apart (4 mod 8: the eight 16-byte
// rows of an ldmatrix matrix on distinct banks).
constexpr int WIDE_ROWS = 256;
constexpr int WIDE_COLS = 128;
constexpr int WIDE_HC = 16;
constexpr int WIDE_LD = WIDE_HC + 4;
constexpr int WIDE_STAGES = 3;

// Rows [row0, row0 + N) of a row-major [R, H] fp32 matrix, hidden columns
// [h0, h0 + W), into shared memory with row stride ld by 16-byte
// cp.async.cg, zero past R and H (H % 4 == 0: a piece lies inside H or past
// it). The NT threads of the block share the pieces.
template <int N, int W, int NT = 256>
__device__ __forceinline__ void copy_chunk_async(float* dst, int ld, const float* __restrict__ src,
                                                 int row0, int R, int H, int h0) {
  constexpr int Q = W / 4;  // pieces a row
  static_assert(N * Q % NT == 0, "whole pieces a thread");
#pragma unroll
  for (int q = 0; q < N * Q / NT; ++q) {
    const int i = threadIdx.x + NT * q, r = i / Q, c = (i % Q) * 4;
    const bool full = row0 + r < R && h0 + c < H;
    tc::cp_async_16_zfill(dst + r * ld + c, full ? src + (size_t)(row0 + r) * H + h0 + c : src, full);
  }
}

// ---- the on-chip skeleton of the bf16 form (B <= 256, H <= 64) --------------------
// ce_fwd_onchip_tc_kernel and ce_bwd_onchip_tc_kernel (streaming_ce.cu) run
// one block of 256 threads per SM over a vocab split of whole table tiles:
//   - every state row is staged once (stage_states_bf16), rounded to bf16
//     (nearest, ties to even) as it is stored, into [ONCHIP_ROWS][ONCHIP_LDB]
//     bf16, rows >= B and columns >= H zero, so every B <= 256 and H <= 64
//     runs at the padded 256 x 64 shape: four k16 steps a product;
//   - table tiles of N rows come by 16-byte cp.async.cg into a ring of
//     ONCHIP_STAGES fp32 staging slots [N][ONCHIP_LDF] (copy_table_tile,
//     rows >= V and columns >= H zero-filled), issued ONCHIP_STAGES - 1
//     tiles ahead, one commit group a tile; once its own copies of a tile
//     have landed, each thread rounds the pieces they brought in into a
//     bf16 slot [N][ONCHIP_LDB] (round_table_tile): cp.async and TMA copy
//     bytes and cannot convert, and a thread's reads of its own copies need
//     no barrier, so the rounding pass waits for no other thread and holds
//     no register across a tile (ce_fwd_wide_tc_kernel loads its fp32 rows into
//     registers a step ahead instead).
// bf16 rows are padded by 16 bytes (144 B), so the eight rows of each
// ldmatrix matrix fall on distinct banks; fp32 rows by 16 bytes (272 B), so
// a quarter warp's 16-byte reads of one row do too. Thread i of the block
// copies and rounds pieces i + 256 q, row (i + 256 q) / 16, columns
// ((i + 256 q) % 16) * 4 .. + 3.
constexpr int ONCHIP_ROWS = 256;             // batch rows held: B <= ONCHIP_ROWS
constexpr int ONCHIP_K = 64;                 // hidden columns held, padded: H <= ONCHIP_K
constexpr int ONCHIP_LDB = ONCHIP_K + 8;     // a bf16 row's stride (elements)
constexpr int ONCHIP_LDF = ONCHIP_K + 4;     // an fp32 staging row's stride (floats)
constexpr int ONCHIP_STAGES = 3;             // fp32 staging slots in the ring

// Every state row into sS [ONCHIP_ROWS][kp + 8], rounded to bf16, rows
// >= B and columns >= H zero, for kp (a multiple of 4) hidden columns:
// ONCHIP_K on the on-chip skeleton (sS [ONCHIP_ROWS][ONCHIP_LDB]), H up to
// a multiple of 64 on streaming_ce.cu's middle route.
__device__ __forceinline__ void stage_states_bf16(__nv_bfloat16* sS, const float* __restrict__ states,
                                                  int B, int H, int kp = ONCHIP_K) {
  const int q = kp / 4, ld = kp + 8;
  for (int i = threadIdx.x; i < ONCHIP_ROWS * q; i += 256) {
    const int r = i / q, c = (i % q) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < B && c < H) v = __ldg(reinterpret_cast<const float4*>(states + (size_t)r * H + c));
    *reinterpret_cast<uint2*>(sS + r * ld + c) = make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
  }
}

// Issue this thread's cp.async copies of table rows [row0, row0 + N), hidden
// columns [0, ONCHIP_K), into the fp32 staging slot dst [N][ONCHIP_LDF]:
// rows >= V and columns >= H zero-filled (H % 4 == 0: a piece lies inside H
// or past it).
template <int N>
__device__ __forceinline__ void copy_table_tile(float* dst, const float* __restrict__ table, int row0,
                                                int V, int H) {
  constexpr int Q = ONCHIP_K / 4;  // pieces a row
  static_assert(N * Q % 256 == 0, "whole pieces a thread");
#pragma unroll
  for (int q = 0; q < N * Q / 256; ++q) {
    const int i = threadIdx.x + 256 * q, r = i / Q, c = (i % Q) * 4;
    const bool full = row0 + r < V && c < H;
    cp_async_16_zfill(dst + r * ONCHIP_LDF + c, full ? table + (size_t)(row0 + r) * H + c : table, full);
  }
}

// Round the pieces of src [N][ONCHIP_LDF] that this thread's
// copy_table_tile brought in into dst [N][ONCHIP_LDB] (call it once they
// have landed; another thread reads dst only after a barrier).
template <int N>
__device__ __forceinline__ void round_table_tile(__nv_bfloat16* dst, const float* src) {
  constexpr int Q = ONCHIP_K / 4;
#pragma unroll
  for (int q = 0; q < N * Q / 256; ++q) {
    const int i = threadIdx.x + 256 * q, r = i / Q, c = (i % Q) * 4;
    const float4 v = *reinterpret_cast<const float4*>(src + r * ONCHIP_LDF + c);
    *reinterpret_cast<uint2*>(dst + r * ONCHIP_LDB + c) = make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
  }
}

}  // namespace tc
