// The on-chip skeleton shared by the streaming kernels' fast routes on
// Hopper (sm_90a), fp32: ce_fwd_onchip_kernel and ce_bwd_onchip_kernel
// (streaming_ce.cu) and rank_onchip_kernel (streaming_rank.cu).
//
// Each of them runs one block of THREADS threads per SM over a vocab
// split and computes, for every 64-column table tile of its split, the
// logits of the WHOLE batch against the tile, S [ROWS x H] . T_tile^T:
//   - every state row is staged into shared memory once per block
//     (stage_states), at row stride LD = MAX_H + 4, rows past B and
//     columns past H zero, so the products run at the padded 256 x 64
//     shape for every B <= ROWS and H <= MAX_H;
//   - table tiles come through a ring of two slots (load_tile_async): the
//     16-byte cp.async.cg copies of the next tile are issued after the
//     current tile's first barrier and land while it computes; a tile's
//     copies are one commit group, waited for in full at its top;
//   - tile_logits gives each thread an 8 x 8 block of logits, rows
//     ty + 32i and columns tx + 8j (tx = tid & 7, ty = tid >> 3), each one
//     fp32 FMA chain over h in ascending order. Each pair of 16-byte
//     shared-memory loads feeds 32 FMAs; Hopper's SM issues 128 fp32 FMAs
//     but reads 128 bytes of shared memory a clock, so a 4 x 4 tile
//     (8 FMAs a load) caps the loop near half the FMA peak.
// Rows ty + 32i and columns tx + 8j put a quarter warp's float4 reads of
// T on distinct banks and its reads of S on one address (a broadcast).
// The 8 threads of a row are 8 consecutive lanes of one warp, and warp w
// holds all 64 columns of the 32 rows 4w + {0..3} + 32i.
// Shared memory at H = 64: states 69,632 B, the table ring 34,816 B.
//
// The CE kernels' bf16-operand form runs its own kernels on this route, on
// the tensor cores (tensor_core.cuh's on-chip skeleton); round_bf16 serves
// the older sweeps' bf16 form.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace onchip {

constexpr int THREADS = 256;     // one block per SM, 8 warps
constexpr int ROWS = 256;        // batch rows held in the block: B <= ROWS
constexpr int MAX_H = 64;        // hidden columns held: H <= MAX_H
constexpr int LD = MAX_H + 4;    // row stride of the states and the table tiles
constexpr int VT = 64;           // table columns (rows of T) per tile
constexpr int STATE_FLOATS = ROWS * LD;
constexpr int RING_FLOATS = 2 * VT * LD;
static_assert(ROWS == 32 * 8 && VT == 8 * 8 && THREADS == 32 * 8,
              "8 x 8 register tiles: rows ty + 32i, columns tx + 8j");

// x rounded to the nearest bf16 (ties to even), back in fp32.
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ __forceinline__ float4 round_bf16(float4 v) {
  return make_float4(round_bf16(v.x), round_bf16(v.y), round_bf16(v.z), round_bf16(v.w));
}

// cp.async: copies from device to shared memory that bypass the registers,
// grouped by commit.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Issue the copies of table rows [j0, j0 + VT), columns < H, into dst (row
// stride LD); rows >= V are zero-filled (a source size of 0).
__device__ __forceinline__ void load_tile_async(float* dst, const float* __restrict__ table,
                                                int j0, int V, int H) {
  const int q = H / 4;
  for (int i = threadIdx.x; i < VT * q; i += THREADS) {
    const int r = i / q, c4 = i - r * q, row = j0 + r;
    const float* src = table + (size_t)min(row, V - 1) * H + 4 * c4;
    const unsigned dst_s = (unsigned)__cvta_generic_to_shared(dst + r * LD + 4 * c4);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst_s), "l"(src),
                 "r"(row < V ? 16 : 0)
                 : "memory");
  }
}

// Every state row into sS (row stride LD), rows >= B and columns >= H zero;
// the ring's columns >= H zero in both slots (the copies never write them).
__device__ __forceinline__ void stage_states(float* sS, float* sT, const float* __restrict__ states,
                                             int B, int H) {
  const int tid = threadIdx.x, q = H / 4;
  for (int i = tid; i < ROWS * (MAX_H / 4); i += THREADS) {
    const int r = i / (MAX_H / 4), c4 = i - r * (MAX_H / 4);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < B && c4 < q) v = __ldg(reinterpret_cast<const float4*>(states + (size_t)r * H) + c4);
    *reinterpret_cast<float4*>(sS + r * LD + 4 * c4) = v;
  }
  for (int i = tid; i < 2 * VT * (MAX_H - H); i += THREADS)
    sT[(i / (MAX_H - H)) * LD + H + i % (MAX_H - H)] = 0.f;
}

// acc[i][j] = <sS row ty + 32i, sTt row tx + 8j> over the MAX_H columns,
// one FMA chain in ascending h, for tx = tid & 7 and ty = tid >> 3. (The
// caller passes them: recomputed here, they cost ce_bwd_onchip_kernel 2%
// on the H100.)
__device__ __forceinline__ void tile_logits(const float* sS, const float* sTt, float acc[8][8],
                                            int tx, int ty) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int h = 0; h < MAX_H; h += 4) {
    float4 b[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) b[j] = *reinterpret_cast<const float4*>(sTt + (tx + 8 * j) * LD + h);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float4 a = *reinterpret_cast<const float4*>(sS + (ty + 32 * i) * LD + h);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float v = acc[i][j];
        v = fmaf(a.x, b[j].x, v);
        v = fmaf(a.y, b[j].y, v);
        v = fmaf(a.z, b[j].z, v);
        v = fmaf(a.w, b[j].w, v);
        acc[i][j] = v;
      }
    }
  }
}

}  // namespace onchip
