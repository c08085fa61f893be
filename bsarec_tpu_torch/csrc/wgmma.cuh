// Hopper's warpgroup matrix multiply (wgmma, sm_90a) in TF32, for the fp32
// form's middle-route CE kernels in streaming_ce.cu (ce_fwd_mid_tf32_kernel,
// ce_bwd_mid_tf32_kernel): raw PTX with hand-packed descriptors, no CUTLASS.
//
// wgmma.mma_async.sync.aligned.m64nNk8.f32.tf32.tf32 is issued by the four
// warps of a warpgroup (128 threads, warp w of the group = warp & 3) and
// computes d[64 x N] (+)= a[64 x 8] . b[N x 8]^T, fp32 accumulators, the
// tensor core reading the top 19 bits (TF32) of each operand. Here a comes
// from registers and b from shared memory. For lane l, g = l >> 2, t = l & 3:
//   a (4 registers)   a[0]: (row 16 w + g, k t)      a[1]: (row 16 w + g + 8, k t)
//                     a[2]: (row 16 w + g, k t + 4)  a[3]: (row 16 w + g + 8, k t + 4)
//                     (mma.sync m16n8k8's A fragment, warp w on rows 16 w ..);
//   d (N / 2 floats)  d[4 j + e]: row 16 w + g + 8 (e >> 1), column 8 j + 2 t + (e & 1)
//                     (mma.sync's C fragment, one per n8 block j);
//   b                 K-major (k along a stored row: TF32 takes no other), no
//                     swizzle: "core matrices" of 8 rows x 4 k, each 128
//                     contiguous bytes (row r at 16 r), described by a 64-bit
//                     descriptor: start address, LBO = the bytes between the
//                     two core matrices of a k8 block (k 0-3, then k 4-7), SBO =
//                     the bytes between 8-row groups. A tile [R][K] of this
//                     kind is stored here as [R / 8][K / 4][8][4] (canonical()):
//                     LBO = 128, SBO = 32 K, and k8 block kb starts 64 kb floats
//                     after the first. (Checked on the H100 against a plain
//                     product: the other assignment of LBO and SBO is wrong.)
// The MMA runs asynchronously: wgmma_fence() before the first one after
// any register or shared-memory write it reads, commit() closes a group,
// wait<N>() waits until at most N groups are pending, and only then are
// its accumulators read and its a registers and b rows free. Shared memory
// written by ordinary stores becomes visible to it after
// fence_proxy_async() by the writing threads and a barrier.

#pragma once

#include <stdint.h>

namespace wg {

// Offset (floats) of element (r, k) of a K-major tile [R][K] (K % 4 == 0) in
// the canonical no-swizzle layout [R / 8][K / 4][8][4].
__host__ __device__ __forceinline__ int canonical(int r, int k, int K) {
  return ((r >> 3) * (K >> 2) + (k >> 2)) * 32 + (r & 7) * 4 + (k & 3);
}

// The descriptor of the k8 block that starts at p (16-byte aligned) of a
// canonical tile with K columns.
__device__ __forceinline__ uint64_t desc(const float* p, int K) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)((32 * K) >> 4) << 32);
}

__device__ __forceinline__ void fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Ordinary shared-memory stores of this thread made visible to wgmma (then a barrier).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Keep the compiler from moving accesses of these accumulators across
// the asynchronous MMAs that write them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= a . b^T, m64n64k8: d = a . b^T when scale_d is 0.
__device__ __forceinline__ void mma_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// ... m64n32k8.
__device__ __forceinline__ void mma_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void mma(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b, int scale_d) {
  static_assert(N == 64 || N == 32, "the widths this file binds");
  if constexpr (N == 64)
    mma_n64(d, a, b, scale_d);
  else
    mma_n32(d, a, b, scale_d);
}

// d (+)= a . b^T in 3xTF32 over one k8 block (tensor_core.cuh's split: a
// in registers as ah + al, b in shared memory as the hi and lo planes bh
// and bl): lo . hi, hi . lo, then hi . hi, the first with scale_d.
template <int N>
__device__ __forceinline__ void mma_3xtf32(float (&d)[N / 2], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], uint64_t bh, uint64_t bl,
                                           int scale_d) {
  mma<N>(d, al, bh, scale_d);
  mma<N>(d, ah, bl, 1);
  mma<N>(d, ah, bh, 1);
}

}  // namespace wg
