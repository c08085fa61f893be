// The middle widths' product S . T^T in 3xTF32 on Hopper's warpgroup MMAs
// (wgmma.cuh), shared by streaming_ce.cu's ce_fwd_mid_tf32_kernel and
// ce_bwd_mid_tf32_kernel and streaming_rank.cu's rank_mid_tf32_kernel: the
// state and table staging of a step and the logits of a tile.
//
// Geometry: one block of MF_THREADS = 256 threads (two warpgroups) against
// every batch row (B <= MF_ROWS = 256) and a tile of MF_COLS = 128 catalog
// columns, KC hidden columns a step. A step's slot (mf_lslot floats) holds
// the state rows as they are stored, [MF_ROWS][KC + 4] (copied by the
// kernel with tc::copy_chunk_async), then the table rows' hi and lo planes,
// canonical [MF_COLS][KC] each (wgmma.cuh), which mf_load_table brings into
// registers a step ahead and mf_store_table splits into the planes.
// mf_logits adds a step's logits to the accumulators: warpgroup w takes
// catalog columns 64 w .. 64 w + 63 and every m64 tile of batch rows below
// mt_end, m64n64k8 MMAs, a (the states) from registers by ldmatrix and
// split there, b (the table) from the planes; acc[mt][j][e] is row 64 mt +
// 16 (warp & 3) + g + 8 (e >> 1), column 64 w + 8 j + 2 t + (e & 1) of the
// tile (lane l, g = l >> 2, t = l & 3). Each MF_CHAIN k8 blocks' three
// passes are summed on the tensor cores from 0, waited for, and added to
// acc with one fp32 rounding: a tensor core truncates its sum to its
// largest addend, so no sum runs long there. Sums run in a fixed order.

#pragma once

#include <stdint.h>

#include "tensor_core.cuh"
#include "wgmma.cuh"

namespace mf {

constexpr int MF_ROWS = 256;     // batch rows a block holds: B <= MF_ROWS
constexpr int MF_THREADS = 256;  // two warpgroups
constexpr int MF_COLS = 128;  // catalog columns per tile (both kernels)
constexpr int MF_FKC = 32;    // hidden columns per logits step: the forward's
constexpr int MF_CHAIN = 2;   // the logits' k8 blocks summed on the tensor cores before an fp32 addition
// a logits slot (floats): the state rows [MF_ROWS][kc + 4], then the
// table's hi and lo planes, canonical [MF_COLS][kc] each
__host__ __device__ constexpr int mf_lslot(int kc) { return MF_ROWS * (kc + 4) + 2 * MF_COLS * kc; }
static_assert(MF_FKC % 16 == 0 && MF_CHAIN >= 1 && MF_COLS == 128 && MF_ROWS == MF_THREADS,
              "whole warp-wide groups of table pieces, whole k8 blocks; two warpgroups of m64n64");

// Piece i of this thread's 16-byte pieces of a logits step's table rows
// [MF_COLS][KC]: row r, hidden columns 4 q .. 4 q + 3. Eight neighbouring
// lanes take one piece of eight rows (distinct banks when stored into a
// canonical plane), four such groups of a warp four neighbouring pieces
// (64 contiguous bytes a row when loaded).
template <int KC>
__device__ __forceinline__ void mf_piece(int i, int& r, int& q) {
  constexpr int G = KC / 16;  // warps a row group
  const int p = threadIdx.x + MF_THREADS * i, lane = p & 31, wid = p >> 5;
  r = (wid / G) * 8 + (lane & 7);
  q = (wid % G) * 4 + (lane >> 3);
}

// fp32 x split into TF32 hi and lo (tensor_core.cuh), as uint4 planes.
__device__ __forceinline__ void split4(float4 v, uint4& hi, uint4& lo) {
  tc::split_tf32(__float_as_uint(v.x), hi.x, lo.x);
  tc::split_tf32(__float_as_uint(v.y), hi.y, lo.y);
  tc::split_tf32(__float_as_uint(v.z), hi.z, lo.z);
  tc::split_tf32(__float_as_uint(v.w), hi.w, lo.w);
}

// A logits step's table rows [c0, c0 + MF_COLS), hidden columns [h0, h0 + KC),
// zero past V and H: this thread's pieces into pre ...
template <int KC>
__device__ __forceinline__ void mf_load_table(float4 (&pre)[MF_COLS * KC / 4 / MF_THREADS],
                                              const float* __restrict__ table, int c0, int h0,
                                              int V, int H) {
#pragma unroll
  for (int i = 0; i < MF_COLS * KC / 4 / MF_THREADS; ++i) {
    int r, q;
    mf_piece<KC>(i, r, q);
    const int h = h0 + 4 * q;
    pre[i] = (c0 + r < V && h < H)
                 ? __ldg(reinterpret_cast<const float4*>(table + (size_t)(c0 + r) * H + h))
                 : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// ... and, split, into the hi and lo planes th and tl (canonical [MF_COLS][KC]).
template <int KC>
__device__ __forceinline__ void mf_store_table(const float4 (&pre)[MF_COLS * KC / 4 / MF_THREADS],
                                               float* th, float* tl) {
#pragma unroll
  for (int i = 0; i < MF_COLS * KC / 4 / MF_THREADS; ++i) {
    int r, q;
    mf_piece<KC>(i, r, q);
    uint4 hi, lo;
    split4(pre[i], hi, lo);
    const int o = wg::canonical(r, 4 * q, KC);
    *reinterpret_cast<uint4*>(th + o) = hi;
    *reinterpret_cast<uint4*>(tl + o) = lo;
  }
}

// acc[mt] += the logits of one step for the m64 tiles mt < mt_end: the
// state rows sS [MF_ROWS][KC + 4] (hidden columns of the step) against the
// table rows 64 w .. 64 w + 63 of the tile in the planes th and tl
// (canonical [MF_COLS][KC]), w this thread's warpgroup. acc[mt][j][e] is
// row 64 mt + 16 (warp & 3) + g + 8 (e >> 1), column 64 w + 8 j + 2 t +
// (e & 1). Each MF_CHAIN k8 blocks' three passes are summed on the tensor
// cores from 0, waited for, and added to acc in fp32. Waits for its MMAs.
template <int KC>
__device__ __forceinline__ void mf_logits(float (&acc)[4][8][4], const float* sS, const float* th,
                                          const float* tl, int mt_end) {
  const int lane = threadIdx.x & 31, wr = (threadIdx.x >> 5) & 3, w = threadIdx.x >> 7;
  const float* bh = th + wg::canonical(64 * w, 0, KC);
  const float* bl = tl + wg::canonical(64 * w, 0, KC);
  const float* a0 = sS + (16 * wr + tc::a_row(lane)) * (KC + 4) + tc::a_col32(lane);
  auto frag = [&](int mt, int k, uint32_t (&h)[4], uint32_t (&l)[4]) {  // rows of mt, k8 block at k
    uint32_t r[4];
    tc::ldmatrix_x4(r, a0 + 64 * mt * (KC + 4) + k);
#pragma unroll
    for (int e = 0; e < 4; ++e) tc::split_tf32(r[e], h[e], l[e]);
  };
  constexpr int CH = KC / 8 < MF_CHAIN ? KC / 8 : MF_CHAIN;
  static_assert((KC / 8) % CH == 0, "whole chains a step");
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
    if (mt >= mt_end) break;  // (block-uniform)
#pragma unroll
    for (int k0 = 0; k0 < KC; k0 += 8 * CH) {
      uint32_t ah[CH][4], al[CH][4];
#pragma unroll
      for (int c = 0; c < CH; ++c) frag(mt, k0 + 8 * c, ah[c], al[c]);
      float part[32];
      wg::fence();
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        const int kb = k0 / 8 + c;
        wg::mma_3xtf32<64>(part, ah[c], al[c], wg::desc(bh + 64 * kb, KC), wg::desc(bl + 64 * kb, KC), c);
      }
      wg::commit();
      wg::wait<0>();
      wg::fence_regs(part);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][j][e] += part[4 * j + e];
    }
  }
}

}  // namespace mf
