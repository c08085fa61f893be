// Streaming full-catalog softmax cross-entropy for Hopper (sm_90a): fp32
// inputs and outputs, in two forms (a template parameter of every kernel
// that reads a product operand, picked by the C entries' bf16 flag):
//   - fp32: every product in fp32;
//   - bf16-operand (the JAX package's dtype="bfloat16", pallas_ce.py:234-237,
//     303-310, 360-362, 378, 393, 397-398): the states and the table tiles
//     are rounded to bf16 before the logits, and the backward's
//     p = softmax * dloss is rounded to bf16 before both of its products;
//     every sum stays fp32 (a product of two bf16 values is exact in fp32).
//     The forward's gold logit takes rounded operands too. The one-hot
//     corrections dT[a_i] -= dloss_i * s_i and ds_i -= dloss_i * T[a_i]
//     read the unrounded fp32 states and rows (pallas_ce.py:507-514,
//     553-555). Rounding happens where an operand enters shared memory
//     (stage_rows, onchip::stage_states, onchip::round_tile) and where p is
//     stored, so the product loops are the fp32 form's. The tensor cores
//     are not used yet.
//
// Replaces the three Pallas TPU kernels of bsarec_tpu/ops/pallas_ce.py:
//   - _fwd_kernel    -> ce_fwd_partial_kernel + ce_fwd_merge_kernel:
//       per row, logZ = logsumexp(s . T^T) over the columns < n_valid and,
//       when answers are given, loss = logZ - <s, T[a]>;
//   - _gather_kernel -> gold_rows_kernel: the answers' table rows T[a]
//       (zeros where a is outside [0, V));
//   - _grads_kernel  -> ce_bwd_onchip_kernel or ce_bwd_sweep_kernel, then
//       ce_ds_reduce_kernel: with
//       p = exp(s . T^T - logZ) * dloss (0 past n_valid),
//         ds = p @ T - dloss * T[a]   and   dT = p^T @ s,  then
//         dT[a_i] -= dloss_i * s_i.
// Answers are the model's int64 ids as they are: every pass that reads one
// tests 0 <= a < n_valid itself, and a row whose answer fails it has gold 0
// and no one-hot term. The JAX package gathers T[a] apart and composes the
// gold terms outside its kernels (pallas_ce.py:553-555); here the merge
// pass and the ds-reduce pass, which visit each row once anyway, take
// them, so the training path runs no gather. gold_rows_kernel stays as the
// counterpart of _gather_kernel and the yardstick of that fusion.
// None of them writes the [B, V] logit matrix. They take any B, V and any
// H % 4 == 0 (JAX's kernels take an H that divides 128 or is a multiple of
// 128: all of it inside that).
//
// What bounds them: at B=256, V=1,000,000, H=64 the forward is 2*B*V*H ~
// 32.8 GFLOP (~0.49 ms at the H100 SXM's 67 TFLOP/s fp32 peak outside the
// tensor cores) and the backward three such products, ~98.3 GFLOP
// (~1.47 ms); the 256 MB table read (and the 256 MB dT write) take
// ~0.08 ms each at 3.35 TB/s. So both are bound by fp32 FMAs. The gather
// moves B*H floats and is bound by latency. The bf16-operand form's
// bound is its bytes (0.0765 and 0.1529 ms; its products at the bf16
// tensor rate, 989 TFLOP/s, take 0.033 and 0.099), but it runs the fp32
// form's FMA loops, so the fp32 FMAs bound it too.
//
// Design. The TPU kernels walk the catalog in one sequential grid and
// carry (max, sum) or the ds accumulator in VMEM from step to step.
// Hopper blocks run in no order, so each reduction across the catalog
// takes a second pass:
//   forward, pass 1: per vocab split, in tiles of 64 columns, the logits
//     with fp32 FMAs, columns >= n_valid masked, each tile folded into a
//     per-thread online (max, sum) after its max; the threads of a row
//     merge by shuffles in a fixed order and write one partial (m, s) per
//     (split, row). Two kernels, picked by shape in the C entry:
//     - the on-chip route, B <= 256 and H <= 64 (the training path):
//       ce_fwd_onchip_kernel on onchip_tile.cuh's skeleton, one block of
//       256 threads per SM: every state row staged once, a cp.async ring
//       of two table tiles, 8 x 8 logits a thread, one barrier a tile;
//     - elsewhere ce_fwd_partial_kernel, grid (vocab splits x batch tiles
//       of 64 rows), each block staging its 64 state rows and each table
//       tile synchronously, 4 x 4 logits a thread. Whole rows of H + 4
//       floats would give out near H = 450, so past H = 256 (the wide
//       route) it accumulates each logit tile over chunks of 64 hidden
//       columns instead, a [64, 64] states chunk and a [64, 64] table
//       chunk staged per step: 34,816 B of shared memory at any H.
//   forward, pass 2: one warp per row. logZ = M + log(sum_s s_s *
//     exp(m_s - M)), each lane taking every 32nd split and the lanes
//     merged by a fixed shuffle tree; then the gold logit <s, T[a]> from
//     coalesced float4 reads of the two rows, reduced the same way.
//   backward, pass 1: one block per vocab split, on one of three routes
//     that the C entry picks by shape before the launch:
//     - the on-chip route, B <= 256 and H <= 64 (the training path's B=256,
//       H=64): ce_bwd_onchip_kernel, one block of 256 threads per SM. What
//       the TPU kernel keeps in VMEM stays on chip for the whole sweep:
//       every state row is staged into shared memory once (rows past B and
//       columns past H zero), and each thread holds an 8 x 8 block of the
//       split's ds partial in registers, written to ds_part once at the end.
//       For each 64-column tile: the [256 x 64] logits and then p into
//       shared memory; ds += p @ T_tile into the registers; dT = p^T @ S as
//       four partials over 64-row groups, summed in group order through
//       the space p held; the one-hot term dT[a_i] -= d_i * s_i for the
//       answers inside the tile, in ascending i, so duplicate answers
//       accumulate in a fixed order; the tile's dT rows written once.
//       Every product runs 8 x 8 register tiles, so each 16-byte
//       shared-memory load feeds 16 FMAs. (The sweep route's 4 x 4 tiles
//       feed 8: Hopper's SM issues 128 fp32 FMAs but reads 128 bytes of
//       shared memory a clock, so 8 caps a loop near half the FMA peak.)
//       Table tiles come through onchip_tile.cuh's ring of two: the
//       16-byte cp.async.cg copies of tile t+1, one commit group a tile,
//       are in flight while tile t computes. Shared memory at H=64: states 69,632 B, the table
//       ring 34,816, p (then the dT partials) 73,728, logZ, dloss and
//       answers 3,072: 181,248 of the 232,448 bytes a block may use.
//     - the wide route, H > 256, where the sweep route's four [64, H + 4]
//       tiles no longer fit (217 KB at H = 256): ce_bwd_wide_kernel, two
//       blocks per SM, 106,496 B of shared memory at any H. Per tile and
//       group of up to 256 batch rows it computes p from logits
//       accumulated over 64-column chunks of H and keeps the group's p in
//       shared memory; then it walks dT's and ds's hidden dimension in
//       blocks of 64: T[tile, hb] staged, and for each 64-row chunk
//       s[chunk, hb] staged, p^T @ s into the tile's dT block in registers
//       and p @ T into the split's ds_part rows. The one-hot term goes on
//       the finished dT rows in device memory (the kernel's head says more);
//     - the sweep route, B > 256 or 64 < H <= 256, where the batch and its
//       ds do not fit beside the tiles: ce_bwd_sweep_kernel, two blocks per
//       SM.
//       For each 64-column tile it loops over the batch in 64-row chunks,
//       staging each chunk's states again: it recomputes the logits, forms
//       p in shared memory, adds p^T @ s_chunk into the tile's dT held in
//       shared memory, and adds p @ T_tile into its split's partial ds rows
//       in device memory (each element has one writer, so no atomics).
//       The one-hot term and the dT write are as on the other route.
//     Every dT row belongs to one block.
//   backward, pass 2: ds = sum of the splits' partials, in split order,
//     minus dloss_i * T[a_i][h], the product and the difference each
//     rounded once (__fmul_rn, __fsub_rn: no FMA contraction), so that ds
//     equals bit for bit the sum alone minus dloss[:, None] * T[a] taken
//     by two elementwise passes.
// Every sum is taken in a fixed order: results are deterministic.
// Shared-memory rows are padded to H + 4 floats (p's to 72), so the float4
// reads of a quarter warp, and p's scalar stores, fall on distinct banks.
// On one "NVIDIA H100 80GB HBM3, 700.00 W" at B=256, V=1,000,000, H=64
// (chip_smoke.py, bsarec_tpu_torch/tools/time_kernels.py): the on-chip
// routes' backward takes ~2.66 ms, 55% of its 1.4672 ms fp32 bound (the
// sweep route's ~3.53 ms, 41.6%), their forward ~0.945 ms, 52% of 0.4891
// ms (the partial-kernel route's ~1.33 ms, 37%); the bf16-operand form
// ~2.86 and ~1.00 ms (chip_smoke.py, in turns with the fp32 form). At
// H = 512 the wide routes take ~29.4 ms (backward, 40% of its 11.74 ms
// bound) and ~10.2 ms (forward, 38% of 3.913 ms), the bf16-operand form
// ~2% more (chip_smoke.py). No wgmma or TMA.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "onchip_tile.cuh"

using onchip::round_bf16;

namespace {

constexpr int BT = 64;            // batch rows per tile / chunk
constexpr int VT = 64;            // catalog columns per tile
constexpr int HB = 64;            // hidden columns per output block (backward)
constexpr int THREADS = 256;      // 16 x 16 threads for 4 x 4 tiles, 32 x 8 for 8 x 8
constexpr int MAX_H = 256;         // the older routes stage whole rows up to here; the wide ones past it
constexpr int HC = 64;            // hidden columns per staged chunk on the wide routes
constexpr int WLD = HC + 4;       // ... their row stride in shared memory
constexpr int PB = 256;           // batch rows whose p the wide backward holds at once
constexpr int MAX_SMEM = 232448;  // usable shared memory per block on sm_90
constexpr int OC_B = onchip::ROWS;  // the on-chip routes: B <= OC_B
constexpr int OC_H = onchip::MAX_H;  // ... and H <= OC_H
constexpr int OC_LD = onchip::LD;    // their row strides in shared memory: states, table, dT
constexpr int OC_PLD = VT + 8;       // ... and p (8 rows of a warp's stores on distinct banks)
static_assert(OC_B == THREADS && onchip::THREADS == THREADS && onchip::VT == VT,
              "the on-chip routes stage one row's scalars a thread, on onchip_tile.cuh's tiles");
constexpr int GATHER_THREADS = 256;
constexpr int REDUCE_THREADS = 256;
constexpr int MERGE_THREADS = 128;  // four rows a block, one warp each
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;  // the butterfly leaves the same value, summed in the same order, in every lane
}

__device__ __forceinline__ bool in_catalog(long long a, int n_valid) {
  return a >= 0 && a < n_valid;
}

// Copy rows [row0, row0 + n) of a row-major [R, H] matrix into shared
// memory with row stride H + 4, rounded to bf16 when BF16; rows >= R are
// zero.
template <bool BF16>
__device__ __forceinline__ void stage_rows(float* dst, const float* __restrict__ src, int row0,
                                           int R, int H, int n) {
  const int q = H / 4;
  for (int i = threadIdx.x; i < n * q; i += THREADS) {
    const int r = i / q, c4 = i - r * q, row = row0 + r;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < R) v = __ldg(reinterpret_cast<const float4*>(src + (size_t)row * H) + c4);
    if constexpr (BF16) v = round_bf16(v);
    *reinterpret_cast<float4*>(dst + r * (H + 4) + 4 * c4) = v;
  }
}

// acc[i][j] = <sS row ty*4+i, sT row tx+16*j> over the H hidden columns.
__device__ __forceinline__ void tile_logits(const float* sS, const float* sT, int H,
                                            float acc[4][4]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4, ld = H + 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 2
  for (int h = 0; h < H; h += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(sS + (ty * 4 + i) * ld + h);
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = *reinterpret_cast<const float4*>(sT + (tx + 16 * j) * ld + h);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float v = acc[i][j];
        v = fmaf(a[i].x, b[j].x, v);
        v = fmaf(a[i].y, b[j].y, v);
        v = fmaf(a[i].z, b[j].z, v);
        v = fmaf(a[i].w, b[j].w, v);
        acc[i][j] = v;
      }
  }
}

// ---- staging in hidden chunks: the wide routes (H > MAX_H) ------------------
// The older routes stage whole rows (H + 4 floats) of 64 states and 64
// table columns, so their shared memory grows with H. Past MAX_H the wide
// routes walk the hidden dimension in chunks of HC = 64 columns: a logit
// tile is accumulated chunk by chunk, each chunk's states and table
// columns staged beside each other, so shared memory does not depend on H.
// Each logit is still one FMA chain over h in ascending order.

// Copy columns [h0, h0 + hc) of rows [row0, row0 + n) of a row-major
// [R, H] matrix into shared memory with row stride WLD, rounded to bf16
// when BF16; rows >= R are zero.
template <bool BF16>
__device__ __forceinline__ void stage_chunk(float* dst, const float* __restrict__ src, int row0,
                                            int R, int H, int h0, int hc, int n) {
  const int q = hc / 4;
  for (int i = threadIdx.x; i < n * q; i += THREADS) {
    const int r = i / q, c4 = i - r * q, row = row0 + r;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < R) v = __ldg(reinterpret_cast<const float4*>(src + (size_t)row * H + h0) + c4);
    if constexpr (BF16) v = round_bf16(v);
    *reinterpret_cast<float4*>(dst + r * WLD + 4 * c4) = v;
  }
}

// acc[i][j] += <sS row ty*4+i, sT row tx+16*j> over a chunk's hc columns
// (row stride WLD), continuing each chain in ascending h.
__device__ __forceinline__ void chunk_logits(const float* sS, const float* sT, int hc,
                                             float acc[4][4]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll 2
  for (int h = 0; h < hc; h += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(sS + (ty * 4 + i) * WLD + h);
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = *reinterpret_cast<const float4*>(sT + (tx + 16 * j) * WLD + h);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float v = acc[i][j];
        v = fmaf(a[i].x, b[j].x, v);
        v = fmaf(a[i].y, b[j].y, v);
        v = fmaf(a[i].z, b[j].z, v);
        v = fmaf(a[i].w, b[j].w, v);
        acc[i][j] = v;
      }
  }
}

// The logits of 64 state rows from row0 against the 64 table columns from
// j0: acc[i][j] for rows ty*4+i and columns tx+16j, over every chunk of H.
// Starts and ends with a barrier (sS and sT are free afterwards).
template <bool BF16>
__device__ __forceinline__ void wide_logits(float* sS, float* sT, const float* __restrict__ states,
                                            const float* __restrict__ table, int row0, int B,
                                            int j0, int V, int H, float acc[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int h0 = 0; h0 < H; h0 += HC) {
    const int hc = min(HC, H - h0);  // H % 4 == 0, so hc % 4 == 0
    __syncthreads();                 // earlier readers of sS and sT are done
    stage_chunk<BF16>(sS, states, row0, B, H, h0, hc, BT);
    stage_chunk<BF16>(sT, table, j0, V, H, h0, hc, VT);
    __syncthreads();
    chunk_logits(sS, sT, hc, acc);
  }
  __syncthreads();
}

// The forward's pass 1 off the on-chip route. WIDE (the wide route,
// H > MAX_H): each tile's logits from wide_logits, the hidden dimension
// staged in chunks, 34,816 B of shared memory at any H; otherwise the 64
// state rows staged once and each table tile whole.
template <bool BF16, bool WIDE>
__global__ void __launch_bounds__(THREADS, 2)
ce_fwd_partial_kernel(const float* __restrict__ states, const float* __restrict__ table, int B,
                      int V, int H, int n_valid, int tiles_per_split,
                      float* __restrict__ part_m, float* __restrict__ part_s) {
  extern __shared__ __align__(16) float smem[];
  const int ld = WIDE ? WLD : H + 4;
  float* sS = smem;           // [BT][ld] states (a chunk of their columns if WIDE)
  float* sT = sS + BT * ld;   // [VT][ld] table tile (a chunk of it if WIDE)
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int split = blockIdx.x, row0 = blockIdx.y * BT;
  const int n_tiles = (V + VT - 1) / VT;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(t_begin + tiles_per_split, n_tiles);

  if constexpr (!WIDE) stage_rows<BF16>(sS, states, row0, B, H, BT);
  float m[4], s[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    s[i] = 0.f;
  }
  for (int t = t_begin; t < t_end; ++t) {
    const int j0 = t * VT;
    float acc[4][4];
    if constexpr (WIDE) {
      wide_logits<BF16>(sS, sT, states, table, row0, B, j0, V, H, acc);
    } else {
      __syncthreads();  // earlier readers of sT are done
      stage_rows<BF16>(sT, table, j0, V, H, VT);
      __syncthreads();
      tile_logits(sS, sT, H, acc);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j0 + tx + 16 * j >= n_valid) acc[i][j] = -INFINITY;
        tmax = fmaxf(tmax, acc[i][j]);
      }
      if (tmax > -INFINITY) {
        if (tmax > m[i]) {
          s[i] *= expf(m[i] - tmax);  // exp(-inf) = 0 on the row's first column
          m[i] = tmax;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i] += expf(acc[i][j] - m[i]);
      }
    }
  }
  // the 16 threads of a row are lanes of one half warp: merge their (m, s)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const float om = __shfl_xor_sync(FULL, m[i], off);
      const float os = __shfl_xor_sync(FULL, s[i], off);
      const float mm = fmaxf(m[i], om);
      if (mm > -INFINITY) {
        s[i] = s[i] * expf(m[i] - mm) + os * expf(om - mm);
        m[i] = mm;
      }
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + ty * 4 + i;
      if (row < B) {
        part_m[(size_t)split * B + row] = m[i];
        part_s[(size_t)split * B + row] = s[i];
      }
    }
  }
}

// The forward's on-chip route (B <= OC_B, H <= OC_H): one block per SM
// walks its split in tiles of VT columns on onchip_tile.cuh's skeleton
// (every state row staged once, the table ring of two, 8 x 8 logits a
// thread). Each thread keeps an online (max, sum) for each of its 8 rows:
// per tile it masks the columns >= n_valid, takes its 8 columns' max, and
// rescales its sum at most once. The 8 lanes of a row then merge in a
// fixed order (offsets 1, 2, 4) and lane tx = 0 writes one (m, s) per
// (split, row). No value goes through shared memory, so the ring's
// barrier is the tile's only one.
template <bool BF16>
__global__ void __launch_bounds__(THREADS, 1)
ce_fwd_onchip_kernel(const float* __restrict__ states, const float* __restrict__ table, int B,
                     int V, int H, int n_valid, int tiles_per_split,
                     float* __restrict__ part_m, float* __restrict__ part_s) {
  extern __shared__ __align__(16) float smem[];
  float* sS = smem;                     // [OC_B][OC_LD] every state row
  float* sT = sS + onchip::STATE_FLOATS;  // [2][VT][OC_LD] table tiles, a ring of two
  const int tx = threadIdx.x & 7, ty = threadIdx.x >> 3;
  const int split = blockIdx.x;
  const int n_tiles = (V + VT - 1) / VT;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(t_begin + tiles_per_split, n_tiles);

  onchip::stage_states<BF16>(sS, sT, states, B, H);
  float m[8], s[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = -INFINITY;
    s[i] = 0.f;
  }
  onchip::load_tile_async(sT, table, t_begin * VT, V, H);
  onchip::cp_async_commit();
  for (int t = t_begin; t < t_end; ++t) {
    const int j0 = t * VT;
    onchip::cp_async_wait_all();  // this thread's copies of tile t have landed
    if constexpr (BF16) onchip::round_tile(sT + ((t - t_begin) & 1) * VT * OC_LD, H);
    __syncthreads();              // everyone's have; every reader of the other slot is done
    if (t + 1 < t_end)
      onchip::load_tile_async(sT + ((t + 1 - t_begin) & 1) * VT * OC_LD, table, j0 + VT, V, H);
    onchip::cp_async_commit();
    float acc[8][8];
    onchip::tile_logits(sS, sT + ((t - t_begin) & 1) * VT * OC_LD, acc, tx, ty);
    if (j0 + VT > n_valid) {  // the tile reaches past the valid columns
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (j0 + tx + 8 * j >= n_valid)
#pragma unroll
          for (int i = 0; i < 8; ++i) acc[i][j] = -INFINITY;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float tmax = acc[i][0];
#pragma unroll
      for (int j = 1; j < 8; ++j) tmax = fmaxf(tmax, acc[i][j]);
      if (tmax > -INFINITY) {
        if (tmax > m[i]) {
          s[i] *= expf(m[i] - tmax);  // exp(-inf) = 0 on the row's first column
          m[i] = tmax;
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i] += expf(acc[i][j] - m[i]);
      }
    }
  }
  // the 8 threads of a row are 8 consecutive lanes: merge their (m, s)
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int off = 1; off < 8; off <<= 1) {
      const float om = __shfl_xor_sync(FULL, m[i], off);
      const float os = __shfl_xor_sync(FULL, s[i], off);
      const float mm = fmaxf(m[i], om);
      if (mm > -INFINITY) {
        s[i] = s[i] * expf(m[i] - mm) + os * expf(om - mm);
        m[i] = mm;
      }
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = ty + 32 * i;
      if (row < B) {
        part_m[(size_t)split * B + row] = m[i];
        part_s[(size_t)split * B + row] = s[i];
      }
    }
  }
}

// One warp per row: logz[row] from the splits' partials and, when answers
// is not null, loss[row] = logz[row] - <states[row], table[answers[row]]>
// (gold 0 for an answer outside [0, n_valid)), of bf16-rounded operands
// when BF16.
template <bool BF16>
__global__ void __launch_bounds__(MERGE_THREADS)
ce_fwd_merge_kernel(const float* __restrict__ part_m, const float* __restrict__ part_s,
                    const float* __restrict__ states, const float* __restrict__ table,
                    const long long* __restrict__ answers, int B, int H, int n_valid,
                    int n_splits, float* __restrict__ logz, float* __restrict__ loss) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (MERGE_THREADS / 32) + (threadIdx.x >> 5);
  if (row >= B) return;  // the whole warp leaves together
  float mm = -INFINITY;
  for (int s = lane; s < n_splits; s += 32) mm = fmaxf(mm, part_m[(size_t)s * B + row]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) mm = fmaxf(mm, __shfl_xor_sync(FULL, mm, off));
  float z = -INFINITY;  // no valid column
  if (mm > -INFINITY) {
    float total = 0.f;
    for (int s = lane; s < n_splits; s += 32) {
      const float ms = part_m[(size_t)s * B + row];
      if (ms > -INFINITY) total += part_s[(size_t)s * B + row] * expf(ms - mm);
    }
    z = mm + logf(warp_sum(total));
  }
  if (lane == 0) logz[row] = z;
  if (answers == nullptr) return;
  const long long a = answers[row];
  float gold = 0.f;
  if (in_catalog(a, n_valid)) {  // the same for every lane of the warp
    const float4* s4 = reinterpret_cast<const float4*>(states + (size_t)row * H);
    const float4* t4 = reinterpret_cast<const float4*>(table + (size_t)a * H);
    for (int c4 = lane; c4 < H / 4; c4 += 32) {
      float4 x = __ldg(s4 + c4), y = __ldg(t4 + c4);
      if constexpr (BF16) {
        x = round_bf16(x);
        y = round_bf16(y);
      }
      gold = fmaf(x.x, y.x, gold);
      gold = fmaf(x.y, y.y, gold);
      gold = fmaf(x.z, y.z, gold);
      gold = fmaf(x.w, y.w, gold);
    }
    gold = warp_sum(gold);
  }
  if (lane == 0) loss[row] = z - gold;
}

__global__ void __launch_bounds__(GATHER_THREADS)
gold_rows_kernel(const float* __restrict__ table, const int32_t* __restrict__ answers, int B,
                 int V, int H, float* __restrict__ out) {
  const int q = H / 4;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= B * q) return;
  const int i = idx / q, c4 = idx - i * q;
  const int a = answers[i];
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (a >= 0 && a < V) v = __ldg(reinterpret_cast<const float4*>(table + (size_t)a * H) + c4);
  reinterpret_cast<float4*>(out + (size_t)i * H)[c4] = v;
}

template <bool BF16>
__global__ void __launch_bounds__(THREADS, 2)
ce_bwd_sweep_kernel(const float* __restrict__ states, const float* __restrict__ table,
                    const long long* __restrict__ answers, const float* __restrict__ logz,
                    const float* __restrict__ dloss, int B, int V, int H, int n_valid,
                    int tiles_per_split, float* __restrict__ ds_part,
                    float* __restrict__ dtable) {
  extern __shared__ __align__(16) float smem[];
  const int ld = H + 4, pld = VT + 4;
  float* sS = smem;             // [BT][ld]  states chunk
  float* sT = sS + BT * ld;     // [VT][ld]  table tile
  float* sG = sT + VT * ld;     // [VT][ld]  the tile's dT
  float* sP = sG + VT * ld;     // [BT][pld] p = softmax * dloss
  float* sZ = sP + BT * pld;    // [BT]      logZ
  float* sD = sZ + BT;          // [BT]      dloss
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int split = blockIdx.x;
  const int n_tiles = (V + VT - 1) / VT;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(t_begin + tiles_per_split, n_tiles);
  const int n_chunks = (B + BT - 1) / BT;

  for (int t = t_begin; t < t_end; ++t) {
    const int j0 = t * VT;
    __syncthreads();  // earlier readers of sT and sG are done
    stage_rows<BF16>(sT, table, j0, V, H, VT);
    for (int i = tid; i < VT * ld; i += THREADS) sG[i] = 0.f;

    for (int chunk = 0; chunk < n_chunks; ++chunk) {
      const int row0 = chunk * BT;
      __syncthreads();  // earlier readers of sS and sP are done
      stage_rows<BF16>(sS, states, row0, B, H, BT);
      if (tid < BT) {
        const int row = row0 + tid;
        sZ[tid] = row < B ? logz[row] : 0.f;
        sD[tid] = row < B ? dloss[row] : 0.f;
      }
      __syncthreads();
      float acc[4][4];
      tile_logits(sS, sT, H, acc);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty * 4 + i;
        const bool row_ok = row0 + r < B;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j;
          float p = (row_ok && j0 + c < n_valid) ? expf(acc[i][j] - sZ[r]) * sD[r] : 0.f;
          if constexpr (BF16) p = round_bf16(p);
          sP[r * pld + c] = p;
        }
      }
      __syncthreads();

      for (int hb = 0; hb < H; hb += HB) {
        const int h = hb + tx * 4;
        if (h >= H) continue;  // H % 4 == 0, so h < H means h + 3 < H
        // the tile's dT rows ty*4 .. ty*4+3 += p^T @ s_chunk
        float g[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int k = 0; k < 4; ++k) g[i][k] = 0.f;
#pragma unroll 4
        for (int r = 0; r < BT; ++r) {
          const float4 p4 = *reinterpret_cast<const float4*>(sP + r * pld + ty * 4);
          const float4 s4 = *reinterpret_cast<const float4*>(sS + r * ld + h);
          const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            g[i][0] = fmaf(pv[i], s4.x, g[i][0]);
            g[i][1] = fmaf(pv[i], s4.y, g[i][1]);
            g[i][2] = fmaf(pv[i], s4.z, g[i][2]);
            g[i][3] = fmaf(pv[i], s4.w, g[i][3]);
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float4* dst = reinterpret_cast<float4*>(sG + (ty * 4 + i) * ld + h);
          float4 v = *dst;
          v.x += g[i][0];
          v.y += g[i][1];
          v.z += g[i][2];
          v.w += g[i][3];
          *dst = v;
        }
        // this split's ds rows row0 + ty*4 .. +3 += p @ T_tile
        float e[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int k = 0; k < 4; ++k) e[i][k] = 0.f;
#pragma unroll 2
        for (int c = 0; c < VT; c += 4) {
          float4 tc[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) tc[k] = *reinterpret_cast<const float4*>(sT + (c + k) * ld + h);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float4 p4 = *reinterpret_cast<const float4*>(sP + (ty * 4 + i) * pld + c);
            const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              e[i][0] = fmaf(pv[k], tc[k].x, e[i][0]);
              e[i][1] = fmaf(pv[k], tc[k].y, e[i][1]);
              e[i][2] = fmaf(pv[k], tc[k].z, e[i][2]);
              e[i][3] = fmaf(pv[k], tc[k].w, e[i][3]);
            }
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = row0 + ty * 4 + i;
          if (row >= B) continue;
          float4* dst = reinterpret_cast<float4*>(ds_part + ((size_t)split * B + row) * H + h);
          float4 v = make_float4(e[i][0], e[i][1], e[i][2], e[i][3]);
          if (t != t_begin) {  // the split's first tile writes, later tiles add
            const float4 o = *dst;
            v.x += o.x;
            v.y += o.y;
            v.z += o.z;
            v.w += o.w;
          }
          *dst = v;
        }
      }
    }
    // one-hot term for the answers in [0, n_valid) that fall in this tile,
    // in ascending answer order: duplicates accumulate in a fixed order,
    // and each (row, h) element has one writer. Most tiles hold no answer
    // and skip the serial loop after one vote.
    int hit = 0;
    for (int i = tid; i < B; i += THREADS) {
      const long long a = __ldg(answers + i);
      hit |= in_catalog(a, n_valid) && a >= j0 && a < j0 + VT;
    }
    if (__syncthreads_or(hit)) {  // the vote is also the barrier after sG is complete
      for (int h = tid; h < H; h += THREADS) {
        for (int i = 0; i < B; ++i) {
          const long long a = __ldg(answers + i);
          if (in_catalog(a, n_valid) && a >= j0 && a < j0 + VT)
            sG[(int)(a - j0) * ld + h] -= __ldg(dloss + i) * __ldg(states + (size_t)i * H + h);
        }
      }
      __syncthreads();
    }

    const int q = H / 4;
    for (int i = tid; i < VT * q; i += THREADS) {
      const int c = i / q, c4 = i - c * q, col = j0 + c;
      if (col < V)
        reinterpret_cast<float4*>(dtable + (size_t)col * H)[c4] =
            *reinterpret_cast<const float4*>(sG + c * ld + 4 * c4);
    }
  }
}

// The on-chip route (B <= OC_B, H <= OC_H). One block per SM walks its
// split of the catalog in tiles of VT columns, the next tile's cp.async
// copies in flight while a tile computes. The block holds every state row
// for the whole sweep (staged once), and each thread holds an 8 x 8 block
// of the split's ds partial in registers, written to ds_part once at the
// end. Per tile, with the 256 rows x 64 columns of the tile:
//   logits [256 x 64] = S @ T^T    8 x 8 a thread (rows ty + 32i, columns tx + 8j)
//   p                             to shared memory, 0 past n_valid and B
//   ds [256 x 64] += p @ T         8 x 8 a thread (rows ty + 32i, h tx*4 and 32 + tx*4)
//   dT [64 x 64] = p^T @ S         split over four row groups of 64, 8 x 8 a thread,
//                                  the four partials summed in group order
// Each product reads two 16-byte values from shared memory for every 32 FMAs
// (16 FMAs per load). Rows and columns past B and H are zero in shared
// memory, so the products run at the padded 256 x 64 shape.
template <bool BF16>
__global__ void __launch_bounds__(THREADS, 1)
ce_bwd_onchip_kernel(const float* __restrict__ states, const float* __restrict__ table,
                     const long long* __restrict__ answers, const float* __restrict__ logz,
                     const float* __restrict__ dloss, int B, int V, int H, int n_valid,
                     int tiles_per_split, float* __restrict__ ds_part,
                     float* __restrict__ dtable) {
  extern __shared__ __align__(16) float smem[];
  float* sS = smem;                  // [OC_B][OC_LD] every state row
  float* sT = sS + OC_B * OC_LD;     // [2][VT][OC_LD] table tiles, a ring of two
  float* sP = sT + 2 * VT * OC_LD;   // [OC_B][OC_PLD] p; then the four dT partials [4][VT][OC_LD]
  float* sZ = sP + OC_B * OC_PLD;    // [OC_B] logZ
  float* sD = sZ + OC_B;             // [OC_B] dloss
  int* sA = reinterpret_cast<int*>(sD + OC_B);  // [OC_B] the answer, -1 outside [0, n_valid)
  const int tid = threadIdx.x, tx = tid & 7, ty = tid >> 3;
  const int grp = tid >> 6, hx = tid & 7, cy = (tid & 63) >> 3;  // the dT product's mapping
  const int split = blockIdx.x;
  const int n_tiles = (V + VT - 1) / VT;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(t_begin + tiles_per_split, n_tiles);
  const int q = H / 4;

  onchip::stage_states<BF16>(sS, sT, states, B, H);
  {
    const bool ok = tid < B;
    sZ[tid] = ok ? logz[tid] : 0.f;
    sD[tid] = ok ? dloss[tid] : 0.f;
    const long long a = ok ? answers[tid] : -1;
    sA[tid] = in_catalog(a, n_valid) ? (int)a : -1;
  }

  float ds[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int k = 0; k < 8; ++k) ds[i][k] = 0.f;

  onchip::load_tile_async(sT, table, t_begin * VT, V, H);
  onchip::cp_async_commit();
  for (int t = t_begin; t < t_end; ++t) {
    const int j0 = t * VT;
    onchip::cp_async_wait_all();  // this thread's copies of tile t have landed
    if constexpr (BF16) onchip::round_tile(sT + ((t - t_begin) & 1) * VT * OC_LD, H);
    __syncthreads();              // everyone's have; earlier readers of sP are done
    const float* sTt = sT + ((t - t_begin) & 1) * VT * OC_LD;

    // logits and p
    {
      float acc[8][8];
      onchip::tile_logits(sS, sTt, acc, tx, ty);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = ty + 32 * i;
        const bool row_ok = r < B;
        const float z = sZ[r], d = sD[r];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = tx + 8 * j;
          float p = (row_ok && j0 + c < n_valid) ? expf(acc[i][j] - z) * d : 0.f;
          if constexpr (BF16) p = round_bf16(p);
          sP[r * OC_PLD + c] = p;
        }
      }
    }
    // does any answer fall in this tile? (the vote is also the barrier after p)
    const int a_mine = sA[tid];
    const bool hit = __syncthreads_or(a_mine >= j0 && a_mine < j0 + VT);
    // the next tile loads into the other slot, last read by the tile
    // before's products, while this tile's products run. (Issued before
    // the logits instead, with a wait that left one group in flight, the
    // kernel ran 0.12 ms slower on the H100 at B=256, V=1M, H=64.)
    if (t + 1 < t_end)
      onchip::load_tile_async(sT + ((t + 1 - t_begin) & 1) * VT * OC_LD, table, j0 + VT, V, H);
    onchip::cp_async_commit();

    // ds += p @ T_tile
#pragma unroll 2
    for (int c = 0; c < VT; c += 4) {
      float4 t0[4], t1[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        t0[k] = *reinterpret_cast<const float4*>(sTt + (c + k) * OC_LD + tx * 4);
        t1[k] = *reinterpret_cast<const float4*>(sTt + (c + k) * OC_LD + 32 + tx * 4);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 p4 = *reinterpret_cast<const float4*>(sP + (ty + 32 * i) * OC_PLD + c);
        const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          ds[i][0] = fmaf(pv[k], t0[k].x, ds[i][0]);
          ds[i][1] = fmaf(pv[k], t0[k].y, ds[i][1]);
          ds[i][2] = fmaf(pv[k], t0[k].z, ds[i][2]);
          ds[i][3] = fmaf(pv[k], t0[k].w, ds[i][3]);
          ds[i][4] = fmaf(pv[k], t1[k].x, ds[i][4]);
          ds[i][5] = fmaf(pv[k], t1[k].y, ds[i][5]);
          ds[i][6] = fmaf(pv[k], t1[k].z, ds[i][6]);
          ds[i][7] = fmaf(pv[k], t1[k].w, ds[i][7]);
        }
      }
    }

    // this row group's dT partial: rows c = cy*4 + k and 32 + cy*4 + k,
    // columns h = hx*4 + k and 32 + hx*4 + k, summed over its 64 batch rows
    float g[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int k = 0; k < 8; ++k) g[i][k] = 0.f;
#pragma unroll 2
    for (int r = grp * 64; r < grp * 64 + 64; ++r) {
      const float4 p0 = *reinterpret_cast<const float4*>(sP + r * OC_PLD + cy * 4);
      const float4 p1 = *reinterpret_cast<const float4*>(sP + r * OC_PLD + 32 + cy * 4);
      const float4 s0 = *reinterpret_cast<const float4*>(sS + r * OC_LD + hx * 4);
      const float4 s1 = *reinterpret_cast<const float4*>(sS + r * OC_LD + 32 + hx * 4);
      const float pv[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
      const float sv[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int k = 0; k < 8; ++k) g[i][k] = fmaf(pv[i], sv[k], g[i][k]);
    }
    __syncthreads();  // every reader of p is done: its space takes the partials
    float* part = sP + grp * VT * OC_LD;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float* row = part + ((i & 4) * 8 + cy * 4 + (i & 3)) * OC_LD;
      *reinterpret_cast<float4*>(row + hx * 4) = make_float4(g[i][0], g[i][1], g[i][2], g[i][3]);
      *reinterpret_cast<float4*>(row + 32 + hx * 4) = make_float4(g[i][4], g[i][5], g[i][6], g[i][7]);
    }
    __syncthreads();

    // dT tile = the four partials in group order; then, for the answers
    // that fall in the tile, the one-hot term in ascending i (duplicate
    // answers accumulate in a fixed order); each dT row has one writer
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int f = tid + THREADS * k, c = f >> 4, h = (f & 15) * 4;
      const float* e = sP + c * OC_LD + h;
      float4 v = *reinterpret_cast<const float4*>(e);
#pragma unroll
      for (int gi = 1; gi < 4; ++gi) {
        const float4 o = *reinterpret_cast<const float4*>(e + gi * VT * OC_LD);
        v.x += o.x;
        v.y += o.y;
        v.z += o.z;
        v.w += o.w;
      }
      if (hit)
        *reinterpret_cast<float4*>(sP + c * OC_LD + h) = v;
      else if (j0 + c < V && h < H)
        *reinterpret_cast<float4*>(dtable + (size_t)(j0 + c) * H + h) = v;
    }
    if (hit) {  // rare: at most B of the catalog's tiles
      __syncthreads();
      // the one-hot term takes the unrounded states: in the bf16 form sS
      // holds rounded ones, so it reads device memory
      for (int h = tid; h < H; h += THREADS)
        for (int i = 0; i < B; ++i) {
          const int a = sA[i];
          if (a >= j0 && a < j0 + VT)
            sP[(a - j0) * OC_LD + h] -=
                sD[i] * (BF16 ? __ldg(states + (size_t)i * H + h) : sS[i * OC_LD + h]);
        }
      __syncthreads();
      for (int i = tid; i < VT * q; i += THREADS) {
        const int c = i / q, c4 = i - c * q;
        if (j0 + c < V)
          reinterpret_cast<float4*>(dtable + (size_t)(j0 + c) * H)[c4] =
              *reinterpret_cast<const float4*>(sP + c * OC_LD + 4 * c4);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = ty + 32 * i;
    if (r >= B) continue;
    float* dst = ds_part + ((size_t)split * B + r) * H;
    if (tx * 4 < H)
      *reinterpret_cast<float4*>(dst + tx * 4) = make_float4(ds[i][0], ds[i][1], ds[i][2], ds[i][3]);
    if (32 + tx * 4 < H)
      *reinterpret_cast<float4*>(dst + 32 + tx * 4) = make_float4(ds[i][4], ds[i][5], ds[i][6], ds[i][7]);
  }
}

// The backward's pass 1 on the wide route: one block per vocab split, as
// ce_bwd_sweep_kernel, with the hidden dimension walked in chunks so that
// no [64, H] tile (the sweep route's dT tile alone is 132 KB at H = 512)
// is held. For each 64-column tile, and each group of up to PB = 256 batch
// rows (one group for B <= 256):
//   1. p for the group's rows, 64 rows at a time: wide_logits, then
//      p = exp(logit - logZ) * dloss (0 past n_valid and B) into sP,
//      rounded to bf16 in the bf16 form. p is kept, not recomputed: the
//      walk over H below reads every p row once for each 64-column block
//      of H, and recomputing would redo the whole logit product that many
//      times (8 at H = 512);
//   2. for each block hb of HB = 64 hidden columns: stage T[tile, hb];
//      then for each 64-row chunk of the group, stage s[chunk, hb] and add
//        p_chunk^T @ s[chunk, hb]  into the tile's dT block, in registers,
//        p_chunk @ T[tile, hb]     into the split's ds_part rows (the
//                                  split's first tile writes, later tiles
//                                  add; each element has one writer);
//      then write the dT block (a later group adds to what an earlier
//      one wrote; every dT row belongs to this block).
// Then the one-hot term, for the answers in [0, n_valid) that fall in the
// tile, in ascending answer order, on the finished dT rows in device
// memory from the unrounded states (the block's own writes, visible to it
// after the barrier). Every sum runs in a fixed order: two calls give the
// same bits. Shared memory: 2 x 64 x WLD + PB x (VT + 4) + 2 PB floats,
// 106,496 B at any H, so two blocks share an SM.
template <bool BF16>
__global__ void __launch_bounds__(THREADS, 2)
ce_bwd_wide_kernel(const float* __restrict__ states, const float* __restrict__ table,
                   const long long* __restrict__ answers, const float* __restrict__ logz,
                   const float* __restrict__ dloss, int B, int V, int H, int n_valid,
                   int tiles_per_split, float* __restrict__ ds_part,
                   float* __restrict__ dtable) {
  extern __shared__ __align__(16) float smem[];
  constexpr int pld = VT + 4;
  float* sS = smem;             // [BT][WLD] states chunk
  float* sT = sS + BT * WLD;    // [VT][WLD] table chunk
  float* sP = sT + VT * WLD;    // [PB][pld] p of the group's rows
  float* sZ = sP + PB * pld;    // [PB]      logZ
  float* sD = sZ + PB;          // [PB]      dloss
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int split = blockIdx.x;
  const int n_tiles = (V + VT - 1) / VT;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(t_begin + tiles_per_split, n_tiles);

  for (int t = t_begin; t < t_end; ++t) {
    const int j0 = t * VT;
    for (int g0 = 0; g0 < B; g0 += PB) {
      const int n_chunks = (min(PB, B - g0) + BT - 1) / BT;
      __syncthreads();  // earlier readers of sZ and sD are done
      for (int r = tid; r < PB; r += THREADS) {
        const int row = g0 + r;
        sZ[r] = row < B ? logz[row] : 0.f;
        sD[r] = row < B ? dloss[row] : 0.f;
      }
      // 1. p of the group's rows (wide_logits' first barrier publishes sZ, sD)
      for (int c = 0; c < n_chunks; ++c) {
        float acc[4][4];
        wide_logits<BF16>(sS, sT, states, table, g0 + c * BT, B, j0, V, H, acc);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = c * BT + ty * 4 + i;
          const bool row_ok = g0 + r < B;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int col = tx + 16 * j;
            float p = (row_ok && j0 + col < n_valid) ? expf(acc[i][j] - sZ[r]) * sD[r] : 0.f;
            if constexpr (BF16) p = round_bf16(p);
            sP[r * pld + col] = p;
          }
        }
      }
      // 2. dT and ds, a block of HB hidden columns at a time
      for (int hb = 0; hb < H; hb += HB) {
        const int hw = min(HB, H - hb);
        const bool mine = tx * 4 < hw;  // this thread's 4 columns lie inside H
        const int h = hb + tx * 4;
        __syncthreads();  // earlier readers of sT (and, first, every p) are done
        stage_chunk<BF16>(sT, table, j0, V, H, hb, hw, VT);
        float g[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int k = 0; k < 4; ++k) g[i][k] = 0.f;
        for (int c = 0; c < n_chunks; ++c) {
          const int row0 = g0 + c * BT;
          if (c > 0) __syncthreads();  // earlier readers of sS are done
          stage_chunk<BF16>(sS, states, row0, B, H, hb, hw, BT);
          __syncthreads();
          if (!mine) continue;
          const float* pc = sP + c * BT * pld;
          // the tile's dT rows ty*4 .. +3 += p_chunk^T @ s[chunk, hb]
#pragma unroll 4
          for (int r = 0; r < BT; ++r) {
            const float4 p4 = *reinterpret_cast<const float4*>(pc + r * pld + ty * 4);
            const float4 s4 = *reinterpret_cast<const float4*>(sS + r * WLD + tx * 4);
            const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              g[i][0] = fmaf(pv[i], s4.x, g[i][0]);
              g[i][1] = fmaf(pv[i], s4.y, g[i][1]);
              g[i][2] = fmaf(pv[i], s4.z, g[i][2]);
              g[i][3] = fmaf(pv[i], s4.w, g[i][3]);
            }
          }
          // this split's ds rows row0 + ty*4 .. +3 += p_chunk @ T[tile, hb]
          float e[4][4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int k = 0; k < 4; ++k) e[i][k] = 0.f;
#pragma unroll 2
          for (int cc = 0; cc < VT; cc += 4) {
            float4 tc[4];
#pragma unroll
            for (int k = 0; k < 4; ++k) tc[k] = *reinterpret_cast<const float4*>(sT + (cc + k) * WLD + tx * 4);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float4 p4 = *reinterpret_cast<const float4*>(pc + (ty * 4 + i) * pld + cc);
              const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
              for (int k = 0; k < 4; ++k) {
                e[i][0] = fmaf(pv[k], tc[k].x, e[i][0]);
                e[i][1] = fmaf(pv[k], tc[k].y, e[i][1]);
                e[i][2] = fmaf(pv[k], tc[k].z, e[i][2]);
                e[i][3] = fmaf(pv[k], tc[k].w, e[i][3]);
              }
            }
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int row = row0 + ty * 4 + i;
            if (row >= B) continue;
            float4* dst = reinterpret_cast<float4*>(ds_part + ((size_t)split * B + row) * H + h);
            float4 v = make_float4(e[i][0], e[i][1], e[i][2], e[i][3]);
            if (t != t_begin) {  // the split's first tile writes, later tiles add
              const float4 o = *dst;
              v.x += o.x;
              v.y += o.y;
              v.z += o.z;
              v.w += o.w;
            }
            *dst = v;
          }
        }
        if (mine) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int col = j0 + ty * 4 + i;
            if (col >= V) continue;
            float4* dst = reinterpret_cast<float4*>(dtable + (size_t)col * H + h);
            float4 v = make_float4(g[i][0], g[i][1], g[i][2], g[i][3]);
            if (g0 > 0) {  // a later group adds to the earlier groups' sum
              const float4 o = *dst;
              v.x += o.x;
              v.y += o.y;
              v.z += o.z;
              v.w += o.w;
            }
            *dst = v;
          }
        }
      }
    }
    // the one-hot term, as ce_bwd_sweep_kernel takes it, on the tile's
    // finished dT rows in device memory. Most tiles hold no answer and
    // skip the serial loop after one vote.
    int hit = 0;
    for (int i = tid; i < B; i += THREADS) {
      const long long a = __ldg(answers + i);
      hit |= in_catalog(a, n_valid) && a >= j0 && a < j0 + VT;
    }
    if (__syncthreads_or(hit)) {  // also the barrier after every dT write of the tile
      for (int h = tid; h < H; h += THREADS) {
        for (int i = 0; i < B; ++i) {
          const long long a = __ldg(answers + i);
          if (in_catalog(a, n_valid) && a >= j0 && a < j0 + VT)
            dtable[(size_t)a * H + h] -= __ldg(dloss + i) * __ldg(states + (size_t)i * H + h);
        }
      }
    }
  }
}

// ds [B, H] = the splits' partials summed in split order, then minus
// dloss_i * table[a_i][h] for a_i in [0, n_valid).
__global__ void __launch_bounds__(REDUCE_THREADS)
ce_ds_reduce_kernel(const float* __restrict__ ds_part, const float* __restrict__ table,
                    const long long* __restrict__ answers, const float* __restrict__ dloss,
                    int B, int H, int n_valid, int n_splits, float* __restrict__ ds) {
  const int n = B * H;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  float total = 0.f;
  for (int s = 0; s < n_splits; ++s) total += ds_part[(size_t)s * n + idx];
  const int row = idx / H;
  const long long a = __ldg(answers + row);
  if (in_catalog(a, n_valid))
    total = __fsub_rn(total, __fmul_rn(__ldg(dloss + row), __ldg(table + (size_t)a * H + (idx - row * H))));
  ds[idx] = total;
}

bool bad_shape(int B, int V, int H) { return B < 1 || V < 1 || H < 4 || H % 4 != 0; }

// The route of both sweeps, by shape: the on-chip kernels where the batch
// (and the backward's ds) fit beside the tiles; past MAX_H the wide
// route, which walks H in chunks (ce_fwd_partial_kernel<BF16, true>,
// ce_bwd_wide_kernel); ce_fwd_partial_kernel and ce_bwd_sweep_kernel
// elsewhere.
bool onchip_route(int B, int H) { return B <= OC_B && H <= OC_H; }
bool wide_route(int H) { return H > MAX_H; }

}  // namespace

extern "C" {

// Shared memory of the forward's pass 1 (which = 0) and of the backward's
// pass 1 (which = 1) on the route B and H take, at batch B, hidden size H.
long long streaming_ce_smem_bytes(int B, int H, int which) {
  const long long ld = H + 4;
  if (wide_route(H))
    return (long long)sizeof(float) *
           (which == 0 ? (BT + VT) * WLD : (BT + VT) * WLD + PB * (VT + 4) + 2 * PB);
  if (which == 0)
    return (long long)sizeof(float) *
           (onchip_route(B, H) ? onchip::STATE_FLOATS + onchip::RING_FLOATS : (BT + VT) * ld);
  if (onchip_route(B, H))
    return (long long)sizeof(float) * (OC_B * OC_LD + 2 * VT * OC_LD + OC_B * OC_PLD + 3 * OC_B);
  return (long long)sizeof(float) * (BT * ld + 2 * VT * ld + BT * (VT + 4) + 2 * BT);
}

// 1 where ce_logz and ce_grads take their on-chip routes at batch B,
// hidden size H.
int ce_onchip_route(int B, int H) { return onchip_route(B, H) ? 1 : 0; }

// 1 where they take their wide routes (H > 256), which stage the hidden
// dimension in chunks of 64 columns.
int ce_wide_route(int H) { return wide_route(H) ? 1 : 0; }

// logZ [B] of states [B, H] against table [V, H] over columns < n_valid,
// and, when answers (int64 [B]) and loss are not null, loss [B] = logZ -
// <states[i], table[answers[i]]> with gold 0 for answers outside
// [0, n_valid). answers and loss are both given or both null. bf16 != 0
// takes the bf16-operand form (the file's head). The route is the shape's
// (ce_onchip_route, ce_wide_route): one block per SM suits the on-chip
// route, two the others, over (splits x batch tiles of 64 rows). The
// caller allocates the partials part_m, part_s ([n_splits, B]); n_splits *
// tiles_per_split tiles must cover V. Returns 0 or a cudaError_t code.
int ce_logz(const void* states, const void* table, const void* answers, int B, int V, int H,
            int n_valid, int n_splits, int tiles_per_split, void* part_m, void* part_s,
            void* logz, void* loss, int bf16, void* stream) {
  if (bad_shape(B, V, H) || n_valid < 0 || n_valid > V || n_splits < 1 ||
      (long long)n_splits * tiles_per_split * VT < V || (answers == nullptr) != (loss == nullptr))
    return (int)cudaErrorInvalidValue;
  const long long smem = streaming_ce_smem_bytes(B, H, 0);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool onchip = onchip_route(B, H);
  auto sweep =
      wide_route(H) ? (bf16 ? ce_fwd_partial_kernel<true, true> : ce_fwd_partial_kernel<false, true>)
      : onchip      ? (bf16 ? ce_fwd_onchip_kernel<true> : ce_fwd_onchip_kernel<false>)
                    : (bf16 ? ce_fwd_partial_kernel<true, false> : ce_fwd_partial_kernel<false, false>);
  cudaError_t e = cudaFuncSetAttribute(sweep, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  sweep<<<dim3(n_splits, onchip ? 1 : (B + BT - 1) / BT), THREADS, (size_t)smem, s>>>(
      static_cast<const float*>(states), static_cast<const float*>(table), B, V, H, n_valid,
      tiles_per_split, static_cast<float*>(part_m), static_cast<float*>(part_s));
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  constexpr int rows_per_block = MERGE_THREADS / 32;
  auto merge = bf16 ? ce_fwd_merge_kernel<true> : ce_fwd_merge_kernel<false>;
  merge<<<(B + rows_per_block - 1) / rows_per_block, MERGE_THREADS, 0, s>>>(
      static_cast<const float*>(part_m), static_cast<const float*>(part_s),
      static_cast<const float*>(states), static_cast<const float*>(table),
      static_cast<const long long*>(answers), B, H, n_valid, n_splits, static_cast<float*>(logz),
      static_cast<float*>(loss));
  return (int)cudaGetLastError();
}

// out [B, H] = table[answers[i]] for answers in [0, V), zeros otherwise.
int ce_gold_rows(const void* table, const void* answers, int B, int V, int H, void* out,
                 void* stream) {
  if (bad_shape(B, V, H)) return (int)cudaErrorInvalidValue;
  const int n = B * (H / 4);
  gold_rows_kernel<<<(n + GATHER_THREADS - 1) / GATHER_THREADS, GATHER_THREADS, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(table), static_cast<const int32_t*>(answers), B, V, H,
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}

// ds [B, H] = p @ table - dloss * table[answers] and dtable [V, H] =
// p^T @ states - onehot, with p = exp(states @ table^T - logz) * dloss over
// columns < n_valid and the one-hot term dtable[a_i] -= dloss_i * states_i,
// for the int64 answers a_i in [0, n_valid) only (the others have neither
// term). bf16 != 0 takes the bf16-operand form (the file's head): s, T and
// p rounded to bf16 before the products, the one-hot terms from the
// unrounded s and T. The route is the shape's (ce_onchip_route,
// ce_wide_route): one block per SM suits the on-chip route, two the
// others. The caller allocates ds_part ([n_splits, B, H]); n_splits *
// tiles_per_split tiles must cover V, and every split must hold at least
// one tile. Returns 0 or a cudaError_t code.
int ce_grads(const void* states, const void* table, const void* answers, const void* logz,
             const void* dloss, int B, int V, int H, int n_valid, int n_splits,
             int tiles_per_split, void* ds_part, void* ds, void* dtable, int bf16, void* stream) {
  const int n_tiles = (V + VT - 1) / VT;
  if (bad_shape(B, V, H) || n_valid < 0 || n_valid > V || n_splits < 1 ||
      tiles_per_split < 1 || (long long)n_splits * tiles_per_split < n_tiles ||
      (long long)(n_splits - 1) * tiles_per_split >= n_tiles)
    return (int)cudaErrorInvalidValue;
  const long long smem = streaming_ce_smem_bytes(B, H, 1);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto sweep = wide_route(H)         ? (bf16 ? ce_bwd_wide_kernel<true> : ce_bwd_wide_kernel<false>)
               : onchip_route(B, H) ? (bf16 ? ce_bwd_onchip_kernel<true> : ce_bwd_onchip_kernel<false>)
                                    : (bf16 ? ce_bwd_sweep_kernel<true> : ce_bwd_sweep_kernel<false>);
  cudaError_t e = cudaFuncSetAttribute(sweep, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  sweep<<<n_splits, THREADS, (size_t)smem, s>>>(
      static_cast<const float*>(states), static_cast<const float*>(table),
      static_cast<const long long*>(answers), static_cast<const float*>(logz),
      static_cast<const float*>(dloss), B, V, H, n_valid, tiles_per_split,
      static_cast<float*>(ds_part), static_cast<float*>(dtable));
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int n = B * H;
  ce_ds_reduce_kernel<<<(n + REDUCE_THREADS - 1) / REDUCE_THREADS, REDUCE_THREADS, 0, s>>>(
      static_cast<const float*>(ds_part), static_cast<const float*>(table),
      static_cast<const long long*>(answers), static_cast<const float*>(dloss),
      B, H, n_valid, n_splits, static_cast<float*>(ds));
  return (int)cudaGetLastError();
}

const char* streaming_ce_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
