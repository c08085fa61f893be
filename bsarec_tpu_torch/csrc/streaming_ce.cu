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
//     553-555). On the on-chip route (B <= 256, H <= 64) the bf16 form runs
//     ce_fwd_onchip_tc_kernel and ce_bwd_onchip_tc_kernel, on the middle
//     route (B <= 256, 64 < H <= 256) ce_fwd_mid_tc_kernel and
//     ce_bwd_mid_tc_kernel and on the wide route (H > 256)
//     ce_fwd_wide_tc_kernel and ce_bwd_wide_tc_kernel, every product on the
//     tensor cores (their heads say more); the older sweeps (B > 256 at H
//     <= 256) round where an operand enters shared memory (stage_rows) and
//     where p is stored, so their product loops are the fp32 form's. On
//     the wide route the fp32 form runs on the tensor cores too, in
//     3xTF32, which keeps fp32 accuracy: ce_fwd_wide_tf32_kernel and
//     ce_bwd_wide_tf32_kernel; on the middle route ce_fwd_mid_tf32_kernel,
//     on wgmma, and ce_bwd_wide_tf32_kernel (ce_bwd_mid_tf32_kernel, on
//     wgmma, is that backward's slower variant, for the ablation tool).
//
// Replaces the three Pallas TPU kernels of bsarec_tpu/ops/pallas_ce.py:
//   - _fwd_kernel    -> ce_fwd_onchip_kernel (ce_fwd_onchip_tc_kernel in the
//       bf16 form), ce_fwd_partial_kernel (at B <= 256 ce_fwd_mid_tf32_kernel,
//       ce_fwd_mid_tc_kernel in the bf16 form) or, past H = 256,
//       ce_fwd_wide_tf32_kernel (fp32) and ce_fwd_wide_tc_kernel (bf16),
//       then ce_fwd_merge_kernel:
//       per row, logZ = logsumexp(s . T^T) over the columns < n_valid and,
//       when answers are given, loss = logZ - <s, T[a]>;
//   - _gather_kernel -> gold_rows_kernel: the answers' table rows T[a]
//       (zeros where a is outside [0, V));
//   - _grads_kernel  -> ce_bwd_onchip_kernel (ce_bwd_onchip_tc_kernel in the
//       bf16 form), ce_bwd_sweep_kernel (at B <= 256 in the bf16 form
//       ce_bwd_mid_tc_kernel, in the fp32 form ce_bwd_wide_tf32_kernel) or,
//       past H = 256,
//       ce_bwd_wide_tf32_kernel (fp32) and ce_bwd_wide_tc_kernel (bf16),
//       then ce_ds_reduce_kernel (ce_ds_reduce_tc_kernel): with
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
// tensor rate, 989 TFLOP/s, take 0.033 and 0.099); its on-chip and wide
// kernels run on the tensor cores, the older sweeps' bf16 form on the fp32
// form's FMA loops. The wide fp32 form's 3xTF32 products are
// bound by three passes at the TF32 tensor rate (495 TFLOP/s): at B=256,
// V=1M, H=512 the backward 4.77 ms and the forward 1.589 ms, against
// 11.74 and 3.913 ms for the same work in fp32 FMAs.
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
//       of two table tiles, 8 x 8 logits a thread, one barrier a tile (the
//       bf16 form: ce_fwd_onchip_tc_kernel, on the tensor cores);
//     - the wide route, H > 256: a tensor-core kernel in either form, one
//       block per SM, the logits of 256 batch rows x 128 catalog columns a
//       tile, the table read once, the hidden dimension staged in chunks,
//       the online (max, sum) folded and merged by one pair of functions
//       for both (fold_tile, merge_group): ce_fwd_wide_tf32_kernel in the fp32 form
//       (3xTF32, each fragment split into TF32 hi and lo in registers),
//       ce_fwd_wide_tc_kernel in the bf16 form; their heads say more;
//     - the middle route, B <= 256 and 64 < H <= 256: ce_fwd_mid_tf32_kernel
//       (wgmma in 3xTF32) and ce_fwd_mid_tc_kernel (bf16); their heads say
//       more;
//     - elsewhere (B > 256 at H > 64) ce_fwd_partial_kernel, grid
//       (vocab splits x batch tiles of 64 rows), each block staging its 64
//       state rows and each table tile synchronously, 4 x 4 logits a
//       thread.
//   forward, pass 2: one warp per row. logZ = M + log(sum_s s_s *
//     exp(m_s - M)), each lane taking every 32nd split and the lanes
//     merged by a fixed shuffle tree; then the gold logit <s, T[a]> from
//     coalesced float4 reads of the two rows, reduced the same way.
//   backward, pass 1: one block per vocab split, on one of three routes
//     that the C entry picks by shape before the launch:
//     - the on-chip route, B <= 256 and H <= 64 (the training path's B=256,
//       H=64): ce_bwd_onchip_kernel (the bf16 form: ce_bwd_onchip_tc_kernel,
//       on the tensor cores), one block of 256 threads per SM. What
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
//       tiles no longer fit (217 KB at H = 256): a tensor-core kernel in
//       either form, one block per SM, 229,376 B of shared memory at any
//       H. Per tile of catalog columns and group of up to 256 batch rows it
//       computes p from logits accumulated over hidden chunks and holds
//       the group's p in shared memory; then it walks dT's and ds's hidden
//       dimension in chunks, each chunk's p^T @ s written to dT and p @ T
//       added to the split's ds_part. The one-hot term goes on the
//       finished dT rows in device memory. ce_bwd_wide_tf32_kernel in the
//       fp32 form (128-column tiles, p fp32, every product in 3xTF32) and
//       ce_bwd_wide_tc_kernel in the bf16 form (256-column tiles, p bf16);
//       their heads say more;
//     - the middle route, B <= 256 and 64 < H <= 256: the wide route's
//       ce_bwd_wide_tf32_kernel in the fp32 form (faster there than
//       ce_bwd_mid_tf32_kernel, wgmma in 3xTF32, at B = 256),
//       ce_bwd_mid_tc_kernel (bf16); their heads say more;
//     - the sweep route, B > 256 at H > 64, where the batch and its ds do
//       not fit beside the tiles: ce_bwd_sweep_kernel, two blocks per SM.
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
// ms (the partial-kernel route's ~1.33 ms, 37%); the bf16-operand form's
// tensor-core pair ~0.60 and ~0.18 ms, 25% and 42% of their byte bounds
// (chip_smoke.py, tools/time_kernels.py, in turns; the FMA form it
// replaced ~2.86 and ~1.00). At
// H = 512 the 3xTF32 kernels take ~5.0 ms (forward, 32% of 1.589 ms) and
// ~14.6 ms (backward, 33% of 4.766 ms); the bf16 form's tensor-core
// kernels ~5.3 ms (backward, 23% of its 1.223 ms byte bound) and ~1.08 ms
// (forward, 57% of 0.612 ms) (chip_smoke.py, tools/time_kernels.py). The
// middle route's pairs: ce_fwd_mid_tc_kernel's and ce_fwd_mid_tf32_kernel's
// heads. The middle route's fp32 pair runs wgmma (wgmma.cuh); no kernel
// uses TMA.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "onchip_tile.cuh"
#include "tensor_core.cuh"
#include "wgmma.cuh"
#include "wgmma_tf32_tile.cuh"

using onchip::round_bf16;
using namespace mf;

namespace {

constexpr int BT = 64;            // batch rows per tile / chunk
constexpr int VT = 64;            // catalog columns per tile
constexpr int HB = 64;            // hidden columns per output block (backward)
constexpr int THREADS = 256;      // 16 x 16 threads for 4 x 4 tiles, 32 x 8 for 8 x 8
constexpr int MAX_H = 256;         // the older routes stage whole rows up to here; the wide ones past it
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

// The forward's pass 1 on the older route (64 < H <= MAX_H, or B > OC_B):
// the 64 state rows staged once and each table tile whole.
template <bool BF16>
__global__ void __launch_bounds__(THREADS, 2)
ce_fwd_partial_kernel(const float* __restrict__ states, const float* __restrict__ table, int B,
                      int V, int H, int n_valid, int tiles_per_split,
                      float* __restrict__ part_m, float* __restrict__ part_s) {
  extern __shared__ __align__(16) float smem[];
  const int ld = H + 4;
  float* sS = smem;           // [BT][ld] states
  float* sT = sS + BT * ld;   // [VT][ld] table tile
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int split = blockIdx.x, row0 = blockIdx.y * BT;
  const int n_tiles = (V + VT - 1) / VT;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(t_begin + tiles_per_split, n_tiles);

  stage_rows<BF16>(sS, states, row0, B, H, BT);
  float m[4], s[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    s[i] = 0.f;
  }
  for (int t = t_begin; t < t_end; ++t) {
    const int j0 = t * VT;
    float acc[4][4];
    __syncthreads();  // earlier readers of sT are done
    stage_rows<BF16>(sT, table, j0, V, H, VT);
    __syncthreads();
    tile_logits(sS, sT, H, acc);
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

  onchip::stage_states(sS, sT, states, B, H);
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

  onchip::stage_states(sS, sT, states, B, H);
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
          sP[r * OC_PLD + c] = (row_ok && j0 + c < n_valid) ? expf(acc[i][j] - z) * d : 0.f;
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
      for (int h = tid; h < H; h += THREADS)
        for (int i = 0; i < B; ++i) {
          const int a = sA[i];
          if (a >= j0 && a < j0 + VT) sP[(a - j0) * OC_LD + h] -= sD[i] * sS[i * OC_LD + h];
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

// ---- the bf16-operand form of the wide backward, on the tensor cores --------
//
// ce_bwd_wide_tc_kernel: the backward's pass 1 in the bf16-operand form at
// H > MAX_H (the counterpart of pallas_ce.py:340 _grads_kernel with
// dtype="bfloat16", whose products run on the MXU with f32 accumulation,
// pallas_ce.py:303, 360-362). All three products run on the tensor cores
// (tensor_core.cuh: mma.sync m16n8k16, bf16 operands, fp32 accumulators,
// fragments through ldmatrix), so the bf16 form no longer runs the fp32
// form's FMA loops (786 GFLOP at B=256, V=1M, H=512: 11.74 ms at the fp32
// FMA peak, 0.795 ms at the bf16 tensor rate).
//
// Operands on chip are bf16. states_bf16_kernel first writes the states,
// rounded, into a [Bp, Hp] bf16 scratch sb (Bp = B rounded up to TC_ROWS,
// Hp = H up to TC_HL = 64, zero-padded: H = 260 takes 60 zero columns), so
// state chunks come by cp.async.cg straight into shared memory. The table,
// fp32 in device memory, is read from there once per tile, by register
// prefetch two steps ahead: each thread loads its float4s, then rounds and
// stores them (TMA copies bytes and cannot convert, and a cp.async ring of
// fp32 tiles would need shared memory this kernel has no room for). The
// rounded rows also go to the split's bf16 tile in the scratch tb (256 KB
// at H = 512, meant to stay in L2), from which the products steps copy
// them back by cp.async.
//
// One block of 256 threads per SM walks its split in tiles of TC_SV = 256
// catalog columns, and each group of up to TC_ROWS = 256 batch rows (one
// group for B <= 256) in 4 Hp / 64 + Hp / 32 steps, the next step's state
// chunk and table rows in flight while a step computes (a ring of two
// slots, one barrier a step):
//   logits  for each 64-column sub-tile of the tile, Hp / 64 steps of 64
//           hidden columns: the group's [256 x 64] logits S . T_sub^T
//           accumulated over the hidden chunks (8 warps as 4 x 2, 64 x 32
//           each); then p = bf16(exp(logit - logZ) * dloss), 0 past
//           n_valid and B, into the tile's p [256 x 256] in shared memory;
//   products Hp / 32 steps, each for one 32-column hidden chunk of the tile's 256
//           table rows: warps 0-3 dT[tile, chunk] = p^T . S[:, chunk] (64
//           catalog columns each), warps 4-7 ds[:, chunk] += p . T[tile,
//           chunk] (64 batch rows each), both K = 256; dT written once (a
//           later group adds to it), the split's ds_part read and written
//           once per tile (the split's first tile only writes), in the ds
//           warps' fragment order, so that every warp-wide access moves 512
//           contiguous bytes (ce_ds_reduce_tc_kernel reads that order). A
//           step's accumulators are loaded at the end of the step before.
// Then the one-hot term dT[a_i] -= dloss_i * s_i, in ascending i as every
// route takes it: on the tile's finished dT rows in device memory, from the
// unrounded states, in ascending i. The sums run in a fixed order and
// ds_part is summed by ce_ds_reduce_tc_kernel in split order: two calls
// give the same bits.
//
// Bytes at B=256, V=1M, H=512, per 256-column tile: from and to device
// memory the table rows once (512 KB) and dT once (512 KB), ds_part read
// and written once (1 MB): 2 MB, 8.2 GB over 3,907 tiles (2.45 ms at 3.35
// TB/s, against the 4.10 GB, 1.22 ms, of reading the table and writing dT
// once); through L2 besides, the bf16 states 5 x 256 KB and the bf16 tile
// written and read (512 KB). (A tile's 256 rows in bf16, 256 KB, and its
// p, 128 KB, do not fit beside each other; holding p lets ds_part move 4x
// fewer bytes than 64-column tiles would.) Shared memory: p 135,168 B, two
// slots 92,160 (a logits slot, 46,080, holds a products slot, 40,960),
// logZ and dloss 2,048: 229,376 B at any H. A logits step is twice as wide
// as a products step, so it pays its fixed latency (a barrier, a chunk's
// round trip) once for twice the tensor-core work. Rows are padded by 16
// bytes (p's to 528 B, the slots' to 144 and 80 B), so the eight rows of
// each ldmatrix matrix fall on distinct banks.
// On one "NVIDIA H100 80GB HBM3, 700.00 W" at B=256, V=1M, H=512 it takes
// ~5.3 ms (PERF.md row 4bw): the logits steps ~2.1 ms, bound by L2's
// bandwidth (every SM streams the same states four times a tile), the
// products steps ~3.3 (ds_part and dT in device memory).

constexpr int TC_ROWS = 256;             // batch rows per group
constexpr int TC_SV = 256;               // catalog columns per tile: one ds_part update
constexpr int TC_SUB = 64;               // catalog columns per logits sub-tile
constexpr int TC_HL = 64;                // hidden columns per logits step
constexpr int TC_HP = 32;                // hidden columns per products step (H is padded to a multiple of TC_HL)
constexpr int TC_LDL = TC_HL + 8;        // a logits slot's row stride (bf16)
constexpr int TC_LDC = TC_HP + 8;        // a products slot's row stride (bf16)
constexpr int TC_LDP = TC_SV + 8;        // p's row stride (bf16)
// a logits slot: states [TC_ROWS][TC_LDL], then table rows [TC_SUB][TC_LDL];
// a products slot: states [TC_ROWS][TC_LDC], then table rows [TC_SV][TC_LDC]
constexpr int TC_LSLOT = (TC_ROWS + TC_SUB) * TC_LDL;
constexpr int TC_PSLOT = (TC_ROWS + TC_SV) * TC_LDC;
constexpr long long TC_SMEM =
    2LL * (TC_ROWS * TC_LDP + 2 * TC_LSLOT) + 4LL * 2 * TC_ROWS;  // 229,376 B
static_assert(TC_SV == TC_ROWS && TC_SV % VT == 0 && TC_SV == 4 * TC_SUB && THREADS == 256,
              "8 warps: logits as 4 x 2 warps of 64 x 32, products 2 x 4 warps of 64 rows");
// Both kinds of slot share one region of two logits slots. The last logits
// step is odd (4 Hp / TC_HL - 1) and reads logits slot 1 while the first
// products step's copies land in products slot 0, so those two must not
// overlap; every other reuse of the region is behind a barrier.
static_assert(TC_PSLOT <= TC_LSLOT && TC_HL % TC_HP == 0, "products slot 0 ends before logits slot 1");

__host__ __device__ __forceinline__ int round_up(int x, int m) { return (x + m - 1) / m * m; }

// out [Bp, Hp] bf16 = states rounded (nearest, ties to even), zero past B
// and H.
__global__ void __launch_bounds__(256)
states_bf16_kernel(const float* __restrict__ states, int B, int H, int Bp, int Hp,
                   __nv_bfloat16* __restrict__ out) {
  const int q = Hp / 4;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= Bp * q) return;
  const int r = idx / q, c = (idx - r * q) * 4;
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (r < B && c < H) v = __ldg(reinterpret_cast<const float4*>(states + (size_t)r * H + c));
  *reinterpret_cast<uint2*>(out + (size_t)r * Hp + c) =
      make_uint2(tc::pack_bf16(v.x, v.y), tc::pack_bf16(v.z, v.w));
}

__global__ void __launch_bounds__(THREADS, 1)
ce_bwd_wide_tc_kernel(const __nv_bfloat16* __restrict__ sb, __nv_bfloat16* __restrict__ tb,
                      const float* __restrict__ states,
                      const float* __restrict__ table, const long long* __restrict__ answers,
                      const float* __restrict__ logz, const float* __restrict__ dloss, int B,
                      int V, int H, int n_valid, int tiles_per_split,
                      float* __restrict__ ds_part, float* __restrict__ dtable) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  __nv_bfloat16* sP = reinterpret_cast<__nv_bfloat16*>(tc_smem);  // [TC_ROWS][TC_LDP] p
  __nv_bfloat16* sR = sP + TC_ROWS * TC_LDP;                       // [2][TC_LSLOT] the slots
  float* sZ = reinterpret_cast<float*>(sR + 2 * TC_LSLOT);         // [TC_ROWS] logZ
  float* sD = sZ + TC_ROWS;                                        // [TC_ROWS] dloss
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int Hp = round_up(H, TC_HL), nl = Hp / TC_HL, np = Hp / TC_HP;
  const int n_lg = 4 * nl, n_steps = n_lg + np, n_groups = (B + TC_ROWS - 1) / TC_ROWS;
  const int split = blockIdx.x;
  const int n_tiles = (V + VT - 1) / VT;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(t_begin + tiles_per_split, n_tiles);
  // the logits' warp tile (rows 64 wm, columns 32 wn of a sub-tile); the
  // products' (warps 0-3: dT's catalog columns 64 warp; 4-7: ds's rows 64 (warp - 4))
  const int wm = warp & 3, wn = warp >> 2;
  const bool dt_warp = warp < 4;
  const int pm = 64 * (warp & 3);

  for (int t = t_begin; t < t_end; t += TC_SV / VT) {
    const int j0 = t * VT;
    for (int g0 = 0; g0 < B; g0 += TC_ROWS) {
      // step s: s < n_lg the logits of sub-tile s / nl at hidden chunk
      // s % nl (TC_HL wide, 64 table rows), else the products at chunk
      // s - n_lg (TC_HP wide, 256 table rows); its slot is s & 1. A logits
      // step's table rows come as fp32 into pre_a or pre_b (4 float4s a
      // thread, loaded two steps ahead), are rounded and stored into the
      // slot and into the split's bf16 tile in tb; a products step copies
      // its states and table rows by cp.async (from sb and tb), 4 16-byte
      // pieces a thread each.
      float4 pre_a[4], pre_b[4];  // the table rows of two logits steps ahead, alternating
      __nv_bfloat16* tile_bf16 = tb + (size_t)split * TC_SV * Hp;
      auto slot = [&](int s) { return sR + (s & 1) * (s < n_lg ? TC_LSLOT : TC_PSLOT); };
      auto issue = [&](int s) {
        __nv_bfloat16* dst = slot(s);
        if (s < n_lg) {
          const int h0 = (s % nl) * TC_HL;
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            const int i = tid + THREADS * q, r = i >> 3, c8 = (i & 7) * 8;
            tc::cp_async_16(dst + r * TC_LDL + c8, sb + (size_t)(g0 + r) * Hp + h0 + c8);
          }
        } else {
          const int h0 = (s - n_lg) * TC_HP;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int i = tid + THREADS * q, r = i >> 2, c8 = (i & 3) * 8;
            tc::cp_async_16(dst + r * TC_LDC + c8, sb + (size_t)(g0 + r) * Hp + h0 + c8);
            tc::cp_async_16(dst + (TC_ROWS + r) * TC_LDC + c8, tile_bf16 + (size_t)r * Hp + h0 + c8);
          }
        }
      };
      auto load_table = [&](int s, float4 (&pre)[4]) {  // a logits step's table rows into pre
        if (s >= n_lg) return;
        const int h0 = (s % nl) * TC_HL, col0 = j0 + (s / nl) * TC_SUB;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int i = tid + THREADS * q, r = i >> 4, h = h0 + (i & 15) * 4;
          pre[q] = (col0 + r < V && h < H)
                       ? __ldg(reinterpret_cast<const float4*>(table + (size_t)(col0 + r) * H + h))
                       : make_float4(0.f, 0.f, 0.f, 0.f);
        }
      };
      auto fill = [&](int s, const float4 (&pre)[4]) {  // pre, rounded, into the slot and tb
        if (s >= n_lg) return;
        const int h0 = (s % nl) * TC_HL, c0 = (s / nl) * TC_SUB;
        __nv_bfloat16* dst = slot(s) + TC_ROWS * TC_LDL;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int i = tid + THREADS * q, r = i >> 4, c4 = (i & 15) * 4;
          const uint2 v =
              make_uint2(tc::pack_bf16(pre[q].x, pre[q].y), tc::pack_bf16(pre[q].z, pre[q].w));
          *reinterpret_cast<uint2*>(dst + r * TC_LDL + c4) = v;
          *reinterpret_cast<uint2*>(tile_bf16 + (size_t)(c0 + r) * Hp + h0 + c4) = v;
        }
      };
      float acc[4][4][4];
      // this ds warp's fragments of products step s in ds_part, which
      // holds them in fragment order (ce_ds_reduce_tc_kernel's head):
      // float4 q = 4 i + j of lane l at (q * 32 + l) * 4, so that each
      // warp-wide access moves 512 contiguous bytes
      auto ds_frag = [&](int s) {
        return ds_part + ((((size_t)split * n_groups + g0 / TC_ROWS) * np + (s - n_lg)) * 4 +
                          (warp - 4)) * (32 * 64) + lane * 4;
      };
      // a products step's accumulators start from what an earlier group
      // (dT) or tile (ds_part) wrote there, by this same thread, else from
      // 0; they are loaded at the end of the step before, so that the loads
      // are in flight while it waits at the barrier
      auto carry = [&](int s) {
        const int h0 = (s - n_lg) * TC_HP;
        if (dt_warp) {
          const bool from = g0 > 0;
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
              for (int e = 0; e < 4; e += 2) {
                const int m = pm + 16 * i + g + 4 * e, h = h0 + 8 * j + 2 * t4;
                float2 v = make_float2(0.f, 0.f);
                if (from && h < H && j0 + m < V)
                  v = *reinterpret_cast<const float2*>(dtable + (size_t)(j0 + m) * H + h);
                acc[i][j][e] = v.x;
                acc[i][j][e + 1] = v.y;
              }
        } else {
          const float4* src = reinterpret_cast<const float4*>(ds_frag(s));
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const float4 v = t != t_begin ? src[(4 * i + j) * 32] : make_float4(0.f, 0.f, 0.f, 0.f);
              acc[i][j][0] = v.x;
              acc[i][j][1] = v.y;
              acc[i][j][2] = v.z;
              acc[i][j][3] = v.w;
            }
        }
      };

      __syncthreads();  // every reader of the slots, sZ and sD before is done
      for (int r = tid; r < TC_ROWS; r += THREADS) {
        const int row = g0 + r;
        sZ[r] = row < B ? logz[row] : 0.f;
        sD[r] = row < B ? dloss[row] : 0.f;
      }
      issue(0);
      onchip::cp_async_commit();
      load_table(0, pre_a);
      fill(0, pre_a);
      load_table(1, pre_b);

      // step s: cur holds nothing (its rows went to the slot at the end of
      // step s - 1) and takes step s + 2's rows; nxt holds step s + 1's
      auto step = [&](int s, float4 (&cur)[4], const float4 (&nxt)[4]) {
        const bool lg = s < n_lg;
        const int kc = lg ? s % nl : s - n_lg;
        const int h0 = kc * TC_HP;  // (products steps)
        if (lg && kc == 0) {
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
        }
        onchip::cp_async_wait_all();  // this thread's copies of step s have landed
        __syncthreads();              // everyone's, and the table slot; step s - 1 is done
        if (s + 1 < n_steps) issue(s + 1);
        onchip::cp_async_commit();
        if (s + 2 < n_steps) load_table(s + 2, cur);
        const __nv_bfloat16* S = slot(s);
        if (lg) {
          // acc[i][j] += S[64 wm + 16 i, :] . T[32 wn + 8 j, :]^T over the chunk
          const __nv_bfloat16* T = S + TC_ROWS * TC_LDL;
#pragma unroll 2
          for (int kk = 0; kk < TC_HL; kk += 16) {
            uint32_t a[4][4], b[4][2];
#pragma unroll
            for (int i = 0; i < 4; ++i)
              tc::ldmatrix_x4(a[i], S + (64 * wm + 16 * i + tc::a_row(lane)) * TC_LDL + kk +
                                        tc::a_col(lane));
#pragma unroll
            for (int jp = 0; jp < 2; ++jp) {
              uint32_t r[4];
              tc::ldmatrix_x4(r, T + (32 * wn + 16 * jp + tc::b_row(lane)) * TC_LDL + kk +
                                     tc::b_col(lane));
              b[2 * jp][0] = r[0];
              b[2 * jp][1] = r[1];
              b[2 * jp + 1][0] = r[2];
              b[2 * jp + 1][1] = r[3];
            }
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j) tc::mma_bf16(acc[i][j], a[i], b[j]);
          }
          if (kc == nl - 1) {  // the sub-tile's logits are complete: p into sP
            const int sub = s / nl;
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int half = 0; half < 2; ++half) {
                const int r = 64 * wm + 16 * i + g + 8 * half;
                const bool row_ok = g0 + r < B;
                const float z = sZ[r], d = sD[r];
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                  const int c = TC_SUB * sub + 32 * wn + 8 * j + 2 * t4, col = j0 + c;
                  const float p0 = (row_ok && col < n_valid) ? expf(acc[i][j][2 * half] - z) * d : 0.f;
                  const float p1 =
                      (row_ok && col + 1 < n_valid) ? expf(acc[i][j][2 * half + 1] - z) * d : 0.f;
                  *reinterpret_cast<uint32_t*>(sP + r * TC_LDP + c) = tc::pack_bf16(p0, p1);
                }
              }
          }
        } else {
          // warps 0-3: acc[i][j] += p[:, pm + 16 i]^T . S[:, 8 j] (dT rows);
          // warps 4-7: acc[i][j] += p[pm + 16 i, :] . T[:, 8 j]   (ds rows)
          const __nv_bfloat16* Bsrc = dt_warp ? S : S + TC_ROWS * TC_LDC;
#pragma unroll 2
          for (int k = 0; k < TC_SV; k += 16) {
            uint32_t a[4][4], b[4][2];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              if (dt_warp)
                tc::ldmatrix_x4_trans(a[i], sP + (k + tc::b_row(lane)) * TC_LDP + pm + 16 * i +
                                                tc::b_col(lane));
              else
                tc::ldmatrix_x4(a[i], sP + (pm + 16 * i + tc::a_row(lane)) * TC_LDP + k +
                                          tc::a_col(lane));
            }
#pragma unroll
            for (int jp = 0; jp < 2; ++jp) {
              uint32_t r[4];
              tc::ldmatrix_x4_trans(r, Bsrc + (k + tc::bt_row(lane)) * TC_LDC + 16 * jp +
                                           tc::bt_col(lane));
              b[2 * jp][0] = r[0];
              b[2 * jp][1] = r[1];
              b[2 * jp + 1][0] = r[2];
              b[2 * jp + 1][1] = r[3];
            }
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j) tc::mma_bf16(acc[i][j], a[i], b[j]);
          }
          if (dt_warp) {
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j)
#pragma unroll
                for (int e = 0; e < 4; e += 2) {
                  const int m = pm + 16 * i + g + 4 * e, h = h0 + 8 * j + 2 * t4;
                  if (h < H && j0 + m < V)  // H % 4 == 0 and h is even: h + 1 < H too
                    *reinterpret_cast<float2*>(dtable + (size_t)(j0 + m) * H + h) =
                        make_float2(acc[i][j][e], acc[i][j][e + 1]);
                }
          } else {
            float4* dst = reinterpret_cast<float4*>(ds_frag(s));
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j)
                dst[(4 * i + j) * 32] = make_float4(acc[i][j][0], acc[i][j][1], acc[i][j][2], acc[i][j][3]);
          }
        }
        if (s + 1 < n_steps) {
          if (s + 1 >= n_lg) carry(s + 1);  // (after the epilogue or the stores: acc is free)
          fill(s + 1, nxt);
        }
      };
      for (int s = 0; s < n_steps; s += 2) {  // n_steps = 6 Hp / 64 is even
        step(s, pre_a, pre_b);
        step(s + 1, pre_b, pre_a);
      }
    }
    // the one-hot term, in ascending i as every route takes it, on the tile's
    // finished dT rows in device memory, from the unrounded states
    int hit = 0;
    for (int i = tid; i < B; i += THREADS) {
      const long long a = __ldg(answers + i);
      hit |= in_catalog(a, n_valid) && a >= j0 && a < j0 + TC_SV;
    }
    if (__syncthreads_or(hit)) {  // also the barrier after every dT write of the tile
      for (int h = tid; h < H; h += THREADS) {
        for (int i = 0; i < B; ++i) {
          const long long a = __ldg(answers + i);
          if (in_catalog(a, n_valid) && a >= j0 && a < j0 + TC_SV)
            dtable[(size_t)a * H + h] -= __ldg(dloss + i) * __ldg(states + (size_t)i * H + h);
        }
      }
    }
  }
}

// ---- the fp32 form of the wide backward, on the tensor cores in 3xTF32 -------
//
// ce_bwd_wide_tf32_kernel: the backward's pass 1 in the fp32 form at
// H > MAX_H, the counterpart of pallas_ce.py:340 _grads_kernel at f32,
// whose three products are f32 dot_generals (pallas_ce.py:399-406). It
// computes what ce_bwd_wide_tc_kernel does without a rounding: p =
// exp(s . T^T - logZ) * dloss in fp32 (0 past n_valid and B), ds_part +=
// p . T, dT = p^T . s, then the one-hot term. Every product runs on the
// tensor cores in 3xTF32 (tensor_core.cuh: each fp32 operand split in
// registers into a TF32 hi and lo, three mma.sync m16n8k8 a product), which
// keeps fp32 accuracy; 1xTF32 keeps about three digits and would not be
// the same function.
//
// Bound at B=256, V=1M, H=512: 3 x 2BVH = 786.43 GFLOP, three TF32 passes
// of it at the dense TF32 rate (495 TFLOP/s) 4.77 ms; the fp32 table read
// once and dT written once, 4.10 GB, 1.22 ms at 3.35 TB/s. (The same work
// in fp32 FMAs is 11.74 ms at 67 TFLOP/s: a kernel on the FMA pipes could
// at best tie cuBLAS's SGEMM.)
//
// The skeleton is ce_bwd_wide_tc_kernel's, with the widths halved for
// fp32 operands so that the same shared memory holds them. One block of
// 256 threads per SM walks its split in tiles of TF_COLS = 128 catalog
// columns, and each group of up to TC_ROWS = 256 batch rows (one group for
// B <= 256) in 2 Hp / 32 + Hp / 16 steps (Hp = H up to a multiple of 32),
// the next step's state chunk and table rows in flight by cp.async while a
// step computes (a ring of two slots, one barrier a step). The copies read
// the fp32 inputs as they are, zero-filled past B, V and H:
//   logits   for each 64-column sub-tile of the tile, Hp / 32 steps of 32
//            hidden columns: the group's [256 x 64] logits S . T_sub^T
//            accumulated over the hidden chunks (8 warps as 4 x 2, 64 x 32
//            each, A and B through ldmatrix); then p into the tile's p
//            [256 x 128], fp32, in shared memory;
//   products Hp / 16 steps, each for one 16-column hidden chunk of the
//            tile's 128 table rows: warps 0-3 dT[tile, chunk] = p^T .
//            S[:, chunk] (32 catalog columns each, K = 256), warps 4-7
//            ds[:, chunk] += p . T[tile, chunk] (64 batch rows each, K =
//            128): 128 three-pass MMAs a warp either way. dT is written once
//            (a later group adds to it); the split's ds_part is read and
//            written once per tile (the split's first tile only writes), in
//            the ds warps' fragment order (ce_ds_reduce_tc_kernel<true>).
// Then the one-hot term dT[a_i] -= dloss_i * s_i as the other routes take
// it: on the tile's finished dT rows in device memory, from the states,
// in ascending i. The sums run in a fixed order and ds_part is summed in
// split order: two calls give the same bits.
//
// Accuracy. A tensor core aligns the addends of its sum to the largest,
// the accumulator included, and truncates: every MMA into a large running
// sum loses up to an ulp of it (tensor_core.cuh). So no sum runs long on
// the tensor cores: each step's sums start from 0 (the logits' over 32
// hidden columns, dT's over the group's rows in two interleaved halves,
// ds's over the tile's 128 columns) and are added to the running logits,
// to dT from an earlier group and to ds_part from an earlier tile with one
// fp32 rounding each (the carried values are loaded at the end of the step
// before, so that the loads are in flight while it waits at the barrier).
// With every sum carried through the tensor cores, a first version of this
// kernel missed parity.WIDE_GRAD_TOL on the H100; with the sums a step
// long it comes nearer an fp64 reference than the fp32 plain version does
// (PERF.md, tools/ablate_ce_tc.py).
//
// Fragments. Where k lies along a stored row (the logits' S and T, the ds
// product's p) the fragments come by ldmatrix. Elsewhere a lane loads
// 32-bit values itself, and the products choose the order of k and of the
// rows and columns (tensor_core.cuh) so that each load takes two
// neighbours: the dT product's lane (g, t) takes batch rows k + 2t and
// k + 2t + 1 for k t and t + 4, p's catalog columns 2g and 2g + 1 for rows
// g and g + 8, and hidden columns 2g + j for column g of n8 fragment j, as
// does the ds product's B. Every load of a warp falls on distinct banks:
// row strides of 36 floats for the logits slot, 132 for p, 20 for the
// products slot's states and 24 for its table rows. A lane's two n8
// fragments then hold four neighbouring hidden columns, so dT goes out as
// float4 stores. The hi/lo split is done in registers once per fragment
// load: hi as cvt.rna.tf32.f32 rounds, in two integer instructions, and an
// fp32 subtract for lo (tensor_core.cuh: split_tf32).
//
// Bytes at B=256, V=1M, H=512, per 128-column tile: the table rows from
// device memory once (256 KB; the products steps take them again from
// L2), dT written once (256 KB), ds_part read and written once (1 MB):
// 11.8 GB over 7,813 tiles; through L2 besides, the fp32 states three
// times (1.5 MB). Shared memory: p 135,168 B, two slots 92,160 (a logits
// slot, 46,080, holds a products slot, 32,768), logZ and dloss 2,048:
// 229,376 B at any H; 251 registers, no spills.
// On one "NVIDIA H100 80GB HBM3, 700.00 W" at B=256, V=1M, H=512 it takes
// ~14.7 ms (PERF.md row 4w; the FMA kernel it replaced ~29.3), 32% of its
// bound and 1.24x the library call (cuBLAS SGEMM). It issues its 1.15 G
// mma.sync at ~79 G/s, the rate ce_fwd_wide_tc_kernel's MMAs reach alone
// (tools/ablate_ce_tc.py): mma.sync issue bounds it, and wgmma, whose TF32
// form takes both operands K-major from shared memory, is the next step.

constexpr int TF_COLS = 128;             // catalog columns per tile: one ds_part update
constexpr int TF_SUB = 64;               // catalog columns per logits sub-tile
constexpr int TF_HL = 32;                // hidden columns per logits step (H is padded to a multiple)
constexpr int TF_HP = 16;                // hidden columns per products step
constexpr int TF_LDL = TF_HL + 4;        // a logits slot's row stride (floats)
constexpr int TF_LDS = TF_HP + 4;        // a products slot's states row stride
constexpr int TF_LDT = TF_HP + 8;        // ... and its table rows'
constexpr int TF_LDP = TF_COLS + 4;      // p's row stride
// a logits slot: states [TC_ROWS][TF_LDL], then table rows [TF_SUB][TF_LDL];
// a products slot: states [TC_ROWS][TF_LDS], then table rows [TF_COLS][TF_LDT]
constexpr int TF_LSLOT = (TC_ROWS + TF_SUB) * TF_LDL;
constexpr int TF_PSLOT = TC_ROWS * TF_LDS + TF_COLS * TF_LDT;
constexpr long long TF_SMEM = 4LL * (TC_ROWS * TF_LDP + 2 * TF_LSLOT + 2 * TC_ROWS);  // 229,376 B
static_assert(TF_SMEM <= MAX_SMEM && TF_COLS == 2 * TF_SUB && TF_COLS % VT == 0 &&
                  TF_HL == 2 * TF_HP && THREADS == 256 && TC_ROWS == 256,
              "8 warps: logits 4 x 2 warps of 64 x 32, products 4 dT warps of 32 columns and 4 ds "
              "warps of 64 rows");
// As in ce_bwd_wide_tc_kernel, both kinds of slot share one region of two
// logits slots, and products slot 0 must end before logits slot 1 begins.
static_assert(TF_PSLOT <= TF_LSLOT, "products slot 0 ends before logits slot 1");
// ldmatrix rows (and k t of a scalar load) 16 bytes apart mod 128: strides
// of 4 mod 8 floats; the ds product's B loads k t four rows of 24 apart
static_assert(TF_LDL % 8 == 4 && TF_LDP % 8 == 4 && TF_LDS % 8 == 4 && TF_LDT % 32 == 24,
              "every fragment load of a warp on distinct banks");

// Rows of a row-major fp32 matrix into shared memory by cp.async
// (tensor_core.cuh, shared with streaming_rank.cu), 256 threads a block.
using tc::copy_chunk_async;
static_assert(THREADS == 256, "copy_chunk_async's threads");

__global__ void __launch_bounds__(THREADS, 1)
ce_bwd_wide_tf32_kernel(const float* __restrict__ states, const float* __restrict__ table,
                        const long long* __restrict__ answers, const float* __restrict__ logz,
                        const float* __restrict__ dloss, int B, int V, int H, int n_valid,
                        int tiles_per_split, float* __restrict__ ds_part,
                        float* __restrict__ dtable) {
  extern __shared__ __align__(16) float smem[];
  float* sP = smem;                   // [TC_ROWS][TF_LDP] p of the tile
  float* sR = sP + TC_ROWS * TF_LDP;  // [2][TF_LSLOT] the slots
  float* sZ = sR + 2 * TF_LSLOT;      // [TC_ROWS] logZ
  float* sD = sZ + TC_ROWS;           // [TC_ROWS] dloss
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int Hp = round_up(H, TF_HL), nl = Hp / TF_HL, np = Hp / TF_HP;
  const int n_lg = (TF_COLS / TF_SUB) * nl, n_steps = n_lg + np;
  const int n_groups = (B + TC_ROWS - 1) / TC_ROWS;
  const int split = blockIdx.x;
  const int n_tiles = (V + VT - 1) / VT;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(t_begin + tiles_per_split, n_tiles);
  // the logits' warp tile (rows 64 wm, columns 32 wn of a sub-tile); the
  // products' (warps 0-3: dT's catalog columns pm, 32 of them; 4-7: ds's
  // batch rows pm, 64 of them)
  const int wm = warp & 3, wn = warp >> 2;
  const bool dt_warp = warp < 4;
  const int pm = dt_warp ? 32 * warp : 64 * (warp - 4);

  for (int t = t_begin; t < t_end; t += TF_COLS / VT) {
    const int j0 = t * VT;
    for (int g0 = 0; g0 < B; g0 += TC_ROWS) {
      // step s: s < n_lg the logits of sub-tile s / nl at hidden chunk
      // s % nl, else the products at chunk s - n_lg; its slot is s & 1
      auto slot = [&](int s) { return sR + (s & 1) * (s < n_lg ? TF_LSLOT : TF_PSLOT); };
      auto issue = [&](int s) {
        float* dst = slot(s);
        if (s < n_lg) {
          const int h0 = (s % nl) * TF_HL;
          copy_chunk_async<TC_ROWS, TF_HL>(dst, TF_LDL, states, g0, B, H, h0);
          copy_chunk_async<TF_SUB, TF_HL>(dst + TC_ROWS * TF_LDL, TF_LDL, table,
                                          j0 + (s / nl) * TF_SUB, V, H, h0);
        } else {
          const int h0 = (s - n_lg) * TF_HP;
          copy_chunk_async<TC_ROWS, TF_HP>(dst, TF_LDS, states, g0, B, H, h0);
          copy_chunk_async<TF_COLS, TF_HP>(dst + TC_ROWS * TF_LDS, TF_LDT, table, j0, V, H, h0);
        }
      };
      // step s begins: its copies have landed and every thread is done
      // with step s - 1's slot; step s + 1's copies go out
      auto begin = [&](int s) {
        onchip::cp_async_wait_all();
        __syncthreads();
        if (s + 1 < n_steps) issue(s + 1);
        onchip::cp_async_commit();
      };
      // this ds warp's fragments of products step s in ds_part: blocks of
      // 64 x TF_HP floats for (group, step, ds warp), float4 q = 2 i + half
      // of lane l at (q * 32 + l) * 4 (ce_ds_reduce_tc_kernel<true>), so
      // that each warp-wide access moves 512 contiguous bytes
      auto ds_frag = [&](int s) {
        return reinterpret_cast<float4*>(
            ds_part + ((((size_t)split * n_groups + g0 / TC_ROWS) * np + (s - n_lg)) * 4 +
                       (warp - 4)) * (64 * TF_HP) + lane * 4);
      };
      // A products step's sums start from 0 and are added, with one fp32
      // rounding, to what an earlier group (dT) or tile (ds_part) wrote
      // there, by this same thread: prev, loaded at the end of the step
      // before, so that the loads are in flight while it waits at the
      // barrier. A
      // lane's float4 q = 2 i + e / 2 holds, of m16 fragment i, hidden
      // columns 4t .. 4t + 3 of the chunk for its row e = 0 or 2: dT's
      // catalog column pm + 16 i + 2g + e / 2, ds's batch row pm + 16 i +
      // g + 4e.
      float4 prev[8];
      auto dt_at = [&](int q, int h0) -> float* {
        const int m = j0 + pm + 16 * (q >> 1) + 2 * g + (q & 1), h = h0 + 4 * t4;
        return m < V && h < H ? dtable + (size_t)m * H + h : nullptr;
      };
      auto carry = [&](int s) {
        const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
        if (dt_warp) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float* src = g0 > 0 ? dt_at(q, (s - n_lg) * TF_HP) : nullptr;
            prev[q] = src ? *reinterpret_cast<const float4*>(src) : zero;
          }
        } else {
          const float4* src = ds_frag(s);
#pragma unroll
          for (int q = 0; q < 8; ++q) prev[q] = t != t_begin ? src[q * 32] : zero;
        }
      };

      __syncthreads();  // every reader of the slots, sZ and sD before is done
      for (int r = tid; r < TC_ROWS; r += THREADS) {
        const int row = g0 + r;
        sZ[r] = row < B ? logz[row] : 0.f;
        sD[r] = row < B ? dloss[row] : 0.f;
      }
      issue(0);
      onchip::cp_async_commit();

      // the logits steps: acc[i][j] += S[64 wm + 16 i, :] . T[32 wn + 8 j, :]^T,
      // half the warp tile's rows at a time, each step's sum taken on the
      // tensor cores from 0 and added to acc with one fp32 rounding
      // (tensor_core.cuh: mma_3xtf32)
      float acc[4][4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
      for (int s = 0; s < n_lg; ++s) {
        begin(s);
        const float* S = slot(s);
        const float* T = S + TC_ROWS * TF_LDL;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          float part[2][4][4] = {};
#pragma unroll
          for (int kk = 0; kk < TF_HL; kk += 8) {
            uint32_t ah[2][4], al[2][4], bh[4][2], bl[4][2];
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              uint32_t r[4];
              tc::ldmatrix_x4(r, S + (64 * wm + 32 * hf + 16 * i + tc::a_row(lane)) * TF_LDL + kk +
                                     tc::a_col32(lane));
#pragma unroll
              for (int e = 0; e < 4; ++e) tc::split_tf32(r[e], ah[i][e], al[i][e]);
            }
#pragma unroll
            for (int jp = 0; jp < 2; ++jp) {
              uint32_t r[4];
              tc::ldmatrix_x4(r, T + (32 * wn + 16 * jp + tc::b_row(lane)) * TF_LDL + kk +
                                     tc::b_col32(lane));
#pragma unroll
              for (int e = 0; e < 4; ++e)
                tc::split_tf32(r[e], bh[2 * jp + (e >> 1)][e & 1], bl[2 * jp + (e >> 1)][e & 1]);
            }
            tc::mma_3xtf32(part, ah, al, bh, bl);
          }
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[2 * hf + i][j][e] += part[i][j][e];
        }
        if (s % nl == nl - 1) {  // the sub-tile's logits are complete: p into sP
          const int sub = s / nl;
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int r = 64 * wm + 16 * i + g + 8 * half;
              const bool row_ok = g0 + r < B;
              const float z = sZ[r], d = sD[r];
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                const int c = TF_SUB * sub + 32 * wn + 8 * j + 2 * t4, col = j0 + c;
                const float p0 = (row_ok && col < n_valid) ? expf(acc[i][j][2 * half] - z) * d : 0.f;
                const float p1 =
                    (row_ok && col + 1 < n_valid) ? expf(acc[i][j][2 * half + 1] - z) * d : 0.f;
                *reinterpret_cast<float2*>(sP + r * TF_LDP + c) = make_float2(p0, p1);
                acc[i][j][2 * half] = acc[i][j][2 * half + 1] = 0.f;
              }
            }
        }
      }
      carry(n_lg);

      // the products steps
      for (int s = n_lg; s < n_steps; ++s) {
        begin(s);
        const float* S = slot(s);
        const int h0 = (s - n_lg) * TF_HP;
        if (dt_warp) {
          // c[u][i][j] += p[:, pm + 16 i]^T . S[:, j], K = the group's rows,
          // the k8 blocks k + 8u (u = 0, 1) summed apart and added at the
          // end (twice the independent accumulators): lane (g, t) takes rows
          // k + 8u + 2t (k t) and k + 8u + 2t + 1 (k t + 4), p's columns 2g
          // (row g) and 2g + 1 (row g + 8), S's columns 2g + j
          float c[2][2][2][4] = {};
          const float* P = sP + pm + 2 * g;
          const float* Sg = S + 2 * g;
#pragma unroll 2
          for (int k = 0; k < TC_ROWS; k += 16) {
            uint32_t ah[2][2][4], al[2][2][4], bh[2][2][2], bl[2][2][2];
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              const int r0 = k + 8 * u + 2 * t4;
#pragma unroll
              for (int i = 0; i < 2; ++i)
#pragma unroll
                for (int e = 0; e < 2; ++e) {  // rows r0 + e: (a[0], a[1]), then (a[2], a[3])
                  const float2 v = *reinterpret_cast<const float2*>(P + (r0 + e) * TF_LDP + 16 * i);
                  tc::split_tf32(__float_as_uint(v.x), ah[u][i][2 * e], al[u][i][2 * e]);
                  tc::split_tf32(__float_as_uint(v.y), ah[u][i][2 * e + 1], al[u][i][2 * e + 1]);
                }
#pragma unroll
              for (int e = 0; e < 2; ++e) {  // rows r0 + e: (b[0][e], b[1][e])
                const float2 v = *reinterpret_cast<const float2*>(Sg + (r0 + e) * TF_LDS);
                tc::split_tf32(__float_as_uint(v.x), bh[u][0][e], bl[u][0][e]);
                tc::split_tf32(__float_as_uint(v.y), bh[u][1][e], bl[u][1][e]);
              }
            }
#pragma unroll
            for (int pass = 0; pass < 3; ++pass)  // the two blocks' passes interleaved
#pragma unroll
              for (int u = 0; u < 2; ++u) tc::mma_pass(pass, c[u], ah[u], al[u], bh[u], bl[u]);
          }
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int i = q >> 1, e = 2 * (q & 1);
            float* dst = dt_at(q, h0);
            if (dst)
              *reinterpret_cast<float4*>(dst) = make_float4(
                  prev[q].x + (c[0][i][0][e] + c[1][i][0][e]), prev[q].y + (c[0][i][1][e] + c[1][i][1][e]),
                  prev[q].z + (c[0][i][0][e + 1] + c[1][i][0][e + 1]),
                  prev[q].w + (c[0][i][1][e + 1] + c[1][i][1][e + 1]));
          }
        } else {
          // c[i][j] += p[pm + 16 i, :] . T[:, j], K = the tile's columns:
          // A by ldmatrix; B's lane (g, t) takes T rows k + t and k + t + 4,
          // columns 2g + j
          float c[4][2][4] = {};
          const float* Tg = S + TC_ROWS * TF_LDS + 2 * g;
#pragma unroll 2
          for (int k = 0; k < TF_COLS; k += 8) {
            uint32_t ah[4][4], al[4][4], bh[2][2], bl[2][2];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              uint32_t r[4];
              tc::ldmatrix_x4(r, sP + (pm + 16 * i + tc::a_row(lane)) * TF_LDP + k +
                                     tc::a_col32(lane));
#pragma unroll
              for (int e = 0; e < 4; ++e) tc::split_tf32(r[e], ah[i][e], al[i][e]);
            }
#pragma unroll
            for (int e = 0; e < 2; ++e) {  // rows k + t + 4e: (b[0][e], b[1][e])
              const float2 v = *reinterpret_cast<const float2*>(Tg + (k + t4 + 4 * e) * TF_LDT);
              tc::split_tf32(__float_as_uint(v.x), bh[0][e], bl[0][e]);
              tc::split_tf32(__float_as_uint(v.y), bh[1][e], bl[1][e]);
            }
            tc::mma_3xtf32(c, ah, al, bh, bl);
          }
          float4* dst = ds_frag(s);
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            const int i = q >> 1, e = 2 * (q & 1);
            dst[q * 32] = make_float4(prev[q].x + c[i][0][e], prev[q].y + c[i][1][e],
                                      prev[q].z + c[i][0][e + 1], prev[q].w + c[i][1][e + 1]);
          }
        }
        if (s + 1 < n_steps) carry(s + 1);
      }
    }
    // the one-hot term, as ce_bwd_wide_tc_kernel takes it, on the tile's
    // finished dT rows in device memory
    int hit = 0;
    for (int i = tid; i < B; i += THREADS) {
      const long long a = __ldg(answers + i);
      hit |= in_catalog(a, n_valid) && a >= j0 && a < j0 + TF_COLS;
    }
    if (__syncthreads_or(hit)) {  // also the barrier after every dT write of the tile
      for (int h = tid; h < H; h += THREADS) {
        for (int i = 0; i < B; ++i) {
          const long long a = __ldg(answers + i);
          if (in_catalog(a, n_valid) && a >= j0 && a < j0 + TF_COLS)
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

// ds [B, H] from the wide tensor-core kernels' partials, which hold each
// split's [Bp, Hp] in the fragment order of their ds warps: blocks of
// 64 x HPW floats for (row group of 256, products step kc, ds warp w), in
// which, for lane l (g = l >> 2, t = l & 3), float c of float4 q is
//   - ce_bwd_wide_tc_kernel (HPW = TC_HP = 32, q = 4 i + j): row 256 group
//     + 64 w + 16 i + g + 8 (c >> 1), column 32 kc + 8 j + 2 t + (c & 1);
//   - ce_bwd_wide_tf32_kernel (TF32, HPW = TF_HP = 16, q = 2 i + half):
//     row 256 group + 64 w + 16 i + g + 8 half, column 16 kc + 4 t + c.
// One thread per float of that order (reads coalesced): the sum over the
// splits in split order, then, as ce_ds_reduce_kernel, minus dloss_i *
// table[a_i][h] with one rounding each, written to its row and column when
// they lie inside [B, H].
template <bool TF32>
__global__ void __launch_bounds__(REDUCE_THREADS)
ce_ds_reduce_tc_kernel(const float* __restrict__ ds_part, const float* __restrict__ table,
                       const long long* __restrict__ answers, const float* __restrict__ dloss,
                       int B, int H, int Bp, int Hp, int n_valid, int n_splits,
                       float* __restrict__ ds) {
  constexpr int HPW = TF32 ? TF_HP : TC_HP, BLK = 64 * HPW;
  const int n = Bp * Hp;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const int blk = idx / BLK, f = idx % BLK, w = blk & 3, kc = (blk >> 2) % (Hp / HPW);
  const int grp = (blk >> 2) / (Hp / HPW), q = f >> 7, l = (f >> 2) & 31, c = f & 3;
  const int row = TF32 ? TC_ROWS * grp + 64 * w + 16 * (q >> 1) + (l >> 2) + 8 * (q & 1)
                       : TC_ROWS * grp + 64 * w + 16 * (q >> 2) + (l >> 2) + 8 * (c >> 1);
  const int h = TF32 ? HPW * kc + 4 * (l & 3) + c : HPW * kc + 8 * (q & 3) + 2 * (l & 3) + (c & 1);
  if (row >= B || h >= H) return;
  float total = 0.f;
  for (int s = 0; s < n_splits; ++s) total += ds_part[(size_t)s * n + idx];
  const long long a = __ldg(answers + row);
  if (in_catalog(a, n_valid))
    total = __fsub_rn(total, __fmul_rn(__ldg(dloss + row), __ldg(table + (size_t)a * H + h)));
  ds[(size_t)row * H + h] = total;
}

// ---- the bf16-operand form of the wide forward, on the tensor cores ---------
//
// ce_fwd_wide_tc_kernel: the forward's pass 1 in the bf16-operand form at
// H > MAX_H, the counterpart of pallas_ce.py:222 _fwd_kernel with
// dtype="bfloat16", which rounds the states and each table tile to bf16
// (pallas_ce.py:234-237) and takes the dot on the MXU with fp32
// accumulation; before it, the rounded operands ran through the fp32
// form's FMA loops.
//
// Bound at B=256, V=1M, H=512: the fp32 table read once, 2.05 GB, 0.612
// ms at 3.35 TB/s; the logits' 262 GFLOP take 0.265 ms at the bf16 tensor
// rate (989 TFLOP/s). Each table element (4 bytes) buys 2 B = 512 flop,
// 128 flop a byte, under the H100's ~295 bf16 flop a byte: a design that
// reads the table once is bound by its bytes, and needs ~430 TFLOP/s of
// tensor-core work (43% of the rate) to reach that bound.
//
// What the design does about it:
//   - the table is read from device memory once: one block of 256
//     threads per SM walks its split in tiles of FT_COLS = 128 catalog
//     columns, each tile against a whole group of up to TC_ROWS = 256
//     batch rows (one group for B <= 256), so no tile is read twice;
//   - the logits run on the tensor cores (tensor_core.cuh, mma.sync
//     m16n8k16, bf16 operands, fp32 accumulators): 8 warps as 4 x 2 warp
//     tiles of 64 rows x 64 columns, 128 accumulators a thread, summed
//     over Hp / 64 steps of 64 hidden columns (Hp = H up to a multiple of
//     64, the padding zero). A step is 128 MMAs a warp behind one barrier,
//     and every ldmatrix feeds 8 MMAs (ce_bwd_wide_tc_kernel's logits
//     steps: 64 and 4);
//   - copies overlap the MMAs through a ring of FT_STAGES = 4 slots, each
//     a states chunk [256][64] and a table chunk [128][64] in bf16. The
//     states come rounded from a [Bp, Hp] bf16 scratch (states_bf16_kernel,
//     Bp = B up to a multiple of 256), by cp.async three steps ahead. The
//     table is fp32 in device memory and cp.async and TMA cannot convert,
//     so each thread loads its 8 float4s of step s + 1 into registers at
//     the top of step s and rounds (nearest, ties to even) and stores them
//     into their slot after step s's MMAs: the loads are in flight for a
//     whole step, and nothing writes the rounded tile back;
//   - after a tile's last step each thread folds its logits, in
//     registers, into an online (max, sum) for each of its 8 rows
//     (columns >= n_valid masked; fold_tile); nothing goes through shared
//     memory.
// Then, once per group, the 4 lanes of a quad merge their (m, s) by
// shuffles, the two warps that share rows merge through shared memory
// (warp column 0's first), and lane t = 0 of warp column 0 writes one
// (m, s) per (split, row) (merge_group); ce_fwd_merge_kernel merges the
// splits in split order. Every merge runs in a fixed order: two calls
// give the same bits.
// The states are re-read from L2 once a tile (256 KB at H = 512, as many
// bytes as the tile's table rows): a wider tile would halve that but
// needs twice the accumulators. Rows are padded by 16 bytes (144 B), so
// the eight rows of each ldmatrix matrix fall on distinct banks. Shared
// memory: 4 slots of 55,296 B and the warps' exchange, 2,048: 223,232 B
// at any H; 253 registers, no spills.
// On one "NVIDIA H100 80GB HBM3, 700.00 W" at B=256, V=1M, H=512 it takes
// ~1.08 ms, 57% of its bound (the form it replaced ~10.1-10.5 ms, in turns,
// tools/time_kernels.py). tools/ablate_ce_tc.py: with only its MMAs and
// epilogue (no copies, loads or stores) ~0.82 ms, with everything but the
// MMAs ~1.02: the mma.sync rate (~370 TFLOP/s) and the memory path (the
// table from device memory, the states again from L2 every tile) each
// come near the whole, so a gain needs both: wgmma, and fewer bytes
// through L2 (states shared by the blocks of a cluster). Prefetching the
// table into L2 two to six steps ahead, streaming (evict-first) loads,
// issuing each step's loads before its barrier and __expf in the epilogue
// were each no faster.

constexpr int FT_COLS = 128;          // catalog columns per tile
constexpr int FT_LD = TC_HL + 8;      // a slot's row stride (bf16)
constexpr int FT_STAGES = 4;          // slots in the ring
constexpr int FT_SLOT = (TC_ROWS + FT_COLS) * FT_LD;  // states [TC_ROWS][FT_LD], then table [FT_COLS][FT_LD]
constexpr long long FT_SMEM = 2LL * FT_STAGES * FT_SLOT + 4LL * 2 * TC_ROWS;  // 223,232 B
static_assert(FT_SMEM <= MAX_SMEM && FT_COLS % VT == 0 && THREADS == 256 && TC_ROWS == 256,
              "8 warps as 4 x 2 warp tiles of 64 x 64 over a 256 x 128 tile");

// The epilogue of both wide forward kernels, whose 8 warps hold the logits
// of a group of up to 256 batch rows x FT_COLS catalog columns as 4 x 2
// warp tiles of 64 x 64 (warp w: rows 64 (w & 3), columns 64 (w >> 2)), in
// mma.sync's accumulator layout: acc[i][j][2 half + e] at row 16 i + g +
// 8 half and column 8 j + 2 t + e of the warp tile (lane l, g = l >> 2,
// t = l & 3). Each thread keeps an online (max, sum) for each of its 8
// rows q = 2 i + half.
//
// fold_tile folds a finished tile's logits (catalog columns j0 ..) into
// them: the columns >= n_valid masked, the 16 logits of a row first
// maxed, the sum rescaled at most once; then it zeroes acc for the next
// tile.
__device__ __forceinline__ void fold_tile(float (&acc)[4][8][4], float (&m)[8], float (&sum)[8],
                                          int j0, int n_valid) {
  // this thread's columns: c0 + 8 j + {0, 1}
  const int c0 = j0 + 64 * (threadIdx.x >> 7) + 2 * (threadIdx.x & 3);
  const bool ragged = j0 + FT_COLS > n_valid;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int q = 2 * i + half;
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (ragged && c0 + 8 * j + e >= n_valid) acc[i][j][2 * half + e] = -INFINITY;
          tmax = fmaxf(tmax, acc[i][j][2 * half + e]);
        }
      if (tmax > -INFINITY) {
        if (tmax > m[q]) {
          sum[q] *= expf(m[q] - tmax);  // exp(-inf) = 0 on the row's first column
          m[q] = tmax;
        }
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) sum[q] += expf(acc[i][j][2 * half + e] - m[q]);
      }
    }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
}

// merge_group ends a group (rows g0 + r, r < 256) after its last fold:
// the 4 lanes of a quad merge their (m, sum) by shuffles (offsets 1, 2),
// warp column 1 hands its rows to warp column 0 through xm and xs
// ([256] each in shared memory), which merges them after its own, and
// lane t = 0 of warp column 0 writes one (m, s) per (split, row < B). A
// barrier inside: every thread of the block calls it. Every merge runs in
// a fixed order, so two calls give the same bits. WG_ROWS: the rows of
// wgmma's layout (ce_fwd_mid_tf32_kernel: row q = 2 i + half of a thread
// is 64 i + 16 (w & 3) + g + 8 half, its columns as above).
template <bool WG_ROWS = false>
__device__ __forceinline__ void merge_group(float (&m)[8], float (&sum)[8], float* xm, float* xs,
                                            int g0, int B, float* __restrict__ part_m,
                                            float* __restrict__ part_s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3, wm = warp & 3, wn = warp >> 2;
#pragma unroll
  for (int q = 0; q < 8; ++q)
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const float om = __shfl_xor_sync(FULL, m[q], off);
      const float os = __shfl_xor_sync(FULL, sum[q], off);
      const float mm = fmaxf(m[q], om);
      if (mm > -INFINITY) {
        sum[q] = sum[q] * expf(m[q] - mm) + os * expf(om - mm);
        m[q] = mm;
      }
    }
  if (wn == 1 && t4 == 0) {
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int r = WG_ROWS ? 64 * (q >> 1) + 16 * wm + g + 8 * (q & 1) : 64 * wm + 16 * (q >> 1) + g + 8 * (q & 1);
      xm[r] = m[q];
      xs[r] = sum[q];
    }
  }
  __syncthreads();
  if (wn == 0 && t4 == 0) {
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int r = WG_ROWS ? 64 * (q >> 1) + 16 * wm + g + 8 * (q & 1) : 64 * wm + 16 * (q >> 1) + g + 8 * (q & 1);
      const int row = g0 + r;
      const float om = xm[r], os = xs[r];
      const float mm = fmaxf(m[q], om);
      if (mm > -INFINITY) {
        sum[q] = sum[q] * expf(m[q] - mm) + os * expf(om - mm);
        m[q] = mm;
      }
      if (row < B) {
        part_m[(size_t)blockIdx.x * B + row] = m[q];
        part_s[(size_t)blockIdx.x * B + row] = sum[q];
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1)
ce_fwd_wide_tc_kernel(const __nv_bfloat16* __restrict__ sb, const float* __restrict__ table,
                      int B, int V, int H, int n_valid, int tiles_per_split,
                      float* __restrict__ part_m, float* __restrict__ part_s) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(tc_smem);   // [FT_STAGES][FT_SLOT]
  float* xm = reinterpret_cast<float*>(ring + FT_STAGES * FT_SLOT);  // [TC_ROWS] warp column 1's m
  float* xs = xm + TC_ROWS;                                           // [TC_ROWS] ... and its sum
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2;  // the warp tile: rows 64 wm, columns 64 wn of a tile
  const int Hp = round_up(H, TC_HL), nk = Hp / TC_HL;
  const int per = tiles_per_split / (FT_COLS / VT);
  const int n_tiles = (V + FT_COLS - 1) / FT_COLS;
  const int t_begin = blockIdx.x * per, t_end = min(t_begin + per, n_tiles);
  const int n_steps = max(t_end - t_begin, 0) * nk;

  // step s: hidden chunk s % nk of tile t_begin + s / nk, in slot s % FT_STAGES
  auto slot = [&](int s) { return ring + (s % FT_STAGES) * FT_SLOT; };
  float4 rows[8];  // a step's table rows in fp32, loaded a step ahead
  auto load_rows = [&](int s) {
    const int h0 = (s % nk) * TC_HL, c0 = (t_begin + s / nk) * FT_COLS;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int i = tid + THREADS * q, r = i >> 4, h = h0 + (i & 15) * 4;
      rows[q] = (c0 + r < V && h < H)
                    ? __ldg(reinterpret_cast<const float4*>(table + (size_t)(c0 + r) * H + h))
                    : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  auto store_rows = [&](int s) {  // rows, rounded to bf16, into step s's slot
    __nv_bfloat16* dst = slot(s) + TC_ROWS * FT_LD;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int i = tid + THREADS * q, r = i >> 4, c4 = (i & 15) * 4;
      *reinterpret_cast<uint2*>(dst + r * FT_LD + c4) =
          make_uint2(tc::pack_bf16(rows[q].x, rows[q].y), tc::pack_bf16(rows[q].z, rows[q].w));
    }
  };

  for (int g0 = 0; g0 < B; g0 += TC_ROWS) {
    auto copy_states = [&](int s) {  // step s's states chunk, by cp.async from sb
      __nv_bfloat16* dst = slot(s);
      const int h0 = (s % nk) * TC_HL;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int i = tid + THREADS * q, r = i >> 3, c8 = (i & 7) * 8;
        tc::cp_async_16(dst + r * FT_LD + c8, sb + (size_t)(g0 + r) * Hp + h0 + c8);
      }
    };
    // row q = 2 i + half of this thread is 64 wm + 16 i + g + 8 half
    float m[8], sum[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      m[q] = -INFINITY;
      sum[q] = 0.f;
    }
    float acc[4][8][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

    __syncthreads();  // the group before is done with the ring, xm and xs
#pragma unroll
    for (int s = 0; s < FT_STAGES - 1; ++s) {
      if (s < n_steps) copy_states(s);
      onchip::cp_async_commit();
    }
    if (n_steps > 0) {
      load_rows(0);
      store_rows(0);
    }
    for (int s = 0; s < n_steps; ++s) {
      tc::cp_async_wait_group<FT_STAGES - 2>();  // this thread's copies of step s have landed
      __syncthreads();  // everyone's, and step s's table rows; step s - 1's MMAs are done
      if (s + FT_STAGES - 1 < n_steps) copy_states(s + FT_STAGES - 1);
      onchip::cp_async_commit();  // (empty past the last step: one group a step)
      if (s + 1 < n_steps) load_rows(s + 1);
      const __nv_bfloat16* S = slot(s);
      const __nv_bfloat16* T = S + TC_ROWS * FT_LD;
      // acc[i][j] += S[64 wm + 16 i, :] . T[64 wn + 8 j, :]^T over the chunk
#pragma unroll
      for (int k16 = 0; k16 < TC_HL; k16 += 16) {
        uint32_t a[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          tc::ldmatrix_x4(a[i], S + (64 * wm + 16 * i + tc::a_row(lane)) * FT_LD + k16 +
                                    tc::a_col(lane));
#pragma unroll
        for (int jp = 0; jp < 4; ++jp) {
          uint32_t r[4];
          tc::ldmatrix_x4(r, T + (64 * wn + 16 * jp + tc::b_row(lane)) * FT_LD + k16 +
                                 tc::b_col(lane));
          const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            tc::mma_bf16(acc[i][2 * jp], a[i], b0);
            tc::mma_bf16(acc[i][2 * jp + 1], a[i], b1);
          }
        }
      }
      if (s % nk == nk - 1)  // the tile's logits are complete: fold them into (m, sum)
        fold_tile(acc, m, sum, (t_begin + s / nk) * FT_COLS, n_valid);
      if (s + 1 < n_steps) store_rows(s + 1);  // its slot was last read by step s - 3
    }

    merge_group(m, sum, xm, xs, g0, B, part_m, part_s);
  }
}

// ---- the fp32 form of the wide forward, on the tensor cores in 3xTF32 --------
//
// ce_fwd_wide_tf32_kernel: the forward's pass 1 in the fp32 form at
// H > MAX_H, the counterpart of pallas_ce.py:222 _fwd_kernel at f32, whose
// logits are an f32 dot_general (pallas_ce.py:242-244). It takes
// ce_fwd_wide_tc_kernel's grid and epilogue and ce_bwd_wide_tf32_kernel's
// number format: the logits on the tensor cores in 3xTF32 (tensor_core.cuh:
// each fp32 operand as a TF32 hi and lo, three mma.sync m16n8k8 a
// product), which keeps fp32 accuracy; 1xTF32 keeps about three digits
// and would not be the same function.
//
// Bound at B=256, V=1M, H=512: 3 x 2BVH = 786.43 GFLOP, three TF32 passes
// of the logits at the dense TF32 rate (495 TFLOP/s), 1.589 ms; the fp32
// table read once, 2.05 GB, 0.612 ms at 3.35 TB/s. (The same work in fp32
// FMAs is 3.913 ms at 67 TFLOP/s; the FMA kernel this one replaced took
// ~10.2 ms: it read the table once per 64-row batch tile and fed 8 FMAs
// per shared-memory load.)
//
// What the design does about it:
//   - the table is read from device memory once: one block of 256 threads
//     per SM walks its split in tiles of FT_COLS = 128 catalog columns,
//     each against a whole group of up to TC_ROWS = 256 batch rows, as
//     ce_fwd_wide_tc_kernel does;
//   - 8 warps as 4 x 2 warp tiles of 64 x 64 (that kernel's, so that the
//     epilogue is one function for both), the running logits in 128 fp32
//     registers a thread. Per k8 block of a step and per m16 fragment i
//     the three passes' sums start from 0 (part, 32 registers) and are
//     added to the running logits with one fp32 rounding: a tensor core
//     truncates its sum to its largest addend, so a sum carried through
//     many MMAs drifts (ce_bwd_wide_tf32_kernel's head);
//   - a step's state rows and table rows come by cp.async as they are,
//     zero-filled past B, V and H, two steps ahead through a ring of
//     FW_STAGES = 3 slots of 16 hidden columns ([256][20] states, [128][20]
//     table rows), one barrier a step; each fragment is one ldmatrix, split
//     into hi and lo in registers (tensor_core.cuh: split_tf32), as
//     ce_bwd_wide_tf32_kernel takes its fragments;
//   - each thread's (max, sum) of its 8 rows waits in shared memory between
//     folds (16 KB), which leaves the registers to the MMA loop.
// A deviation from the design first planned: the hi/lo split was to be
// done once per staged element, into hi and lo planes in shared memory,
// so that the MMA loop would hold no split instruction. On the H100 that
// form (tools/ablate_ce_tc.py, "fwd32: split once per staged chunk": the
// rows copied into lo planes and each thread's pieces split in place a
// step ahead of the MMAs) was slower, ~5.8 ms against ~4.9 (PERF.md §6):
// the split pass, its shared-memory stores and the second ldmatrix of
// every fragment cost more than the split instructions they remove. (A
// first form split the states once a call into a hi/lo scratch by a
// kernel of its own: slower than the split per fragment load as well,
// and one device operation more a training step than chip_smoke.py
// allows.)
// Shared memory: 3 slots of 30,720 B, the (max, sum) 16,384, the warps'
// exchange 2,048: 110,592 B at any H; 255 registers, 48 bytes of spills.
// On one "NVIDIA H100 80GB HBM3, 700.00 W" at B=256, V=1M, H=512 it takes
// ~5.0 ms (PERF.md row 2w; the FMA kernel ~10.0 in turns), 32% of its
// bound and 0.74x its library call (cuBLAS SGEMM, then the softmax); its
// MMAs alone (with their fragment loads and splits) ~4.15 ms, its memory
// path alone ~1.55 (tools/ablate_ce_tc.py): the MMA loop bounds it.

// tensor_core.cuh's wide geometry, shared with streaming_rank.cu's
// rank_wide_tf32_kernel
constexpr int FW_HC = tc::WIDE_HC;               // hidden columns per step
constexpr int FW_LD = tc::WIDE_LD;               // a row's stride in a slot (floats)
constexpr int FW_STAGES = tc::WIDE_STAGES;       // slots in the ring
constexpr int FW_SPLANE = TC_ROWS * FW_LD;       // a slot's states
constexpr int FW_SLOT = FW_SPLANE + FT_COLS * FW_LD;  // states, then table rows
constexpr long long FW_SMEM = 4LL * (FW_STAGES * FW_SLOT + 16 * THREADS + 2 * TC_ROWS);  // 110,592 B
static_assert(FW_SMEM <= MAX_SMEM && FT_COLS == tc::WIDE_COLS && TC_ROWS == tc::WIDE_ROWS &&
                  THREADS == 256,
              "8 warps as 4 x 2 warp tiles of 64 x 64 over a 256 x 128 tile");
static_assert(FW_LD % 8 == 4 && FW_HC % 8 == 0,
              "the eight 16-byte rows of an ldmatrix matrix on distinct banks; whole k8 blocks");

__global__ void __launch_bounds__(THREADS, 1)
ce_fwd_wide_tf32_kernel(const float* __restrict__ states, const float* __restrict__ table, int B,
                        int V, int H, int n_valid, int tiles_per_split,
                        float* __restrict__ part_m, float* __restrict__ part_s) {
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;                      // [FW_STAGES][FW_SLOT]
  float* kept = ring + FW_STAGES * FW_SLOT;  // [16][THREADS] each thread's m[8], then sum[8]
  float* xm = kept + 16 * THREADS;         // [TC_ROWS] warp column 1's m
  float* xs = xm + TC_ROWS;                // [TC_ROWS] ... and its sum
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2;  // the warp tile: rows 64 wm, columns 64 wn of a tile
  const int nk = round_up(H, FW_HC) / FW_HC;
  const int per = tiles_per_split / (FT_COLS / VT);
  const int n_tiles = (V + FT_COLS - 1) / FT_COLS;
  const int t_begin = blockIdx.x * per, t_end = min(t_begin + per, n_tiles);
  const int n_steps = max(t_end - t_begin, 0) * nk;

  // step s: hidden chunk s % nk of tile t_begin + s / nk, in slot s % FW_STAGES
  auto slot = [&](int s) { return ring + (s % FW_STAGES) * FW_SLOT; };
  // a fragment's hi and lo, split in registers from one ldmatrix at p
  auto frags = [](uint32_t (&h)[4], uint32_t (&l)[4], const float* p) {
    tc::ldmatrix_x4(h, p);
#pragma unroll
    for (int e = 0; e < 4; ++e) tc::split_tf32(h[e], h[e], l[e]);
  };

  for (int g0 = 0; g0 < B; g0 += TC_ROWS) {
    auto issue = [&](int s) {  // step s's state and table rows, as they are
      float* S = slot(s);
      const int h0 = (s % nk) * FW_HC;
      copy_chunk_async<TC_ROWS, FW_HC>(S, FW_LD, states, g0, B, H, h0);
      copy_chunk_async<FT_COLS, FW_HC>(S + FW_SPLANE, FW_LD, table, (t_begin + s / nk) * FT_COLS,
                                       V, H, h0);
    };
    float acc[4][8][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      kept[q * THREADS + tid] = -INFINITY;
      kept[(8 + q) * THREADS + tid] = 0.f;
    }

    __syncthreads();  // the group before is done with the ring, xm and xs
#pragma unroll
    for (int s = 0; s < FW_STAGES - 1; ++s) {
      if (s < n_steps) issue(s);
      onchip::cp_async_commit();
    }
    for (int s = 0; s < n_steps; ++s) {
      tc::cp_async_wait_group<FW_STAGES - 2>();  // this thread's copies of step s have landed
      __syncthreads();  // everyone's; step s - 1's MMAs are done
      if (s + FW_STAGES - 1 < n_steps) issue(s + FW_STAGES - 1);
      onchip::cp_async_commit();  // (empty past the last step: one group a step)
      const float* S = slot(s);
      const float* T = S + FW_SPLANE;
      // acc[i][j] += S[64 wm + 16 i, :] . T[64 wn + 8 j, :]^T over the chunk
#pragma unroll
      for (int kk = 0; kk < FW_HC; kk += 8) {
        uint32_t bh[8][2], bl[8][2];
#pragma unroll
        for (int jp = 0; jp < 4; ++jp) {
          uint32_t rh[4], rl[4];
          frags(rh, rl, T + (64 * wn + 16 * jp + tc::b_row(lane)) * FW_LD + kk + tc::b_col32(lane));
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            bh[2 * jp + (e >> 1)][e & 1] = rh[e];
            bl[2 * jp + (e >> 1)][e & 1] = rl[e];
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          uint32_t ah[1][4], al[1][4];
          frags(ah[0], al[0], S + (64 * wm + 16 * i + tc::a_row(lane)) * FW_LD + kk + tc::a_col32(lane));
          float part[1][8][4] = {};
          tc::mma_3xtf32(part, ah, al, bh, bl);
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][j][e] += part[0][j][e];
        }
      }
      if (s % nk == nk - 1) {  // the tile's logits are complete: fold them into (m, sum)
        float m[8], sum[8];
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          m[q] = kept[q * THREADS + tid];
          sum[q] = kept[(8 + q) * THREADS + tid];
        }
        fold_tile(acc, m, sum, (t_begin + s / nk) * FT_COLS, n_valid);
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          kept[q * THREADS + tid] = m[q];
          kept[(8 + q) * THREADS + tid] = sum[q];
        }
      }
    }
    float m[8], sum[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      m[q] = kept[q * THREADS + tid];
      sum[q] = kept[(8 + q) * THREADS + tid];
    }
    merge_group(m, sum, xm, xs, g0, B, part_m, part_s);
  }
}

// ---- the bf16-operand form on the on-chip route, on the tensor cores -----------
//
// ce_fwd_onchip_tc_kernel and ce_bwd_onchip_tc_kernel: the forward's and the
// backward's pass 1 in the bf16-operand form at B <= OC_B and H <= OC_H (the
// counterparts of pallas_ce.py:222 _fwd_kernel and :340 _grads_kernel with
// dtype="bfloat16", whose products run on the MXU with f32 accumulation).
// Both run on tensor_core.cuh's on-chip skeleton: one block of 256 threads
// per SM over a split of whole tiles, every state row staged once in bf16
// (256 x 64, rows past B and columns past H zero), the table tiles through
// a cp.async ring of three fp32 staging slots (two tiles ahead in the
// forward, three in the backward), each thread rounding its own copies
// into a bf16 slot; every product is mma.sync m16n8k16 with bf16 operands
// and fp32 accumulators. A warp's MMAs cover only its m16 fragments with a
// row < B, their count a template parameter picked by one warp-uniform
// branch (so no MMA is predicated: predicated ones cost a warp
// synchronisation each), as rank_wide_tf32_kernel does. No scratch and no
// extra launch: each C entry is this sweep and its pass 2
// (ce_fwd_merge_kernel<true>, ce_ds_reduce_kernel).
//
// Bound at B=256, V=1M, H=64: the fp32 table read once, 256 MB (0.0765 ms
// at 3.35 TB/s), and for the backward the dT write, 256 MB more (0.1529
// ms); their products take 0.033 and 0.099 ms at the bf16 tensor rate
// (989 TFLOP/s). Each 4-byte table element buys 2 B = 512 flop a product,
// under the H100's ~295 bf16 flop a byte: read once, they are bound by
// their bytes. Before these kernels the bf16 form ran the fp32 form's FMA
// loops on rounded operands (0.489 and 1.467 ms of fp32 FMA work). Besides
// the bytes, each logit costs one expf (16 a clock per SM: 0.069 ms for the
// 256M logits of a pass) and the products' fragments come through ldmatrix
// (128 bytes of shared memory a clock per SM).
//
// ce_fwd_onchip_tc_kernel: ce_fwd_wide_tc_kernel's tile at one hidden step
// a tile. Tiles of 256 batch rows x FT_COLS = 128 catalog columns, 8 warps
// as 4 x 2 warp tiles of 64 x 64 (acc[4][8][4]); per tile four k16 steps of
// ldmatrix and MMAs from the staged states and the tile's bf16 slot, then
// each thread folds its logits into an online (max, sum) for each of its 8
// rows (columns >= n_valid masked); after the split, merge_group. One
// barrier a tile; two bf16 slots, so a tile's rounding never waits for the
// MMAs of the tile before. Warp column 1 folds each tile a step late, so
// that of the two warps an SM sub-partition holds, one runs its MMAs while
// the other folds. Shared memory: states 36,864 B, two bf16 slots 36,864,
// three staging slots 104,448, the warps' exchange 2,048: 180,224 B.
// Deviation from the wide kernels: at one hidden step a tile the fold, not
// the MMAs, bounds the kernel (with fold_tile's expf and its branch a row
// it took 0.30 ms of the main shape's ~0.30, tools/ablate_ce_tc.py
// --onchip), so the epilogue is fold_tile_onchip (ex2.approx, no branch,
// tree sums; its head), which keeps fold_tile's (max, sum) and merge order
// but not its bits.
//
// ce_bwd_onchip_tc_kernel: tiles of VT = 64 catalog columns (64, not 128: ds
// stays in registers for the whole split, 64 floats a thread, and a 128-column
// tile's logits would add 128 more at once). Warp w owns batch rows 32 w ..
// 32 w + 31 for the logits, p and ds; it holds their states' A fragments in
// registers for the whole split (32 registers, 8 ldmatrix a tile fewer).
// Per tile:
//   logits   [32 x 64] = S_w . T^T, four k16 steps (acc[2][8][4]);
//   p        = bf16(exp(logit - logZ) * dloss), 0 past n_valid and B:
//            the logits past n_valid are set to -inf in the rare tile that
//            reaches past it, and a row past B (every row, at n_valid = 0)
//            takes logZ = +inf, so expf gives 0 with no branch or select an
//            element (with a branch around each expf the kernel took 0.98
//            ms, not 0.70: their latencies were serialized); packed in
//            registers straight into the A fragments of the next product
//            (an m16n8 accumulator pair is an m16k16 A fragment) and stored
//            to p [256][72] in shared memory for dT;
//   ds       the tile's p . T (K = the tile's 64 columns, T's fragments by
//            ldmatrix.trans), started from 0 and added to the split's ds,
//            held in registers, in fp32: a tensor core aligns the addends of
//            its sum to the largest and truncates the rest, so a sum carried
//            through every MMA of a split would drift;
//   dT tile  [64 x 64] = p^T . S over the batch rows (K = 16 ceil(B / 16)):
//            warps 0-3 take the first half of the k16 blocks and warps 4-7
//            the second, each as 2 x 2 warp tiles of 32 x 32 (p and S by
//            ldmatrix.trans), into two fp32 staging tiles [64][72] (8 rows of
//            a quarter warp's 8-byte stores on distinct banks), summed in
//            that order as the tile is written (half the chain a warp, and 8
//            ldmatrix for 16 MMAs where 16 x 32 warp tiles over all of K
//            take 12);
//   one-hot  dT[a_i] -= dloss_i * s_i for the answers in the tile, in
//            ascending i (duplicate answers accumulate in a fixed order),
//            from the unrounded fp32 states in device memory;
//            the tile's dT rows written once, coalesced.
// Two barriers a tile: p complete (which also votes whether an answer
// falls in the tile), then the dT halves complete; two more where an
// answer does. Between them, while the dT product runs, each thread
// rounds its copies of the next tile into the other of two bf16 slots (the
// copies three tiles ahead), so the second barrier also publishes the next
// tile. (Taking warps 4-7's ds product a step late, as the forward folds
// warp column 1's tiles, gained nothing here: 0.60 ms either way.)
// The split's ds is written to ds_part [n_splits, B, H] once, at the end.
// Shared memory: states 36,864 B, two bf16 slots 18,432, three staging
// slots 52,224, p 36,864, the dT halves 36,864, logZ, dloss and the answers
// 3,072: 184,320 B.
//
// Sums run in a fixed order and pass 2 merges the splits in split order:
// two calls give the same bits. The tensor cores sum a logit's 64 products
// in their own order, not in ascending h as the FMA kernels did; each
// product of two bf16 values is exact.

constexpr int FO_SLOT_B = FT_COLS * tc::ONCHIP_LDB;  // a bf16 table slot [FT_COLS][LDB]
constexpr int FO_SLOT_F = FT_COLS * tc::ONCHIP_LDF;  // an fp32 staging slot [FT_COLS][LDF]
constexpr long long FO_SMEM = 2LL * (tc::ONCHIP_ROWS * tc::ONCHIP_LDB + 2 * FO_SLOT_B) +
                              4LL * (tc::ONCHIP_STAGES * FO_SLOT_F + 2 * tc::ONCHIP_ROWS);  // 180,224 B
constexpr int BO_SLOT_B = VT * tc::ONCHIP_LDB;       // the backward's: [VT][LDB]
constexpr int BO_SLOT_F = VT * tc::ONCHIP_LDF;       // ... and [VT][LDF]
constexpr int BO_GLD = tc::ONCHIP_K + 8;             // the dT tile's row stride (floats)
constexpr long long BO_SMEM =
    2LL * (2 * tc::ONCHIP_ROWS * tc::ONCHIP_LDB + 2 * BO_SLOT_B) +
    4LL * (tc::ONCHIP_STAGES * BO_SLOT_F + 2 * VT * BO_GLD + 3 * tc::ONCHIP_ROWS);  // 184,320 B
static_assert(tc::ONCHIP_ROWS == OC_B && tc::ONCHIP_K == OC_H && THREADS == 256 &&
                  FO_SMEM <= MAX_SMEM && BO_SMEM <= MAX_SMEM && FT_COLS == 2 * VT,
              "the on-chip tensor-core kernels: 8 warps over the 256 x 64 batch");

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ce_fwd_onchip_tc_kernel's epilogue: fold_tile's online (max, sum) over
// the same tile layout, written for the on-chip route, where a tile is
// one hidden step and the fold, not the MMAs, bounds the kernel:
//   - each exponential one ex2.approx.ftz of x log2(e) - m log2(e), taken
//     by one fused multiply-add (2 instructions where expf takes 9; a
//     relative error of ~1e-6 a term, ~1e-7 on logZ);
//   - no branch: the 8 rows' maxima, rescales and sums are independent
//     chains the compiler interleaves (a branch a row serialized them); a
//     row with no valid column yet keeps m = -inf and sum 0;
//   - a row's 16 terms summed as a balanced tree, then added to its sum
//     once (fold_tile adds them one by one), and its maximum likewise.
// So its bits differ from fold_tile's, in a fixed order all the same.
__device__ __forceinline__ void fold_tile_onchip(float (&acc)[4][8][4], float (&m)[8],
                                                 float (&sum)[8], int j0, int n_valid) {
  constexpr float L2E = 1.4426950408889634f;  // log2(e)
  if (j0 + FT_COLS > n_valid) {  // the tile reaches past the valid columns
    const int c0 = j0 + 64 * (threadIdx.x >> 7) + 2 * (threadIdx.x & 3);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (c0 + 8 * j + (e & 1) >= n_valid) acc[i][j][e] = -INFINITY;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int q = 2 * i + half;
      float t[16];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        t[2 * j] = acc[i][j][2 * half];
        t[2 * j + 1] = acc[i][j][2 * half + 1];
      }
      float mx[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) mx[k] = fmaxf(t[k], t[k + 8]);
#pragma unroll
      for (int k = 0; k < 4; ++k) mx[k] = fmaxf(mx[k], mx[k + 4]);
#pragma unroll
      for (int k = 0; k < 2; ++k) mx[k] = fmaxf(mx[k], mx[k + 2]);
      const float mnew = fmaxf(m[q], fmaxf(mx[0], mx[1]));
      const bool any = mnew > -INFINITY;
      // exp(-inf) = 0 on the row's first valid column; nothing to rescale
      // while no column is valid
      const float scale = any ? ex2_approx((m[q] - mnew) * L2E) : 1.f;
      const float ml = any ? mnew * L2E : 0.f;
#pragma unroll
      for (int k = 0; k < 16; ++k) t[k] = ex2_approx(fmaf(t[k], L2E, -ml));
#pragma unroll
      for (int k = 0; k < 8; ++k) t[k] += t[k + 8];
#pragma unroll
      for (int k = 0; k < 4; ++k) t[k] += t[k + 4];
#pragma unroll
      for (int k = 0; k < 2; ++k) t[k] += t[k + 2];
      sum[q] = sum[q] * scale + (t[0] + t[1]);
      m[q] = mnew;
    }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
}

// acc[i][j] += S[64 wm + 16 i, :] . T[64 wn + 8 j, :]^T over the 64 hidden
// columns, for the warp's m16 fragments with a row < B: all four when FULL
// (B = 256: no MMA is predicated, so the compiler adds no warp
// synchronisation around each), else the first n_i. S's rows lie lds
// elements apart, T's ldt (the middle route's states are Hp + 8 wide)
template <bool FULL>
__device__ __forceinline__ void onchip_logits_64x64(float (&acc)[4][8][4], const __nv_bfloat16* sS,
                                                   const __nv_bfloat16* T, int wm, int wn, int lane,
                                                   int n_i, int lds = tc::ONCHIP_LDB,
                                                   int ldt = tc::ONCHIP_LDB) {
#pragma unroll
  for (int k16 = 0; k16 < tc::ONCHIP_K; k16 += 16) {
    uint32_t a[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (FULL || i < n_i)
        tc::ldmatrix_x4(a[i], sS + (64 * wm + 16 * i + tc::a_row(lane)) * lds + k16 + tc::a_col(lane));
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
      uint32_t r[4];
      tc::ldmatrix_x4(r, T + (64 * wn + 16 * jp + tc::b_row(lane)) * ldt + k16 + tc::b_col(lane));
      const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (FULL || i < n_i) {
          tc::mma_bf16(acc[i][2 * jp], a[i], b0);
          tc::mma_bf16(acc[i][2 * jp + 1], a[i], b1);
        }
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1)
ce_fwd_onchip_tc_kernel(const float* __restrict__ states, const float* __restrict__ table, int B,
                        int V, int H, int n_valid, int tiles_per_split,
                        float* __restrict__ part_m, float* __restrict__ part_s) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  __nv_bfloat16* sS = reinterpret_cast<__nv_bfloat16*>(tc_smem);  // [256][LDB] the states
  __nv_bfloat16* sT = sS + tc::ONCHIP_ROWS * tc::ONCHIP_LDB;        // [2][FO_SLOT_B] bf16 tiles
  float* sF = reinterpret_cast<float*>(sT + 2 * FO_SLOT_B);         // [STAGES][FO_SLOT_F] fp32 staging
  float* xm = sF + tc::ONCHIP_STAGES * FO_SLOT_F;                   // [256] warp column 1's m
  float* xs = xm + tc::ONCHIP_ROWS;                                 // [256] ... and its sum
  constexpr int STAGES = tc::ONCHIP_STAGES;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp & 3, wn = warp >> 2;  // the warp tile: rows 64 wm, columns 64 wn of a tile
  // the warp's m16 fragments with a row < B: i < i_end
  const int i_end = min(max((B - 64 * wm + 15) / 16, 0), 4);
  const int per = tiles_per_split / (FT_COLS / VT);
  const int n_tiles = (V + FT_COLS - 1) / FT_COLS;
  const int t_begin = blockIdx.x * per, n = max(min(t_begin + per, n_tiles) - t_begin, 0);

  tc::stage_states_bf16(sS, states, B, H);
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n) tc::copy_table_tile<FT_COLS>(sF + s * FO_SLOT_F, table, (t_begin + s) * FT_COLS, V, H);
    onchip::cp_async_commit();
  }
  // row q = 2 i + half of this thread is 64 wm + 16 i + g + 8 half
  float m[8], sum[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    m[q] = -INFINITY;
    sum[q] = 0.f;
  }
  float acc[4][8][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // Warp column 1 folds each tile one step late: the two warps of an SM
  // sub-partition (w and w + 4, one of each column) then run one's MMAs
  // while the other folds, the tensor cores beside the FMA and MUFU pipes
  // (with both folding or both in MMAs between barriers the kernel took
  // 0.22 ms, not 0.18). Step n only folds the late warps' last tile.
  const bool late = wn == 1;
  auto logits = [&](const __nv_bfloat16* T) {
    if (i_end == 4)  // (warp-uniform) 4 but where B < 256
      onchip_logits_64x64<true>(acc, sS, T, wm, wn, lane, 4);
    else if (i_end > 0)
      onchip_logits_64x64<false>(acc, sS, T, wm, wn, lane, i_end);
  };
  for (int s = 0; s <= n; ++s) {
    const __nv_bfloat16* T = sT + (s & 1) * FO_SLOT_B;
    if (s < n) {  // (block-uniform)
      tc::cp_async_wait_group<STAGES - 2>();  // this thread's copies of tile s have landed
      // its slot was last read by tile s - 2's MMAs, before tile s - 1's barrier
      tc::round_table_tile<FT_COLS>(sT + (s & 1) * FO_SLOT_B, sF + (s % STAGES) * FO_SLOT_F);
      __syncthreads();  // every thread's pieces of tile s (at s = 0 the states too)
      // the staging slot of tile s - 1, whose pieces this thread rounded there
      if (s + STAGES - 1 < n)
        tc::copy_table_tile<FT_COLS>(sF + ((s + STAGES - 1) % STAGES) * FO_SLOT_F, table,
                                     (t_begin + s + STAGES - 1) * FT_COLS, V, H);
      onchip::cp_async_commit();  // (empty past the last tile: one group a tile)
      if (!late) logits(T);
    }
    const int f = late ? s - 1 : s;  // the tile this warp folds at step s
    if (f >= 0 && f < n) fold_tile_onchip(acc, m, sum, (t_begin + f) * FT_COLS, n_valid);
    if (late && s < n) logits(T);
  }
  merge_group(m, sum, xm, xs, 0, B, part_m, part_s);
}

// The backward's two products over a warp's batch rows, for its first NI
// m16 fragments (those with a row < B; a count known when compiled, so no
// MMA is predicated): acc[i][j] = S[16 i, :] . T[8 j, :]^T from the
// states' A fragments sa and the tile T; and part[i][j] = p[16 i, :] .
// T[:, 8 j] over the tile's 64 columns from p's A fragments pa.
template <int NI>
__device__ __forceinline__ void onchip_bwd_logits(float (&acc)[2][8][4], const uint32_t (&sa)[2][4][4],
                                                  const __nv_bfloat16* T, int lane) {
#pragma unroll
  for (int kk = 0; kk < tc::ONCHIP_K / 16; ++kk)
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
      uint32_t r[4];
      tc::ldmatrix_x4(r, T + (16 * jp + tc::b_row(lane)) * tc::ONCHIP_LDB + 16 * kk + tc::b_col(lane));
      const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        tc::mma_bf16(acc[i][2 * jp], sa[i][kk], b0);
        tc::mma_bf16(acc[i][2 * jp + 1], sa[i][kk], b1);
      }
    }
}

template <int NI>
__device__ __forceinline__ void onchip_bwd_ds(float (&part)[2][8][4], const uint32_t (&pa)[2][4][4],
                                              const __nv_bfloat16* T, int lane) {
#pragma unroll
  for (int kk = 0; kk < VT / 16; ++kk)
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
      uint32_t r[4];
      tc::ldmatrix_x4_trans(r, T + (16 * kk + tc::bt_row(lane)) * tc::ONCHIP_LDB + 16 * jp + tc::bt_col(lane));
      const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        tc::mma_bf16(part[i][2 * jp], pa[i][kk], b0);
        tc::mma_bf16(part[i][2 * jp + 1], pa[i][kk], b1);
      }
    }
}

__global__ void __launch_bounds__(THREADS, 1)
ce_bwd_onchip_tc_kernel(const float* __restrict__ states, const float* __restrict__ table,
                        const long long* __restrict__ answers, const float* __restrict__ logz,
                        const float* __restrict__ dloss, int B, int V, int H, int n_valid,
                        int tiles_per_split, float* __restrict__ ds_part,
                        float* __restrict__ dtable) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  constexpr int LDB = tc::ONCHIP_LDB, STAGES = tc::ONCHIP_STAGES;
  __nv_bfloat16* sS = reinterpret_cast<__nv_bfloat16*>(tc_smem);  // [256][LDB] the states
  __nv_bfloat16* sPb = sS + tc::ONCHIP_ROWS * LDB;                  // [256][LDB] p
  __nv_bfloat16* sT = sPb + tc::ONCHIP_ROWS * LDB;                  // [2][BO_SLOT_B] the tiles, bf16
  float* sF = reinterpret_cast<float*>(sT + 2 * BO_SLOT_B);         // [STAGES][BO_SLOT_F] fp32 staging
  float* sG = sF + STAGES * BO_SLOT_F;                              // [VT][BO_GLD] the tile's dT,
  float* sG1 = sG + VT * BO_GLD;                                    // [VT][BO_GLD] in two halves
  float* sZ = sG1 + VT * BO_GLD;                                    // [256] logZ
  float* sD = sZ + tc::ONCHIP_ROWS;                                 // [256] dloss
  int* sA = reinterpret_cast<int*>(sD + tc::ONCHIP_ROWS);           // [256] the answer, -1 outside [0, n_valid)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = 32 * warp;                     // the warp's batch rows (logits, p, ds)
  const int i_end = min(max((B - r0 + 15) / 16, 0), 2);  // its m16 fragments with a row < B
  // the dT product: warps 0-3 sum the first half of the batch rows' k16
  // blocks, warps 4-7 the second; a warp tile of 32 x 32 (rows cm, columns hn)
  const int kb = (B + 15) / 16, kb0 = (kb + 1) / 2;  // k16 blocks with a row < B; the first half's
  const int k_begin = warp < 4 ? 0 : kb0, k_end = warp < 4 ? kb0 : kb;
  const int cm = 32 * ((warp >> 1) & 1), hn = 32 * (warp & 1);
  const int n_tiles = (V + VT - 1) / VT;
  const int t_begin = blockIdx.x * tiles_per_split;
  const int n = max(min(t_begin + tiles_per_split, n_tiles) - t_begin, 0);

  tc::stage_states_bf16(sS, states, B, H);
  {
    // logZ +inf for a row past B, or for every row when no column is
    // valid, so that its p is exp(-inf) = 0 with no mask
    const bool ok = tid < B;
    sZ[tid] = ok && n_valid > 0 ? logz[tid] : INFINITY;
    sD[tid] = ok ? dloss[tid] : 0.f;
    const long long a = ok ? answers[tid] : -1;
    sA[tid] = in_catalog(a, n_valid) ? (int)a : -1;
  }
#pragma unroll
  for (int s = 0; s < STAGES; ++s) {
    if (s < n) tc::copy_table_tile<VT>(sF + s * BO_SLOT_F, table, (t_begin + s) * VT, V, H);
    onchip::cp_async_commit();
  }
  // tile t comes in staging slot t % STAGES, commit group t, and is rounded
  // into bf16 slot t & 1 by the tile before (by the prologue: tile 0), after
  // that tile's first barrier, so its second publishes it; tile t + STAGES
  // is issued into the staging slot then free
  tc::cp_async_wait_group<STAGES - 1>();  // this thread's copies of tile 0 have landed
  tc::round_table_tile<VT>(sT, sF);
  if (STAGES < n) tc::copy_table_tile<VT>(sF, table, (t_begin + STAGES) * VT, V, H);
  onchip::cp_async_commit();
  // the warp's states as the logits' A fragments, for the whole split:
  // rows r0 + 16 i, hidden columns 16 kk .. + 15
  uint32_t sa[2][4][4];
  __syncthreads();  // the states, the row scalars and tile 0's bf16 slot
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      if (i < i_end)
        tc::ldmatrix_x4(sa[i][kk], sS + (r0 + 16 * i + tc::a_row(lane)) * LDB + 16 * kk + tc::a_col(lane));
  // the split's ds: row r0 + 16 i + g + 8 half, column 8 j + 2 t4 + e at ds[i][j][2 half + e]
  float ds[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) ds[i][j][e] = 0.f;

  for (int s = 0; s < n; ++s) {
    const int j0 = (t_begin + s) * VT;
    const __nv_bfloat16* T = sT + (s & 1) * BO_SLOT_B;  // the tile, bf16
    if (i_end > 0) {
      // the logits: acc[i][j] = S[r0 + 16 i, :] . T[8 j, :]^T
      float acc[2][8][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
      if (i_end == 2)  // (warp-uniform) 2 but where B < 256
        onchip_bwd_logits<2>(acc, sa, T, lane);
      else
        onchip_bwd_logits<1>(acc, sa, T, lane);
      if (j0 + VT > n_valid) {  // the tile reaches past the valid columns: exp(-inf) = 0 there
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (j0 + 8 * j + 2 * t4 + (e & 1) >= n_valid) acc[0][j][e] = acc[1][j][e] = -INFINITY;
      }
      // p, rounded to bf16: into sPb, and as the A fragments of p . T:
      // pa[i][kk] for columns 16 kk .. + 15 takes (row g, columns 2 t4 + {0, 1})
      // of n8 block 2 kk, then row g + 8, then n8 block 2 kk + 1 likewise.
      // No branch or select an element: masked logits are -inf and a row past
      // B (or any row when n_valid is 0) has logZ +inf, so exp() gives 0
      // (a branch around each expf serialized their latencies)
      uint32_t pa[2][4][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = r0 + 16 * i + g + 8 * half;
          const float z = sZ[r], d = sD[r];
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const uint32_t u = tc::pack_bf16(expf(acc[i][j][2 * half] - z) * d,
                                             expf(acc[i][j][2 * half + 1] - z) * d);
            pa[i][j >> 1][2 * (j & 1) + half] = u;
            if (i < i_end) *reinterpret_cast<uint32_t*>(sPb + r * LDB + 8 * j + 2 * t4) = u;
          }
        }
      // the tile's ds: part[i][j] = p[r0 + 16 i, :] . T[:, 8 j] over its 64 columns
      float part[2][8][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[i][j][e] = 0.f;
      if (i_end == 2)
        onchip_bwd_ds<2>(part, pa, T, lane);
      else
        onchip_bwd_ds<1>(part, pa, T, lane);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) ds[i][j][e] += part[i][j][e];
    }
    // does an answer fall in this tile? (the vote is also the barrier after p)
    const int a_mine = sA[tid];
    const bool hit = __syncthreads_or(a_mine >= j0 && a_mine < j0 + VT);
    // the next tile into the other bf16 slot, last read by tile s - 1's
    // products, before its first barrier (its copies were issued three
    // tiles ago), while the dT product runs
    if (s + 1 < n) {
      tc::cp_async_wait_group<STAGES - 1>();  // this thread's copies of tile s + 1 have landed
      tc::round_table_tile<VT>(sT + ((s + 1) & 1) * BO_SLOT_B, sF + ((s + 1) % STAGES) * BO_SLOT_F);
      if (s + 1 + STAGES < n)
        tc::copy_table_tile<VT>(sF + ((s + 1) % STAGES) * BO_SLOT_F, table,
                                (t_begin + s + 1 + STAGES) * VT, V, H);
    }
    onchip::cp_async_commit();  // (empty past the last tiles: one group a tile)

    // the dT tile, this warp's half of it: dt[i][j] = p[:, cm + 16 i .. + 15]^T .
    // S[:, hn + 8 j .. + 7] over the k16 blocks [k_begin, k_end) of batch rows
    {
      float dt[2][4][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) dt[i][j][e] = 0.f;
      for (int k = 16 * k_begin; k < 16 * k_end; k += 16) {
        uint32_t a[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          tc::ldmatrix_x4_trans(a[i], sPb + (k + tc::b_row(lane)) * LDB + cm + 16 * i + tc::b_col(lane));
#pragma unroll
        for (int jp = 0; jp < 2; ++jp) {
          uint32_t r[4];
          tc::ldmatrix_x4_trans(r, sS + (k + tc::bt_row(lane)) * LDB + hn + 16 * jp + tc::bt_col(lane));
          const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            tc::mma_bf16(dt[i][2 * jp], a[i], b0);
            tc::mma_bf16(dt[i][2 * jp + 1], a[i], b1);
          }
        }
      }
      // sG and sG1 were last read by tile s - 1's write-out, before this
      // tile's first barrier
      float* half_tile = warp < 4 ? sG : sG1;
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int half = 0; half < 2; ++half)
            *reinterpret_cast<float2*>(half_tile + (cm + 16 * i + g + 8 * half) * BO_GLD + hn + 8 * j + 2 * t4) =
                make_float2(dt[i][j][2 * half], dt[i][j][2 * half + 1]);
    }
    __syncthreads();  // both halves of the dT tile and the next tile's bf16 slot are complete;
                      // every reader of p is done
    constexpr int Q4 = tc::ONCHIP_K / 4;  // float4s a dT row
    if (hit) {  // rare: at most B of the catalog's tiles
      // the halves summed in order into sG, then the one-hot term in
      // ascending i, from the unrounded states (sS holds rounded ones)
#pragma unroll
      for (int q = 0; q < VT * Q4 / THREADS; ++q) {
        const int f = tid + THREADS * q, c = f / Q4, h = (f % Q4) * 4;
        float4* x = reinterpret_cast<float4*>(sG + c * BO_GLD + h);
        const float4 y = *reinterpret_cast<const float4*>(sG1 + c * BO_GLD + h);
        *x = make_float4(x->x + y.x, x->y + y.y, x->z + y.z, x->w + y.w);
      }
      __syncthreads();
      for (int h = tid; h < H; h += THREADS)
        for (int i = 0; i < B; ++i) {
          const int a = sA[i];
          if (a >= j0 && a < j0 + VT) sG[(a - j0) * BO_GLD + h] -= sD[i] * __ldg(states + (size_t)i * H + h);
        }
      __syncthreads();
    }
#pragma unroll
    for (int q = 0; q < VT * Q4 / THREADS; ++q) {
      const int f = tid + THREADS * q, c = f / Q4, h = (f % Q4) * 4;
      float4 v = *reinterpret_cast<const float4*>(sG + c * BO_GLD + h);
      if (!hit) {
        const float4 y = *reinterpret_cast<const float4*>(sG1 + c * BO_GLD + h);
        v = make_float4(v.x + y.x, v.y + y.y, v.z + y.z, v.w + y.w);
      }
      if (j0 + c < V && h < H) *reinterpret_cast<float4*>(dtable + (size_t)(j0 + c) * H + h) = v;
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r0 + 16 * i + g + 8 * half;
      if (r >= B) continue;
      float* dst = ds_part + ((size_t)blockIdx.x * B + r) * H;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int h = 8 * j + 2 * t4;  // H % 4 == 0 and h is even: h < H means h + 1 < H
        if (h < H) *reinterpret_cast<float2*>(dst + h) = make_float2(ds[i][j][2 * half], ds[i][j][2 * half + 1]);
      }
    }
}

// ---- the bf16-operand form at the middle widths, on the tensor cores ----------
//
// ce_fwd_mid_tc_kernel and ce_bwd_mid_tc_kernel: the forward's and the
// backward's pass 1 in the bf16-operand form at B <= OC_B and OC_H < H <=
// MAX_H (the middle route; the counterparts of pallas_ce.py:222 _fwd_kernel
// and :340 _grads_kernel with dtype="bfloat16"). Before them these shapes
// ran the older sweeps (ce_fwd_partial_kernel<true>, ce_bwd_sweep_kernel<true>:
// two blocks per SM, 64-row batch tiles staged again for every table tile,
// 4 x 4 register tiles of fp32 FMAs on rounded operands), so the tensor
// cores sat idle. Both kernels take the wide kernels' grids and products
// (mma.sync m16n8k16, bf16 operands, fp32 accumulators, one block of 256
// threads per SM over a split of whole tiles) with what these widths allow
// and H > MAX_H did not: every state row fits in shared memory, so each
// block stages the states once, straight from the fp32 states, rounded as
// they are stored (nearest, ties to even) into sS [256][Hp + 8] bf16 (Hp =
// H up to a multiple of 64, rows >= B and columns >= H zero; 135,168 B at H
// = 256). No states_bf16_kernel launch and no states scratch are left:
// each C entry is the sweep and its pass 2 (ce_fwd_merge_kernel<true>;
// ce_ds_reduce_tc_kernel<false>, the wide backward's fragment order).
//
// Bound at B=256, V=1M, H=256: the fp32 table read once, 1.02 GB (0.306 ms
// at 3.35 TB/s), and for the backward the dT write, 2.05 GB (0.611 ms);
// the products' 131 and 393 GFLOP take 0.133 and 0.397 ms at the bf16
// tensor rate (989 TFLOP/s).
//
// ce_fwd_mid_tc_kernel: ce_fwd_wide_tc_kernel's tile (256 batch rows x
// FT_COLS = 128 catalog columns, 8 warps as 4 x 2 warp tiles of 64 x 64,
// acc[4][8][4]) and epilogue (fold_tile after a tile's last hidden step,
// merge_group after the split: the wide forward's online (max, sum) and
// merge order), in Hp / 64 steps a tile, the A fragments from the
// resident states at the step's 64 hidden columns. The ring carries only table chunks
// [128][72] bf16: each thread loads its 8 float4s of step s + 1 at the top
// of step s and rounds and stores them after step s's MMAs (the wide
// kernel's register prefetch), so two slots and one barrier a step do.
// The MMAs of m16 fragments with no row < B are skipped (a warp-uniform
// count, no MMA predicated at B = 256: onchip_logits_64x64). Shared memory
// at H = 256: states 135,168 B, two slots 36,864, the warps' exchange 2,048:
// 174,080 B. (The wide forward's four slots would sit idle here: the
// states no longer come by cp.async a few steps ahead, and the table's
// prefetch is one step deep in registers either way.)
//
// ce_bwd_mid_tc_kernel: ce_bwd_wide_tc_kernel's steps with the states
// resident, so the logits steps read only table rows. Tiles of MID_COLS =
// 128 catalog columns: p [256][136] bf16 (69,632 B) beside the states. (A
// 256-column p, as the wide kernel holds, does not fit beside [256][264]
// states; at H <= 128 it would, but only with 16-column products steps.
// The other choice is the wide kernel's 256-column p with the states
// streamed every step, from the fp32 states and rounded on chip, so with
// no scratch either: tools/ablate_ce_tc.py --mid builds it two ways, the
// chunk held in registers a step ahead or stored as soon as it is loaded,
// and both are slower than this kernel, ~3.55 and ~3.31 ms against ~3.14
// at H = 256, ~1.98 and ~1.84 against ~1.30 at H = 128 (255 registers
// with 8 bytes of spills, and 254): the states then cross L2 in fp32,
// twice the bytes, on every logits step. Only
// ce_bwd_wide_tc_kernel itself, which streams them from the bf16 scratch
// that states_bf16_kernel writes, is faster at H = 256, ~2.83 ms, and
// that extra launch and scratch are what this route leaves out.) Per
// tile, 4 Hp / 64 steps, one barrier each:
//   logits   for each 64-column sub-tile, Hp / 64 steps of 64 hidden
//            columns: S . T_sub^T (8 warps as 4 x 2, 64 x 32 each,
//            acc[4][4][4]), the table rows [64][72] from the ring; after
//            the sub-tile's last step p = bf16(exp(logit - logZ) * dloss)
//            into sP: the logits past n_valid set to -inf in the tile that
//            reaches past it, and a row past B (every row, at n_valid = 0)
//            given logZ = +inf, so expf gives 0 with no branch an element
//            (ce_bwd_onchip_tc_kernel's epilogue);
//   products Hp / 32 steps of 32 hidden columns, the tile's table rows
//            [128][40] from the ring: warps 0-3 dT[tile, chunk] = p^T .
//            S[:, chunk] (32 catalog columns each, K = the batch rows up
//            to 16 ceil(B / 16), S from the resident states by
//            ldmatrix.trans), written once to device memory; warps 4-7
//            ds[:, chunk] += p . T[tile, chunk] (64 batch rows each, K =
//            128), the split's ds_part read and written once a tile in
//            their fragment order (the split's first tile only writes),
//            each warp-wide access 512 contiguous bytes. 128 MMAs a warp a
//            step either way.
// Every step's table rows come from device memory (the products steps
// read the tile's rows a second time, which L2 holds: 17 MB a pass of the
// 132 SMs at H = 256) into registers two steps ahead, and are rounded and
// stored into the slot one step ahead (the wide kernel's pre_a / pre_b),
// across tile boundaries too; so no bf16 table scratch either. The
// one-hot term dT[a_i] -= dloss_i * s_i goes on the tile's finished dT
// rows in device memory, from the unrounded fp32 states, in ascending i,
// as every route takes it (the vote on the answers in the tile is the
// barrier after the tile's dT writes). A ds warp's products step sums from
// 0 on the tensor cores and adds the split's ds_part from the tile before
// with one fp32 rounding after its MMAs, loaded at the end of the step
// before (prev, 16 float4s a thread): a tensor core truncates the addends
// of its sum to the largest, and the loads are in flight across the
// barrier and the MMAs. (Carried through the MMAs, as the wide kernel
// carries it, ds read further from the in-order plain version and the
// backward took 1-2% longer; with L2 eviction hints, ds_part evict-last and
// dT evict-first, 5-7% longer: tools/ablate_ce_tc.py --mid.)
// Bytes a 128-column tile at H = 256, B = 256: the table rows 128 KB (and
// 128 KB more from L2), dT 128 KB, ds_part read and written once, 512 KB:
// ds_part moves twice the table's and dT's bytes (the wide kernel's
// 256-column tiles move as many), 6.0 GB over 7,813 tiles at V = 1M; a
// split's ds_part is 256 KB (33 MB over 132 splits), within L2's 50 MB.
// Shared memory at H = 256: states 135,168 B, p 69,632, two slots 20,480
// (a logits slot [64][72] and a products slot [128][40] share one),
// logZ, dloss and the answers 3,072: 228,352 B.
//
// Sums run in a fixed order and pass 2 merges the splits in split order:
// two calls give the same bits. The tensor cores sum a logit's products in
// their own order; each product of two bf16 values is exact.
//
// On one "NVIDIA H100 80GB HBM3, 700.00 W" at B=256, V=1M (PERF.md rows 2bm
// and 4bm; tools/time_kernels.py, in turns with the older sweeps they
// replaced): the forward ~0.59 ms at H = 256 (52% of its bound; the sweep
// ~5.77) and ~0.40 at H = 128 (~2.46); the backward ~3.13 ms at H = 256
// (20% of its bound; the sweep ~18.6) and ~1.30 at H = 128 (~8.64).
// tools/ablate_ce_tc.py --mid at H = 256: the forward with its MMAs and
// fold alone ~0.55 ms, without its fold ~0.41: the fold and the mma.sync
// loop share its time. The backward's products steps alone ~2.66 ms, its
// logits steps alone ~0.87; with everything but its MMAs ~2.98, with its
// MMAs and epilogue alone ~1.75: its memory path bounds it, ds_part's
// traffic first (without the carry loads ~2.42 ms, without the ds_part
// stores ~2.45, without the dT stores ~2.61). The wide kernels on these
// shapes (256-column tiles, so half the ds_part bytes; the states streamed
// from a scratch that an extra launch fills) take ~2.83 ms at H = 256 and
// ~1.60 at H = 128.

constexpr int MID_COLS = 128;                 // the backward's catalog columns per tile
constexpr int MID_SUB = 64;                   // ... per logits sub-tile
constexpr int MID_LDP = MID_COLS + 8;         // its p's row stride (bf16)
constexpr int MID_LLD = TC_HL + 8;            // a logits slot's row stride: [MID_SUB][MID_LLD]
constexpr int MID_PLD = TC_HP + 8;            // a products slot's row stride: [MID_COLS][MID_PLD]
constexpr int MID_SLOT = MID_COLS * MID_PLD;  // a backward slot (either kind), bf16 elements
constexpr int MID_FSLOT = FT_COLS * FT_LD;    // a forward slot [FT_COLS][FT_LD]
constexpr long long mid_fwd_smem(int Hp) {
  return 2LL * (TC_ROWS * (Hp + 8) + 2 * MID_FSLOT) + 4LL * 2 * TC_ROWS;
}
constexpr long long mid_bwd_smem(int Hp) {
  return 2LL * (TC_ROWS * (Hp + 8) + TC_ROWS * MID_LDP + 2 * MID_SLOT) + 4LL * 3 * TC_ROWS;
}
static_assert(MID_SUB * MID_LLD <= MID_SLOT && mid_bwd_smem(MAX_H) <= MAX_SMEM &&
                  mid_fwd_smem(MAX_H) <= MAX_SMEM && MID_COLS == 2 * MID_SUB &&
                  MID_COLS % VT == 0 && FT_COLS % VT == 0 && TC_ROWS == THREADS && MAX_H % TC_HL == 0 &&
                  tc::ONCHIP_ROWS == TC_ROWS && tc::ONCHIP_LDB == tc::ONCHIP_K + 8,
              "the middle route: 8 warps over every state row, whole tiles of the C entries' units");
// ldmatrix rows 16 bytes apart mod 128 (the eight rows of a matrix on
// distinct banks): Hp + 8, MID_LDP, MID_LLD and MID_PLD bf16 elements
static_assert((2 * MID_LDP) % 128 == 16 && (2 * MID_LLD) % 128 == 16 && (2 * MID_PLD) % 128 == 80 &&
                  (2 * (TC_HL + 8)) % 128 == 16,
              "every fragment load of a warp on distinct banks");

__global__ void __launch_bounds__(THREADS, 1)
ce_fwd_mid_tc_kernel(const float* __restrict__ states, const float* __restrict__ table, int B,
                     int V, int H, int n_valid, int tiles_per_split,
                     float* __restrict__ part_m, float* __restrict__ part_s) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const int Hp = round_up(H, TC_HL), lds = Hp + 8, nk = Hp / TC_HL;
  __nv_bfloat16* sS = reinterpret_cast<__nv_bfloat16*>(tc_smem);  // [TC_ROWS][lds] the states
  __nv_bfloat16* ring = sS + TC_ROWS * lds;                          // [2][MID_FSLOT] table chunks
  float* xm = reinterpret_cast<float*>(ring + 2 * MID_FSLOT);        // [TC_ROWS] warp column 1's m
  float* xs = xm + TC_ROWS;                                          // [TC_ROWS] ... and its sum
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2;  // the warp tile: rows 64 wm, columns 64 wn of a tile
  const int i_end = min(max((B - 64 * wm + 15) / 16, 0), 4);  // its m16 fragments with a row < B
  const int per = tiles_per_split / (FT_COLS / VT);
  const int n_tiles = (V + FT_COLS - 1) / FT_COLS;
  const int t_begin = blockIdx.x * per, t_end = min(t_begin + per, n_tiles);
  const int n_steps = max(t_end - t_begin, 0) * nk;

  // step s: hidden chunk s % nk of tile t_begin + s / nk, in slot s & 1
  auto slot = [&](int s) { return ring + (s & 1) * MID_FSLOT; };
  float4 chunk[8];  // a step's table rows in fp32, loaded a step ahead
  auto load_chunk = [&](int s) {
    const int h0 = (s % nk) * TC_HL, c0 = (t_begin + s / nk) * FT_COLS;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int i = tid + THREADS * q, r = i >> 4, h = h0 + (i & 15) * 4;
      chunk[q] = (c0 + r < V && h < H)
                    ? __ldg(reinterpret_cast<const float4*>(table + (size_t)(c0 + r) * H + h))
                    : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  auto store_chunk = [&](int s) {  // chunk, rounded to bf16, into step s's slot
    __nv_bfloat16* dst = slot(s);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int i = tid + THREADS * q, r = i >> 4, c4 = (i & 15) * 4;
      const uint2 v =
          make_uint2(tc::pack_bf16(chunk[q].x, chunk[q].y), tc::pack_bf16(chunk[q].z, chunk[q].w));
      *reinterpret_cast<uint2*>(dst + r * FT_LD + c4) = v;
    }
  };

  tc::stage_states_bf16(sS, states, B, H, Hp);
  // row q = 2 i + half of this thread is 64 wm + 16 i + g + 8 half
  float m[8], sum[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    m[q] = -INFINITY;
    sum[q] = 0.f;
  }
  float acc[4][8][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  if (n_steps > 0) {
    load_chunk(0);
    store_chunk(0);
  }
  for (int s = 0; s < n_steps; ++s) {
    __syncthreads();  // step s's table chunk (at s = 0 the states too); step s - 1's MMAs are done
    if (s + 1 < n_steps) load_chunk(s + 1);
    const __nv_bfloat16* S = sS + (s % nk) * TC_HL;
    if (i_end == 4)  // (warp-uniform) 4 but where B < 256
      onchip_logits_64x64<true>(acc, S, slot(s), wm, wn, lane, 4, lds, FT_LD);
    else if (i_end > 0)
      onchip_logits_64x64<false>(acc, S, slot(s), wm, wn, lane, i_end, lds, FT_LD);
    if (s % nk == nk - 1)  // the tile's logits are complete: fold them into (m, sum)
      fold_tile(acc, m, sum, (t_begin + s / nk) * FT_COLS, n_valid);
    if (s + 1 < n_steps) store_chunk(s + 1);  // its slot was last read by step s - 1
  }
  merge_group(m, sum, xm, xs, 0, B, part_m, part_s);
}

__global__ void __launch_bounds__(THREADS, 1)
ce_bwd_mid_tc_kernel(const float* __restrict__ states, const float* __restrict__ table,
                     const long long* __restrict__ answers, const float* __restrict__ logz,
                     const float* __restrict__ dloss, int B, int V, int H, int n_valid,
                     int tiles_per_split, float* __restrict__ ds_part,
                     float* __restrict__ dtable) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const int Hp = round_up(H, TC_HL), lds = Hp + 8, nl = Hp / TC_HL, np = Hp / TC_HP;
  __nv_bfloat16* sS = reinterpret_cast<__nv_bfloat16*>(tc_smem);  // [TC_ROWS][lds] the states
  __nv_bfloat16* sP = sS + TC_ROWS * lds;                            // [TC_ROWS][MID_LDP] p
  __nv_bfloat16* sR = sP + TC_ROWS * MID_LDP;                        // [2][MID_SLOT] table chunks
  float* sZ = reinterpret_cast<float*>(sR + 2 * MID_SLOT);           // [TC_ROWS] logZ, +inf past B
  float* sD = sZ + TC_ROWS;                                          // [TC_ROWS] dloss
  int* sA = reinterpret_cast<int*>(sD + TC_ROWS);  // [TC_ROWS] the answer, -1 outside [0, n_valid)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int n_lg = (MID_COLS / MID_SUB) * nl, per_tile = n_lg + np;  // 4 Hp / 64 steps: even
  const int per = tiles_per_split / (MID_COLS / VT);
  const int n_tiles = (V + MID_COLS - 1) / MID_COLS;
  const int t_begin = blockIdx.x * per, n = max(min(t_begin + per, n_tiles) - t_begin, 0);
  const int n_steps = n * per_tile;
  const int kb = (B + 15) / 16;  // the dT product's K: k16 blocks of batch rows with a row < B
  // the logits' warp tile (rows 64 wm, columns 32 wn of a sub-tile); the
  // products' (warps 0-3: dT's catalog columns pm, 32 of them; 4-7: ds's
  // batch rows pm, 64 of them)
  const int wm = warp & 3, wn = warp >> 2;
  const bool dt_warp = warp < 4;
  const int pm = dt_warp ? 32 * warp : 64 * (warp - 4);

  tc::stage_states_bf16(sS, states, B, H, Hp);
  {
    // logZ +inf for a row past B, or for every row when no column is
    // valid, so that its p is exp(-inf) = 0 with no mask
    const bool ok = tid < B;
    sZ[tid] = ok && n_valid > 0 ? logz[tid] : INFINITY;
    sD[tid] = ok ? dloss[tid] : 0.f;
    const long long a = ok ? answers[tid] : -1;
    sA[tid] = in_catalog(a, n_valid) ? (int)a : -1;
  }

  // step s: tile t_begin + s / per_tile; within it, step q < n_lg the
  // logits of sub-tile q / nl at hidden chunk q % nl (TC_HL wide, 64 table
  // rows), else the products at chunk q - n_lg (TC_HP wide, the tile's 128
  // table rows); its slot is s & 1
  auto slot = [&](int s) { return sR + (s & 1) * MID_SLOT; };
  auto load_table = [&](int s, float4 (&pre)[4]) {  // step s's table rows, fp32, into pre
    const int tt = s / per_tile, q = s - tt * per_tile, j0 = (t_begin + tt) * MID_COLS;
    const bool lg = q < n_lg;
    const int h0 = lg ? (q % nl) * TC_HL : (q - n_lg) * TC_HP;
    const int col0 = lg ? j0 + (q / nl) * MID_SUB : j0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = tid + THREADS * k;
      const int r = lg ? i >> 4 : i >> 3, h = h0 + (lg ? (i & 15) : (i & 7)) * 4;
      pre[k] = (col0 + r < V && h < H)
                   ? __ldg(reinterpret_cast<const float4*>(table + (size_t)(col0 + r) * H + h))
                   : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  auto fill = [&](int s, const float4 (&pre)[4]) {  // pre, rounded, into step s's slot
    const bool lg = s % per_tile < n_lg;
    __nv_bfloat16* dst = slot(s);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = tid + THREADS * k;
      const int r = lg ? i >> 4 : i >> 3, c4 = (lg ? (i & 15) : (i & 7)) * 4;
      *reinterpret_cast<uint2*>(dst + r * (lg ? MID_LLD : MID_PLD) + c4) =
          make_uint2(tc::pack_bf16(pre[k].x, pre[k].y), tc::pack_bf16(pre[k].z, pre[k].w));
    }
  };
  float acc[4][4][4];
  // this ds warp's fragments of products chunk kc in ds_part, which holds
  // them in fragment order (ce_ds_reduce_tc_kernel<false>, one group of
  // TC_ROWS rows): float4 q = 4 i + j of lane l at (q * 32 + l) * 4
  auto ds_frag = [&](int kc) {
    return ds_part + (((size_t)blockIdx.x * np + kc) * 4 + (warp - 4)) * (32 * 64) + lane * 4;
  };
  // a ds warp's products step sums from 0 on the tensor cores and adds
  // prev, what the split's tile before wrote to ds_part there (by this same
  // thread; 0 in the split's first tile), with one fp32 rounding after its
  // MMAs; prev is loaded at the end of the step before, so that the loads
  // are in flight across the barrier and the MMAs
  float4 prev[16];
  auto carry = [&](int s) {
    const int tt = s / per_tile, kc = s - tt * per_tile - n_lg;
    const float4* src = reinterpret_cast<const float4*>(ds_frag(kc));
    const bool from = !dt_warp && tt > 0;
#pragma unroll
    for (int q = 0; q < 16; ++q) prev[q] = from ? src[q * 32] : make_float4(0.f, 0.f, 0.f, 0.f);
  };

  float4 pre_a[4], pre_b[4];  // the table rows of two steps ahead, alternating
  if (n_steps > 0) {
    load_table(0, pre_a);
    fill(0, pre_a);
    load_table(1, pre_b);  // (n_steps >= per_tile >= 4)
  }
  // step s: cur holds nothing (its rows went to the slot at the end of
  // step s - 1) and takes step s + 2's rows; nxt holds step s + 1's
  auto step = [&](int s, float4 (&cur)[4], const float4 (&nxt)[4]) {
    const int tt = s / per_tile, q = s - tt * per_tile, j0 = (t_begin + tt) * MID_COLS;
    const bool lg = q < n_lg;
    if (!lg || q % nl == 0) {  // a products step, or a sub-tile's first logits step
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    }
    // every thread's rows of step s are in the slot (at s = 0 the states
    // and row scalars too); every reader of the other slot (step s - 1)
    // and of p (the tile before's products) is done
    __syncthreads();
    if (s + 2 < n_steps) load_table(s + 2, cur);
    const __nv_bfloat16* X = slot(s);
    if (lg) {
      const int kc = q % nl, sub = q / nl;
      // acc[i][j] += S[64 wm + 16 i, chunk] . T[32 wn + 8 j, chunk]^T
#pragma unroll
      for (int kk = 0; kk < TC_HL; kk += 16) {
        uint32_t a[4][4], b[4][2];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          tc::ldmatrix_x4(a[i], sS + (64 * wm + 16 * i + tc::a_row(lane)) * lds + kc * TC_HL + kk +
                                    tc::a_col(lane));
#pragma unroll
        for (int jp = 0; jp < 2; ++jp) {
          uint32_t r[4];
          tc::ldmatrix_x4(r, X + (32 * wn + 16 * jp + tc::b_row(lane)) * MID_LLD + kk + tc::b_col(lane));
          b[2 * jp][0] = r[0];
          b[2 * jp][1] = r[1];
          b[2 * jp + 1][0] = r[2];
          b[2 * jp + 1][1] = r[3];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) tc::mma_bf16(acc[i][j], a[i], b[j]);
      }
      if (kc == nl - 1) {  // the sub-tile's logits are complete: p into sP
        const int c0 = MID_SUB * sub + 32 * wn + 2 * t4;  // this thread's columns c0 + 8 j + e
        if (j0 + MID_COLS > n_valid) {  // the tile reaches past the valid columns: exp(-inf) = 0
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                if (j0 + c0 + 8 * j + (e & 1) >= n_valid) acc[i][j][e] = -INFINITY;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int r = 64 * wm + 16 * i + g + 8 * half;
            const float z = sZ[r], d = sD[r];
#pragma unroll
            for (int j = 0; j < 4; ++j)
              *reinterpret_cast<uint32_t*>(sP + r * MID_LDP + c0 + 8 * j) =
                  tc::pack_bf16(expf(acc[i][j][2 * half] - z) * d, expf(acc[i][j][2 * half + 1] - z) * d);
          }
      }
    } else {
      const int kc = q - n_lg, h0 = kc * TC_HP;
      if (dt_warp) {
        // acc[i][j] += p[:, pm + 16 i]^T . S[:, h0 + 8 j] over the batch rows
        for (int k = 0; k < 16 * kb; k += 16) {
          uint32_t a[2][4], b[4][2];
#pragma unroll
          for (int i = 0; i < 2; ++i)
            tc::ldmatrix_x4_trans(a[i], sP + (k + tc::b_row(lane)) * MID_LDP + pm + 16 * i + tc::b_col(lane));
#pragma unroll
          for (int jp = 0; jp < 2; ++jp) {
            uint32_t r[4];
            tc::ldmatrix_x4_trans(r, sS + (k + tc::bt_row(lane)) * lds + h0 + 16 * jp + tc::bt_col(lane));
            b[2 * jp][0] = r[0];
            b[2 * jp][1] = r[1];
            b[2 * jp + 1][0] = r[2];
            b[2 * jp + 1][1] = r[3];
          }
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) tc::mma_bf16(acc[i][j], a[i], b[j]);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; e += 2) {
              const int m = pm + 16 * i + g + 4 * e, h = h0 + 8 * j + 2 * t4;
              if (h < H && j0 + m < V)  // H % 4 == 0 and h is even: h + 1 < H too
                *reinterpret_cast<float2*>(dtable + (size_t)(j0 + m) * H + h) =
                    make_float2(acc[i][j][e], acc[i][j][e + 1]);
            }
      } else {
        // acc[i][j] += p[pm + 16 i, :] . T[:, h0 + 8 j] over the tile's columns
#pragma unroll 2
        for (int k = 0; k < MID_COLS; k += 16) {
          uint32_t a[4][4], b[4][2];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            tc::ldmatrix_x4(a[i], sP + (pm + 16 * i + tc::a_row(lane)) * MID_LDP + k + tc::a_col(lane));
#pragma unroll
          for (int jp = 0; jp < 2; ++jp) {
            uint32_t r[4];
            tc::ldmatrix_x4_trans(r, X + (k + tc::bt_row(lane)) * MID_PLD + 16 * jp + tc::bt_col(lane));
            b[2 * jp][0] = r[0];
            b[2 * jp][1] = r[1];
            b[2 * jp + 1][0] = r[2];
            b[2 * jp + 1][1] = r[3];
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) tc::mma_bf16(acc[i][j], a[i], b[j]);
        }
        float4* dst = reinterpret_cast<float4*>(ds_frag(kc));
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float4 c = prev[4 * i + j];
            dst[(4 * i + j) * 32] =
                make_float4(c.x + acc[i][j][0], c.y + acc[i][j][1], c.z + acc[i][j][2], c.w + acc[i][j][3]);
          }
      }
    }
    if (s + 1 < n_steps) {
      if ((s + 1) % per_tile >= n_lg) carry(s + 1);
      fill(s + 1, nxt);
    }
    if (q == per_tile - 1) {
      // the one-hot term, in ascending i as every route takes it, on the
      // tile's finished dT rows in device memory, from the unrounded states;
      // the vote is also the barrier after every dT write of the tile
      const int a_mine = sA[tid];
      if (__syncthreads_or(a_mine >= j0 && a_mine < j0 + MID_COLS)) {
        for (int h = tid; h < H; h += THREADS)
          for (int i = 0; i < B; ++i) {
            const int a = sA[i];
            if (a >= j0 && a < j0 + MID_COLS)
              dtable[(size_t)a * H + h] -= sD[i] * __ldg(states + (size_t)i * H + h);
          }
      }
    }
  };
  for (int s = 0; s < n_steps; s += 2) {
    step(s, pre_a, pre_b);
    step(s + 1, pre_b, pre_a);
  }
}

// ---- the fp32 form at the middle widths, on the tensor cores with wgmma -------
//
// ce_fwd_mid_tf32_kernel and ce_bwd_mid_tf32_kernel: the forward's and the
// backward's pass 1 in the fp32 form at B <= OC_B and OC_H < H <= MAX_H
// (the middle route; the counterparts of pallas_ce.py:222 _fwd_kernel and
// :340 _grads_kernel at f32, whose products are f32 dot_generals). Before
// them these shapes ran the older sweeps (ce_fwd_partial_kernel<false>,
// ce_bwd_sweep_kernel<false>: fp32 FMAs on 4 x 4 register tiles, each
// 64-row batch chunk staged again for every 64-column tile). Every product
// here is a warpgroup MMA (wgmma.cuh: wgmma.mma_async m64nNk8 TF32, a from
// registers, b from shared memory) in tensor_core.cuh's 3xTF32 format: each
// fp32 operand split into a TF32 hi and lo (split_tf32), three passes a k8
// block (lo . hi, hi . lo, hi . hi), which keeps fp32 accuracy. mma.sync,
// which the wide kernels issue at ~79-93 G/s whatever the operand type,
// caps 3xTF32 below the 67 TFLOP/s of fp32 FMAs; wgmma is the way to the
// 495 TFLOP/s TF32 rate.
//
// Bound at B=256, V=1M, H=256: the forward's logits 3 x 2BVH = 393 GFLOP
// of TF32 passes, 0.794 ms at 495 TFLOP/s (H = 128: 0.397); the backward's
// three products 2.383 ms (1.192); the fp32 table read once, 1.02 GB
// (0.306 ms at 3.35 TB/s), and dT written once, as many bytes.
//
// Geometry, both kernels: one block of 256 threads (two warpgroups) per SM
// over a split of whole tiles of MF_COLS = 128 catalog columns, against
// every batch row (B <= 256: the m64 tiles mt < ceil(B / 64), the others
// skipped by a block-uniform bound). TF32 wgmma reads b only K-major (k
// along a stored row) from shared memory, in wgmma.cuh's canonical layout,
// and its operands come split: so every b operand is written into shared
// memory by the threads as a hi plane and a lo plane, split once as it is
// stored (16-byte stores, eight neighbouring lanes on eight rows of a core
// matrix), and every a operand is split in registers where it is loaded.
// The logits of a tile (mf_logits, wgmma_tf32_tile.cuh, shared by both
// kernels and by streaming_rank.cu's rank_mid_tf32_kernel): warpgroup w
// takes catalog columns 64 w .. 64 w + 63 (b: the table rows, K-major as
// stored) and every m64 tile of batch rows (a: the state rows by ldmatrix
// from a cp.async copy [256][KC + 4] as stored), m64n64 MMAs, acc[4][8][4]:
// 128 fp32 registers a thread in wgmma's accumulator layout, whose columns
// are fold_tile's. Per step of KC hidden columns and per m64 tile, the
// three passes of MF_CHAIN = 2 k8 blocks are summed on the tensor cores
// from 0 (scale-d 0), waited for, and added to acc with one fp32 rounding:
// a tensor core truncates its sum to its largest addend, so no sum runs
// long there. (Summed over all of H in the MMAs' own accumulators, with
// no partial sums, the logits read 6x further from the plain version -
// logZ 2.0e-6, dT 4.9e-5 of WIDE_GRAD_TOL's 1e-4 at H = 256 - for a
// backward 6% faster; partial sums of one or four blocks read as two do:
// tools/ablate_ce_tc.py --mid, PERF.md.) A step's table rows
// come by 16-byte loads into registers a step ahead and are split into
// the planes of the other slot after the step's MMAs; its state rows by
// cp.async a step ahead; two slots, one barrier a step.
//
// ce_fwd_mid_tf32_kernel: KC = MF_FKC = 32, Hp / 32 steps a tile (Hp = H up
// to a multiple of 32); after a tile's last step fold_tile folds the
// logits into each row's online (max, sum), and after the split
// merge_group<true> merges them (the wide forward's fold and merge order,
// in wgmma's rows) for ce_fwd_merge_kernel<false>. Shared memory: two
// slots of 69,632 B ([256][36] states, the table's hi and lo planes
// [128][32]), the warpgroups' exchange 2,048: 141,312 B.
//
// ce_bwd_mid_tf32_kernel, the backward on the same shapes, which the route
// does not take: ce_bwd_wide_tf32_kernel, its 256-row groups, is faster at
// B = 256 at H = 128 and 256 (PERF.md row 4m), the batch main trains at;
// tools/ablate_ce_tc.py routes this kernel there. Per tile, Hp / 16
// logits steps (KC = MF_BKC = 16, Hp = H up to a multiple of MF_HP = 32),
// then p = exp(logit - logZ) * dloss (-inf past n_valid, logZ +inf past
// B: no branch an element) from the accumulators into sP [256][128] fp32
// (its 16-byte pieces permuted by the row, mf_sp, so that the stores and
// the loads below fall on distinct banks), then Hp / 32 products steps of
// MF_HP = 32 hidden columns:
//   ds  warpgroup w: batch rows 128 w .. 128 w + 127 (its m64 tiles below
//       ceil(B / 64)), ds[:, chunk] = p . T[tile, chunk], K = the tile's
//       128 columns, m64n32 MMAs: a = p by ldmatrix from sP; b = the
//       chunk's table rows transposed, [32 hidden][128 columns] planes;
//   dT  warpgroup w: catalog columns 64 w .. 64 w + 63, dT[tile, chunk] =
//       p^T . S[:, chunk], K = the batch rows up to 16 ceil(B / 16), m64n32
//       MMAs: a = p^T by 8-byte loads from sP (lane (g, t) takes columns
//       2g, 2g + 1 and batch rows 2t, 2t + 1 of each k8 block: wgmma's rows
//       and k permuted alike); b = the chunk's state rows transposed, [32
//       hidden][256 rows] planes, the rows in that k order; one
//       accumulator over all of K (two, alternating and added at the end,
//       were slower: they cost registers).
//   Both b planes hold the chunk's hidden columns permuted (mf_sigma_inv)
//   so that each lane's accumulators cover four neighbouring hidden
//   columns: dT goes out as float4 stores and ds in
//   ce_ds_reduce_tc_kernel<true>'s fragment order (ce_bwd_wide_tf32_kernel's:
//   its ds warp W = the m64 tile, i = w & 3). A products step's sums start
//   from 0 on the tensor cores and are added to the split's ds_part from
//   the tile before with one fp32 rounding (loaded while the MMAs run; the
//   split's first tile only writes). a is double-buffered in registers: k8
//   block kb + 1 is loaded and split while kb's MMAs run (wgmma.wait_group
//   1). The step's table rows (again, from L2) and state rows come by
//   16-byte loads into registers a step ahead, are transposed in registers
//   and split as they are stored, after a second barrier (the one slot is
//   the region the logits slots use).
// Then the one-hot term dT[a_i] -= dloss_i * s_i on the tile's finished dT
// rows in device memory, in ascending i (ce_bwd_mid_tc_kernel's). Shared
// memory: p 131,072 B, the region 98,304 (two logits slots of 36,864, or
// the products planes: table 2 x 16,384, states 2 x 32,768), logZ, dloss and
// the answers 3,072: 232,448 B, all a block may use.
//
// What holds the backward back (tools/ablate_ce_tc.py --mid, PERF.md): its
// products steps' m64n32 MMAs, each fed one k8 block of a registers, run
// at ~30% of the tensor rate (the forward's m64n64 at ~55%), and its 255
// registers spill 780 bytes. Redesigns that were slower on the H100: the
// products as two noinline phases (the logits' registers then spilled),
// and as m64n128 MMAs over 32-row chunks streamed through two slots. At B
// = 256 it takes ~10.0 ms at H = 256 against ce_bwd_wide_tf32_kernel's
// ~7.5 (at B = 128 ~5.7 against ~7.3): hence the route.
//
// Sums run in a fixed order and pass 2 merges the splits in split order:
// two calls give the same bits.

// The shared product's pieces (wgmma_tf32_tile.cuh): MF_COLS = 128 catalog
// columns per tile (both kernels), the forward's MF_FKC = 32 hidden columns
// a logits step, MF_CHAIN, mf_lslot, the table's staging and mf_logits.
constexpr int MF_BKC = 16;    // hidden columns per logits step: the backward's
constexpr int MF_HP = 32;     // hidden columns per products step (H is padded to a multiple)
// the backward's products slot (floats): the table's planes [MF_HP][MF_COLS]
// (hi, lo), then the states' [MF_HP][TC_ROWS]
constexpr int MF_PSLOT = 2 * MF_HP * MF_COLS + 2 * MF_HP * TC_ROWS;
constexpr long long MF_FWD_SMEM = 4LL * (2 * mf_lslot(MF_FKC) + 2 * TC_ROWS);          // 141,312 B
constexpr long long MF_BWD_SMEM = 4LL * (TC_ROWS * MF_COLS + MF_PSLOT + 3 * TC_ROWS);  // 232,448 B
static_assert(MF_FWD_SMEM <= MAX_SMEM && MF_BWD_SMEM <= MAX_SMEM && 2 * mf_lslot(MF_BKC) <= MF_PSLOT &&
                  MF_COLS == FT_COLS && MF_COLS % VT == 0 && TC_ROWS == THREADS && THREADS == 256 &&
                  TC_ROWS == MF_ROWS && THREADS == MF_THREADS &&
                  MAX_H % MF_HP == 0 && MF_HP % MF_FKC == 0 && MF_HP % MF_BKC == 0 &&
                  MF_HP == TF_HL && MF_HP == 32 && MF_COLS == 128,
              "two warpgroups over 256 batch rows x 128 columns; ds_part in the wide fp32 "
              "backward's order (ce_ds_reduce_tc_kernel<true>, Hp a multiple of TF_HL)");
static_assert(MF_BKC % 16 == 0, "whole warp-wide groups of table pieces, whole k8 blocks");

__device__ __forceinline__ float comp(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

__global__ void __launch_bounds__(THREADS, 1)
ce_fwd_mid_tf32_kernel(const float* __restrict__ states, const float* __restrict__ table, int B,
                       int V, int H, int n_valid, int tiles_per_split,
                       float* __restrict__ part_m, float* __restrict__ part_s) {
  constexpr int KC = MF_FKC, SLOT = mf_lslot(KC), NP = MF_COLS * KC / 4 / THREADS;
  extern __shared__ __align__(128) float mf_smem[];
  float* xm = mf_smem + 2 * SLOT;  // [TC_ROWS] warpgroup 1's m
  float* xs = xm + TC_ROWS;     // [TC_ROWS] ... and its sum
  const int nk = round_up(H, KC) / KC;
  const int per = tiles_per_split / (MF_COLS / VT);
  const int n_tiles = (V + MF_COLS - 1) / MF_COLS;
  const int t_begin = blockIdx.x * per, t_end = min(t_begin + per, n_tiles);
  const int n_steps = max(t_end - t_begin, 0) * nk;
  const int mt_end = (B + 63) / 64;

  // step s: hidden chunk s % nk of tile t_begin + s / nk, in slot s & 1
  auto slot = [&](int s) { return mf_smem + (s & 1) * SLOT; };
  auto th = [&](int s) { return slot(s) + TC_ROWS * (KC + 4); };
  float4 pre[NP];  // a step's table pieces, loaded a step ahead
  auto issue_states = [&](int s) {
    copy_chunk_async<TC_ROWS, KC>(slot(s), KC + 4, states, 0, B, H, (s % nk) * KC);
  };
  auto load_table = [&](int s) {
    mf_load_table<KC>(pre, table, (t_begin + s / nk) * MF_COLS, (s % nk) * KC, V, H);
  };
  auto store_table = [&](int s) {
    mf_store_table<KC>(pre, th(s), th(s) + MF_COLS * KC);
    wg::fence_proxy_async();
  };

  float m[8], sum[8];  // row q = 2 i + half of this thread: 64 i + 16 (warp & 3) + g + 8 half
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    m[q] = -INFINITY;
    sum[q] = 0.f;
  }
  float acc[4][8][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  if (n_steps > 0) {
    issue_states(0);
    load_table(0);
    store_table(0);
  }
  onchip::cp_async_commit();
  for (int s = 0; s < n_steps; ++s) {
    onchip::cp_async_wait_all();  // this thread's copies of step s have landed
    __syncthreads();  // everyone's, and step s's table planes; step s - 1's MMAs are done
    if (s + 1 < n_steps) {
      issue_states(s + 1);
      load_table(s + 1);
    }
    onchip::cp_async_commit();
    mf_logits<KC>(acc, slot(s), th(s), th(s) + MF_COLS * KC, mt_end);
    if (s % nk == nk - 1)  // the tile is complete: fold its logits
      fold_tile(acc, m, sum, (t_begin + s / nk) * MF_COLS, n_valid);
    if (s + 1 < n_steps) store_table(s + 1);  // its slot was last read by step s - 1
  }
  merge_group<true>(m, sum, xm, xs, 0, B, part_m, part_s);
}

// Of a products step's 32 hidden columns, the plane row (wgmma's n) that
// holds hidden column h: n = 8 j + 2 t + e holds 16 (j >> 1) + 4 t + 2 (j &
// 1) + e, so that lane t's accumulators of n8 blocks 2 jj and 2 jj + 1 are
// hidden columns 16 jj + 4 t .. 16 jj + 4 t + 3.
__device__ __forceinline__ int mf_sigma_inv(int h) {
  return 16 * (h >> 4) + 8 * ((h >> 1) & 1) + 2 * ((h >> 2) & 3) + (h & 1);
}

// p's element (r, c) in sP [TC_ROWS][MF_COLS]: the row's 16-byte pieces
// permuted by r & 7.
__device__ __forceinline__ int mf_sp(int r, int c) {
  return r * MF_COLS + ((((c >> 2) ^ (r & 7)) << 2) | (c & 3));
}

// The float4 of ds_part that holds, of split `split`, the 16 hidden columns
// kc, m64 tile W, warp i = w & 3, half and lane (row 64 W + 16 i + g + 8
// half, columns 16 kc + 4 t ..): ce_ds_reduce_tc_kernel<true>'s order, one
// group of TC_ROWS rows, Hp / 16 chunks.
__device__ __forceinline__ size_t mf_ds_at(int split, int Hp, int kc, int W, int i, int half, int lane) {
  return (((size_t)split * (Hp / 16) + kc) * 4 + W) * 256 + (2 * i + half) * 32 + lane;
}

__global__ void __launch_bounds__(THREADS, 1)
ce_bwd_mid_tf32_kernel(const float* __restrict__ states, const float* __restrict__ table,
                       const long long* __restrict__ answers, const float* __restrict__ logz,
                       const float* __restrict__ dloss, int B, int V, int H, int n_valid,
                       int tiles_per_split, float* __restrict__ ds_part,
                       float* __restrict__ dtable) {
  constexpr int KC = MF_BKC, LSLOT = mf_lslot(KC), NP = MF_COLS * KC / 4 / THREADS;
  extern __shared__ __align__(128) float mf_smem[];
  float* sP = mf_smem;                     // [TC_ROWS][MF_COLS] p (mf_sp)
  float* sR = sP + TC_ROWS * MF_COLS;      // two logits slots, or the products slot
  float* tth = sR;                         // products: the table's planes [MF_HP][MF_COLS]
  float* ttl = tth + MF_HP * MF_COLS;
  float* sth = ttl + MF_HP * MF_COLS;      // ... the states' [MF_HP][TC_ROWS]
  float* stl = sth + MF_HP * TC_ROWS;
  float* sZ = sR + MF_PSLOT;               // [TC_ROWS] logZ, +inf past B
  float* sD = sZ + TC_ROWS;                // [TC_ROWS] dloss
  int* sA = reinterpret_cast<int*>(sD + TC_ROWS);  // [TC_ROWS] the answer, -1 outside [0, n_valid)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3, wr = warp & 3, w = warp >> 2;
  const int Hp = round_up(H, MF_HP), nl = Hp / KC, np = Hp / MF_HP;
  const int per = tiles_per_split / (MF_COLS / VT);
  const int n_tiles = (V + MF_COLS - 1) / MF_COLS;
  const int t_begin = blockIdx.x * per, t_end = min(t_begin + per, n_tiles);
  const int mt_end = (B + 63) / 64;
  const int kb_end = round_up((B + 7) / 8, 2);  // the dT product's k8 blocks: rows < B, in pairs

  {
    // logZ +inf for a row past B, or for every row when no column is
    // valid, so that its p is exp(-inf) = 0 with no mask
    const bool ok = tid < B;
    sZ[tid] = ok && n_valid > 0 ? logz[tid] : INFINITY;
    sD[tid] = ok ? dloss[tid] : 0.f;
    const long long a = ok ? answers[tid] : -1;
    sA[tid] = in_catalog(a, n_valid) ? (int)a : -1;
  }

  for (int tt = t_begin; tt < t_end; ++tt) {
    const int j0 = tt * MF_COLS;
    // ---- the logits: nl steps of KC hidden columns, slots s & 1 of the region
    auto slot = [&](int s) { return sR + (s & 1) * LSLOT; };
    auto th = [&](int s) { return slot(s) + TC_ROWS * (KC + 4); };
    float4 pre[NP];
    auto stage = [&](int s, bool first) {  // step s's state rows by cp.async, its table rows into pre
      copy_chunk_async<TC_ROWS, KC>(slot(s), KC + 4, states, 0, B, H, s * KC);
      mf_load_table<KC>(pre, table, j0, s * KC, V, H);
      if (first) {
        mf_store_table<KC>(pre, th(s), th(s) + MF_COLS * KC);
        wg::fence_proxy_async();
      }
    };
    // the region is free: the tile before ended with barriers after its last MMAs
    stage(0, true);
    onchip::cp_async_commit();
    float acc[4][8][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    for (int s = 0; s < nl; ++s) {
      onchip::cp_async_wait_all();
      __syncthreads();  // step s's rows (at the first tile's s = 0 the row scalars too); step s - 1's MMAs are done
      if (s + 1 < nl) stage(s + 1, false);
      onchip::cp_async_commit();
      mf_logits<KC>(acc, slot(s), th(s), th(s) + MF_COLS * KC, mt_end);
      if (s + 1 < nl) {
        mf_store_table<KC>(pre, th(s + 1), th(s + 1) + MF_COLS * KC);
        wg::fence_proxy_async();
      }
    }
    // ---- p = exp(logit - logZ) * dloss into sP: the logits past n_valid
    // set to -inf in the tile that reaches past it
    {
      const bool ragged = j0 + MF_COLS > n_valid;
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        if (mt >= mt_end) break;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = 64 * mt + 16 * wr + g + 8 * half;
          const float z = sZ[r], d = sD[r];
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int c = 64 * w + 8 * j + 2 * t4;
            float l0 = acc[mt][j][2 * half], l1 = acc[mt][j][2 * half + 1];
            if (ragged) {
              if (j0 + c >= n_valid) l0 = -INFINITY;
              if (j0 + c + 1 >= n_valid) l1 = -INFINITY;
            }
            *reinterpret_cast<float2*>(sP + mf_sp(r, c)) = make_float2(expf(l0 - z) * d, expf(l1 - z) * d);
          }
        }
      }
    }

    // ---- the products: np steps of MF_HP hidden columns in the one slot;
    // this thread's 4 x 4 blocks of a step: table rows 4 cq .. of the tile
    // and batch rows 8 bg + par + 2 i (i < 4) of the states, at hidden
    // columns 4 hq .. 4 hq + 3 of the chunk
    const int hq = lane & 7, cq = 4 * warp + (lane >> 3);
    float4 tp[4], sp[2][4];
    auto load_products = [&](int k) {
      const int h = k * MF_HP + 4 * hq;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = j0 + 4 * cq + i;
        tp[i] = (c < V && h < H) ? __ldg(reinterpret_cast<const float4*>(table + (size_t)c * H + h))
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const int u = (tid + THREADS * v) >> 3, b0 = 8 * (u >> 1) + (u & 1);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int b = b0 + 2 * i;
          sp[v][i] = (b < B && h < H) ? __ldg(reinterpret_cast<const float4*>(states + (size_t)b * H + h))
                                      : make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
    };
    // transposed and split into the planes: the table's [hidden n][column],
    // the states' [hidden n][row position], rows 8 bg + par + 2 i at
    // positions 8 bg + 4 par + i (the dT product's k order)
    auto store_products = [&]() {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = mf_sigma_inv(4 * hq + e);
        uint4 hi, lo;
        split4(make_float4(comp(tp[0], e), comp(tp[1], e), comp(tp[2], e), comp(tp[3], e)), hi, lo);
        const int o = wg::canonical(n, 4 * cq, MF_COLS);
        *reinterpret_cast<uint4*>(tth + o) = hi;
        *reinterpret_cast<uint4*>(ttl + o) = lo;
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          const int u = (tid + THREADS * v) >> 3;
          split4(make_float4(comp(sp[v][0], e), comp(sp[v][1], e), comp(sp[v][2], e), comp(sp[v][3], e)),
                 hi, lo);
          const int os = wg::canonical(n, 8 * (u >> 1) + 4 * (u & 1), TC_ROWS);
          *reinterpret_cast<uint4*>(sth + os) = hi;
          *reinterpret_cast<uint4*>(stl + os) = lo;
        }
      }
      wg::fence_proxy_async();
    };
    load_products(0);
    __syncthreads();  // every logits MMA is done with the region; p is complete
    store_products();
    for (int k = 0; k < np; ++k) {
      __syncthreads();  // step k's planes
      if (k + 1 < np) load_products(k + 1);
      const int h0 = k * MF_HP;
      // a is double-buffered over one stream of k8 blocks (ds's m64 tiles,
      // then dT's, each an even number of blocks, so each starts in buffer
      // 0): block kb + 1 is loaded and split while kb's MMAs run, once
      // wgmma.wait_group 1 has retired kb - 1's, the last reader of its buffer
      uint32_t ah[2][4], al[2][4];
      // ds: warpgroup w's m64 tiles 2 w + mi of batch rows, K = the tile's
      // columns, a = p by ldmatrix
      float dsa[2][16];
      float4 prev[2][2][2];  // [mi][jj][half]: ds_part of the tile before
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        if (2 * w + mi >= mt_end) break;
        const int ra = 128 * w + 64 * mi + 16 * wr + tc::a_row(lane);
        auto frag = [&](int kb, uint32_t (&h)[4], uint32_t (&l)[4]) {
          uint32_t r[4];
          tc::ldmatrix_x4(r, sP + mf_sp(ra, 8 * kb + tc::a_col32(lane)));
#pragma unroll
          for (int e = 0; e < 4; ++e) tc::split_tf32(r[e], h[e], l[e]);
        };
        wg::wait<1>();
        frag(0, ah[0], al[0]);
#pragma unroll
        for (int kb = 0; kb < MF_COLS / 8; ++kb) {
          wg::fence();
          wg::mma_3xtf32<32>(dsa[mi], ah[kb & 1], al[kb & 1], wg::desc(tth + 64 * kb, MF_COLS),
                             wg::desc(ttl + 64 * kb, MF_COLS), kb);
          wg::commit();
          if (kb + 1 < MF_COLS / 8) {
            wg::wait<1>();
            frag(kb + 1, ah[(kb + 1) & 1], al[(kb + 1) & 1]);
          }
        }
        // the carry's loads, in flight while the MMAs run
#pragma unroll
        for (int jj = 0; jj < 2; ++jj)
#pragma unroll
          for (int half = 0; half < 2; ++half)
            prev[mi][jj][half] =
                tt != t_begin ? reinterpret_cast<const float4*>(ds_part)[mf_ds_at(blockIdx.x, Hp, 2 * k + jj,
                                                                                  2 * w + mi, wr, half, lane)]
                              : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      // dT: warpgroup w's catalog columns 64 w .. 64 w + 63, K = the batch
      // rows, a = p^T by 8-byte loads
      float dta[16];
      {
        const int ca = 64 * w + 16 * wr + 2 * g;
        auto frag = [&](int kb, uint32_t (&h)[4], uint32_t (&l)[4]) {
          const int b = 8 * kb + 2 * t4;
          const float2 v0 = *reinterpret_cast<const float2*>(sP + mf_sp(b, ca));
          const float2 v1 = *reinterpret_cast<const float2*>(sP + mf_sp(b + 1, ca));
          tc::split_tf32(__float_as_uint(v0.x), h[0], l[0]);
          tc::split_tf32(__float_as_uint(v0.y), h[1], l[1]);
          tc::split_tf32(__float_as_uint(v1.x), h[2], l[2]);
          tc::split_tf32(__float_as_uint(v1.y), h[3], l[3]);
        };
        wg::wait<1>();
        frag(0, ah[0], al[0]);
        for (int kb = 0; kb < kb_end; kb += 2) {
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            wg::fence();
            wg::mma_3xtf32<32>(dta, ah[u], al[u], wg::desc(sth + 64 * (kb + u), TC_ROWS),
                               wg::desc(stl + 64 * (kb + u), TC_ROWS), kb + u);
            wg::commit();
            if (kb + u + 1 < kb_end) {
              wg::wait<1>();
              frag(kb + u + 1, ah[u ^ 1], al[u ^ 1]);
            }
          }
        }
      }
      wg::wait<0>();
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) wg::fence_regs(dsa[mi]);
      wg::fence_regs(dta);
      // ds_part: prev + the step's sums, in ce_ds_reduce_tc_kernel<true>'s order
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        if (2 * w + mi >= mt_end) break;
#pragma unroll
        for (int jj = 0; jj < 2; ++jj)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const float* c = dsa[mi] + 8 * jj + 2 * half;
            const float4 pv = prev[mi][jj][half];
            reinterpret_cast<float4*>(ds_part)[mf_ds_at(blockIdx.x, Hp, 2 * k + jj, 2 * w + mi, wr, half, lane)] =
                make_float4(pv.x + c[0], pv.y + c[1], pv.z + c[4], pv.w + c[5]);
          }
      }
      // dT rows j0 + 64 w + 16 (warp & 3) + 2 g + half, hidden columns h0 + 16 jj + 4 t ..
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int col = j0 + 64 * w + 16 * wr + 2 * g + half;
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int h = h0 + 16 * jj + 4 * t4, i0 = 8 * jj + 2 * half;
          if (col < V && h < H)
            *reinterpret_cast<float4*>(dtable + (size_t)col * H + h) =
                make_float4(dta[i0], dta[i0 + 1], dta[i0 + 4], dta[i0 + 5]);
        }
      }
      __syncthreads();  // every MMA of step k is done with the planes
      if (k + 1 < np) store_products();
    }
    // the one-hot term, in ascending i as every route takes it, on the
    // tile's finished dT rows in device memory, from the states; the vote
    // is also the barrier after every dT write of the tile
    const int a_mine = sA[tid];
    if (__syncthreads_or(a_mine >= j0 && a_mine < j0 + MF_COLS)) {
      for (int h = tid; h < H; h += THREADS)
        for (int i = 0; i < B; ++i) {
          const int a = sA[i];
          if (a >= j0 && a < j0 + MF_COLS) dtable[(size_t)a * H + h] -= sD[i] * __ldg(states + (size_t)i * H + h);
        }
    }
  }
}

bool bad_shape(int B, int V, int H) { return B < 1 || V < 1 || H < 4 || H % 4 != 0; }

// The route of both sweeps, by shape: the on-chip kernels where the batch
// (and the backward's ds) fit beside the tiles; past MAX_H the wide
// route, which walks H in chunks on the tensor cores in either form:
// forward, ce_fwd_wide_tf32_kernel (fp32, 3xTF32) and ce_fwd_wide_tc_kernel
// (bf16); backward, ce_bwd_wide_tf32_kernel and ce_bwd_wide_tc_kernel;
// ce_fwd_partial_kernel and ce_bwd_sweep_kernel elsewhere.
bool onchip_route(int B, int H) { return B <= OC_B && H <= OC_H; }
bool wide_route(int H) { return H > MAX_H; }
// ... and the middle route, B <= OC_B and OC_H < H <= MAX_H, where the bf16
// form runs ce_fwd_mid_tc_kernel and ce_bwd_mid_tc_kernel, the fp32 form
// ce_fwd_mid_tf32_kernel and the wide route's ce_bwd_wide_tf32_kernel
bool mid_route(int B, int H) { return B <= OC_B && H > OC_H && H <= MAX_H; }
// ... and the backward tensor-core kernel's tile: catalog columns, and the
// multiple of 64 that H is padded to
int grads_tc_cols(int bf16) { return bf16 ? TC_SV : TF_COLS; }
int grads_tc_hp(int H, int bf16) { return round_up(H, bf16 ? TC_HL : TF_HL); }

}  // namespace

extern "C" {

// Shared memory of the forward's pass 1 (which = 0) and of the backward's
// pass 1 (which = 1) on the route B, H and the form (bf16 != 0: the
// bf16-operand form) take.
long long streaming_ce_smem_bytes(int B, int H, int which, int bf16) {
  const long long ld = H + 4;
  if (wide_route(H)) return which == 0 ? (bf16 ? FT_SMEM : FW_SMEM) : (bf16 ? TC_SMEM : TF_SMEM);
  if (bf16 && onchip_route(B, H)) return which == 0 ? FO_SMEM : BO_SMEM;
  if (bf16 && mid_route(B, H)) {
    const int Hp = round_up(H, TC_HL);
    return which == 0 ? mid_fwd_smem(Hp) : mid_bwd_smem(Hp);
  }
  if (mid_route(B, H)) return which == 0 ? MF_FWD_SMEM : TF_SMEM;
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
// dimension in chunks, on a tensor-core kernel in either form. ce_logz's
// tiles there are FT_COLS = 128 columns in both forms (ce_fwd_wide_tf32_kernel,
// ce_fwd_wide_tc_kernel); ce_grads' TF_COLS = 128 in the fp32 form
// (ce_bwd_wide_tf32_kernel) and TC_SV = 256 in the bf16 form
// (ce_bwd_wide_tc_kernel): tiles_per_split is a multiple of 2, or of 4.
int ce_wide_route(int H) { return wide_route(H) ? 1 : 0; }

// 1 where both forms take their middle route (B <= 256, 64 < H <= 256):
// the bf16 form ce_fwd_mid_tc_kernel (tiles of FT_COLS = 128 columns) and
// ce_bwd_mid_tc_kernel (MID_COLS = 128), the fp32 form
// ce_fwd_mid_tf32_kernel (MF_COLS = 128) and ce_bwd_wide_tf32_kernel
// (TF_COLS = 128): tiles_per_split is a multiple of 2 there.
int ce_mid_route(int B, int H) { return mid_route(B, H) ? 1 : 0; }

// Bytes of the workspace that ce_logz takes at batch B, hidden size H, form
// bf16 and n_splits splits: the splits' partials (max, then sum), fp32
// [2, n_splits, B]; in the bf16 form on the wide route then, 256-byte
// aligned, its bf16 states [Bp, Hp] (Bp = B up to a multiple of 256, Hp =
// H up to a multiple of 64).
long long ce_logz_workspace_bytes(int B, int H, int bf16, int n_splits) {
  const long long parts = (8LL * n_splits * B + 255) / 256 * 256;
  if (!(bf16 && wide_route(H))) return parts;
  return parts + 2LL * round_up(B, TC_ROWS) * round_up(H, TC_HL);
}

// Bytes of the workspace that ce_grads takes at batch B, hidden size H,
// form bf16 and n_splits splits: ds_part, the splits' partial ds, fp32
// [n_splits, B, H]; on the tensor-core route instead [n_splits, Bp, Hp] in
// the kernel's fragment order (ce_ds_reduce_tc_kernel; Bp = B up to a
// multiple of 256, Hp = H up to a multiple of 32 in the fp32 form, of 64
// in the bf16 form), and in the bf16 form then its bf16 states [Bp, Hp]
// and one bf16 table tile [256, Hp] a split; on the middle route
// [n_splits, 256, Hp] in that order alone (Hp a multiple of 64 in the bf16
// form, of 32 in the fp32 form).
long long ce_grads_workspace_bytes(int B, int H, int bf16, int n_splits) {
  if (mid_route(B, H)) return 4LL * n_splits * TC_ROWS * round_up(H, bf16 ? TC_HL : MF_HP);
  if (!wide_route(H)) return 4LL * n_splits * B * H;
  const long long Bp = round_up(B, TC_ROWS), Hp = grads_tc_hp(H, bf16);
  return 4LL * n_splits * Bp * Hp + (bf16 ? 2LL * (Bp + (long long)n_splits * TC_SV) * Hp : 0);
}

// logZ [B] of states [B, H] against table [V, H] over columns < n_valid,
// and, when answers (int64 [B]) and loss are not null, loss [B] = logZ -
// <states[i], table[answers[i]]> with gold 0 for answers outside
// [0, n_valid). answers and loss are both given or both null. bf16 != 0
// takes the bf16-operand form (the file's head). The route is the shape's
// (ce_onchip_route, ce_wide_route, ce_mid_route): one block per SM suits
// the on-chip, middle and wide routes, two the older one, over (splits x
// batch tiles of 64 rows). The caller allocates the workspace
// (ce_logz_workspace_bytes); n_splits * tiles_per_split tiles must cover V,
// and on the tensor-core kernels' 128-column tiles tiles_per_split is even
// and every split holds at least one tile.
// Returns 0 or a cudaError_t code.
int ce_logz(const void* states, const void* table, const void* answers, int B, int V, int H,
            int n_valid, int n_splits, int tiles_per_split, void* workspace, void* logz,
            void* loss, int bf16, void* stream) {
  const bool wide = wide_route(H);  // a tensor-core kernel in either form
  const bool mid = mid_route(B, H);  // ce_fwd_mid_tc_kernel, ce_fwd_mid_tf32_kernel
  const bool tiled = wide || mid || (bf16 && onchip_route(B, H));  // FT_COLS-column tiles
  if (bad_shape(B, V, H) || n_valid < 0 || n_valid > V || n_splits < 1 ||
      (long long)n_splits * tiles_per_split * VT < V || (answers == nullptr) != (loss == nullptr) ||
      (tiled && (tiles_per_split % (FT_COLS / VT) != 0 ||
                 (long long)(n_splits - 1) * tiles_per_split * VT >= V)))
    return (int)cudaErrorInvalidValue;
  const long long smem = streaming_ce_smem_bytes(B, H, 0, bf16);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part_m = static_cast<float*>(workspace);
  float* part_s = part_m + (size_t)n_splits * B;
  cudaError_t e;
  if (wide && bf16) {
    const int Bp = round_up(B, TC_ROWS), Hp = round_up(H, TC_HL), n4 = Bp * (Hp / 4);
    __nv_bfloat16* sb = reinterpret_cast<__nv_bfloat16*>(
        static_cast<char*>(workspace) + (8LL * n_splits * B + 255) / 256 * 256);
    states_bf16_kernel<<<(n4 + 255) / 256, 256, 0, s>>>(static_cast<const float*>(states), B, H,
                                                         Bp, Hp, sb);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    e = cudaFuncSetAttribute(ce_fwd_wide_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    ce_fwd_wide_tc_kernel<<<n_splits, THREADS, (size_t)smem, s>>>(
        sb, static_cast<const float*>(table), B, V, H, n_valid, tiles_per_split, part_m, part_s);
  } else if (mid) {
    auto sweep = bf16 ? ce_fwd_mid_tc_kernel : ce_fwd_mid_tf32_kernel;
    e = cudaFuncSetAttribute(sweep, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    sweep<<<n_splits, THREADS, (size_t)smem, s>>>(
        static_cast<const float*>(states), static_cast<const float*>(table), B, V, H, n_valid,
        tiles_per_split, part_m, part_s);
  } else if (wide) {
    e = cudaFuncSetAttribute(ce_fwd_wide_tf32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    ce_fwd_wide_tf32_kernel<<<n_splits, THREADS, (size_t)smem, s>>>(
        static_cast<const float*>(states), static_cast<const float*>(table), B, V, H, n_valid,
        tiles_per_split, part_m, part_s);
  } else {
    const bool onchip = onchip_route(B, H);
    auto sweep = onchip ? (bf16 ? ce_fwd_onchip_tc_kernel : ce_fwd_onchip_kernel)
                        : (bf16 ? ce_fwd_partial_kernel<true> : ce_fwd_partial_kernel<false>);
    e = cudaFuncSetAttribute(sweep, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    sweep<<<dim3(n_splits, onchip ? 1 : (B + BT - 1) / BT), THREADS, (size_t)smem, s>>>(
        static_cast<const float*>(states), static_cast<const float*>(table), B, V, H, n_valid,
        tiles_per_split, part_m, part_s);
  }
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  constexpr int rows_per_block = MERGE_THREADS / 32;
  auto merge = bf16 ? ce_fwd_merge_kernel<true> : ce_fwd_merge_kernel<false>;
  merge<<<(B + rows_per_block - 1) / rows_per_block, MERGE_THREADS, 0, s>>>(
      part_m, part_s, static_cast<const float*>(states), static_cast<const float*>(table),
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
// ce_wide_route, ce_mid_route): one block per SM suits the on-chip
// and tensor-core routes, two the sweep route. The caller allocates the
// workspace (ce_grads_workspace_bytes); n_splits * tiles_per_split tiles
// must cover V, every split must hold at least one tile, and on the
// tensor-core route tiles_per_split is whole tiles of its kernel. Returns
// 0 or a cudaError_t code.
int ce_grads(const void* states, const void* table, const void* answers, const void* logz,
             const void* dloss, int B, int V, int H, int n_valid, int n_splits,
             int tiles_per_split, void* workspace, void* ds, void* dtable, int bf16,
             void* stream) {
  const int n_tiles = (V + VT - 1) / VT;
  // a wide tensor-core kernel in either form (and ce_bwd_wide_tf32_kernel on
  // the fp32 form's middle route)
  const bool tc = wide_route(H) || (!bf16 && mid_route(B, H));
  const bool mid = bf16 && mid_route(B, H);  // ce_bwd_mid_tc_kernel
  if (bad_shape(B, V, H) || n_valid < 0 || n_valid > V || n_splits < 1 ||
      tiles_per_split < 1 || (long long)n_splits * tiles_per_split < n_tiles ||
      (long long)(n_splits - 1) * tiles_per_split >= n_tiles ||
      (tc && tiles_per_split % (grads_tc_cols(bf16) / VT) != 0) ||
      (mid && tiles_per_split % (MID_COLS / VT) != 0))
    return (int)cudaErrorInvalidValue;
  const long long smem = streaming_ce_smem_bytes(B, H, 1, bf16);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* ds_part = static_cast<float*>(workspace);
  const int Bp = round_up(B, TC_ROWS), Hp = grads_tc_hp(H, bf16);  // (the tensor-core route's)
  cudaError_t e;
  if (tc && bf16) {
    __nv_bfloat16* sb = reinterpret_cast<__nv_bfloat16*>(ds_part + (size_t)n_splits * Bp * Hp);
    __nv_bfloat16* tb = sb + (size_t)Bp * Hp;
    const int n4 = Bp * (Hp / 4);
    states_bf16_kernel<<<(n4 + 255) / 256, 256, 0, s>>>(static_cast<const float*>(states), B, H,
                                                         Bp, Hp, sb);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    e = cudaFuncSetAttribute(ce_bwd_wide_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    ce_bwd_wide_tc_kernel<<<n_splits, THREADS, (size_t)smem, s>>>(
        sb, tb, static_cast<const float*>(states), static_cast<const float*>(table),
        static_cast<const long long*>(answers), static_cast<const float*>(logz),
        static_cast<const float*>(dloss), B, V, H, n_valid, tiles_per_split,
        ds_part, static_cast<float*>(dtable));
  } else if (mid) {
    auto sweep = ce_bwd_mid_tc_kernel;
    e = cudaFuncSetAttribute(sweep, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    sweep<<<n_splits, THREADS, (size_t)smem, s>>>(
        static_cast<const float*>(states), static_cast<const float*>(table),
        static_cast<const long long*>(answers), static_cast<const float*>(logz),
        static_cast<const float*>(dloss), B, V, H, n_valid, tiles_per_split,
        ds_part, static_cast<float*>(dtable));
  } else {
    auto sweep = tc                   ? ce_bwd_wide_tf32_kernel
                 : onchip_route(B, H) ? (bf16 ? ce_bwd_onchip_tc_kernel : ce_bwd_onchip_kernel)
                                      : (bf16 ? ce_bwd_sweep_kernel<true> : ce_bwd_sweep_kernel<false>);
    e = cudaFuncSetAttribute(sweep, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    sweep<<<n_splits, THREADS, (size_t)smem, s>>>(
        static_cast<const float*>(states), static_cast<const float*>(table),
        static_cast<const long long*>(answers), static_cast<const float*>(logz),
        static_cast<const float*>(dloss), B, V, H, n_valid, tiles_per_split,
        ds_part, static_cast<float*>(dtable));
  }
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (tc || mid) {  // ds_part in a tensor-core kernel's fragment order (mid: Bp = 256)
    const int n = Bp * Hp;
    auto reduce = bf16 ? ce_ds_reduce_tc_kernel<false> : ce_ds_reduce_tc_kernel<true>;
    reduce<<<(n + REDUCE_THREADS - 1) / REDUCE_THREADS, REDUCE_THREADS, 0, s>>>(
        ds_part, static_cast<const float*>(table),
        static_cast<const long long*>(answers), static_cast<const float*>(dloss),
        B, H, Bp, Hp, n_valid, n_splits, static_cast<float*>(ds));
  } else {
    const int n = B * H;
    ce_ds_reduce_kernel<<<(n + REDUCE_THREADS - 1) / REDUCE_THREADS, REDUCE_THREADS, 0, s>>>(
        ds_part, static_cast<const float*>(table),
        static_cast<const long long*>(answers), static_cast<const float*>(dloss),
        B, H, n_valid, n_splits, static_cast<float*>(ds));
  }
  return (int)cudaGetLastError();
}

const char* streaming_ce_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
