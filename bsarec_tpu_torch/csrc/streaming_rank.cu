// Streaming full-catalog masked top-k for Hopper (sm_90a), fp32.
//
// Replaces bsarec_tpu/ops/pallas_rank.py:_rank_kernel (the Pallas TPU
// kernel behind streaming_masked_topk). Per user row it returns the top k
// of the catalog scores s . T^T without writing the [B, V] score matrix:
//   - seen items (bit v & 31 of word v >> 5 of the row's bitmask; the
//     builders always set item 0) score seen_value: 0.0 for eval (the
//     reference's rating_pred[seen] = 0), -inf for serving, where a seen
//     item never enters the result;
//   - columns >= n_valid score -inf and never enter the result;
//   - candidates are ordered by (value descending, id ascending), the
//     order the TPU kernel produces; slots never filled are (-inf, 0).
//
// What bounds it: at B=256, V=1,000,000, H=64 the work is 2*B*V*H ~ 32.8
// GFLOP, ~0.49 ms at the H100 SXM's 67 TFLOP/s fp32 (non-tensor-core,
// data-sheet) peak, while the 256 MB table read is ~0.08 ms at 3.35 TB/s.
// So the bound is fp32 compute there. At H = 512 the tensor-core route
// takes the scores in 3xTF32 (three TF32 passes, which keep fp32
// accuracy): 3 x 262.14 GFLOP at the dense TF32 rate, 1.589 ms at B=256,
// against 3.913 ms in fp32 FMAs and the 2.05 GB table's 0.612 ms.
//
// Design. The TPU kernel walks the catalog in one sequential grid and
// carries a running top-k in VMEM across steps. Hopper blocks run in no
// order, so this is two passes:
//   pass 1, per vocab split: the masked scores of a tile of the catalog,
//     folded into a sorted top-k list per row. Only scores that beat the
//     row's current k-th entry are offered (the counted-merge idea of
//     pallas_rank.py:209-247), so after the first tiles a row costs a
//     compare. Four routes, picked by shape in the C entry:
//     - the on-chip route, B <= 256, H <= 64 and k <= 32 (the eval path's
//       B=256, H=64, k=20): first rank_sample_kernel scores 4 tiles a
//       split from the catalog's start and keeps, per row, the largest
//       score of each of 64 column buckets; the k-th largest of those is
//       a lower bound on the row's final k-th score. Then
//       rank_onchip_kernel, on onchip_tile.cuh's skeleton: one block of
//       256 threads per SM stages every state row once, brings the table
//       tiles (64 columns) and their bitmask words through a cp.async
//       ring of two, and computes 8 x 8 scores a thread. A warp holds
//       whole rows, so the lists are warp-private: no score tile goes
//       through shared memory and the ring's barrier is the tile's only
//       one. A score below the row's bar (the bound, or the list's k-th)
//       costs one compare; the few above it go, unsorted, to the lane's
//       own slice of a pending buffer, merged into the sorted list by
//       counting when a slice fills and at the split's end. Shared memory
//       at k=20: states 69,632 B, the table ring 34,816, the bitmask ring
//       4,096, the lists 40,960, the pending slices 65,536.
//     - the tensor-core route, H > 256 and k <= 32 (the hidden-512 eval
//       path's B=256, H=512, k=20), any B: rank_wide_tf32_kernel, on
//       streaming_ce.cu's ce_fwd_wide_tf32_kernel's grid, product and ring
//       (tensor_core.cuh: one block per SM, 256 batch rows x 128 catalog
//       columns a tile, the table read once per 256 rows, the scores in
//       3xTF32 on mma.sync), with a top-k epilogue over the accumulator
//       fragments; its head says more.
//     - the middle route, B <= 256, 64 < H <= 256 and k <= 32 (the
//       hidden-256 eval path's B=256, H=256, k=20): rank_mid_tf32_kernel,
//       on streaming_ce.cu's ce_fwd_mid_tf32_kernel's grid and product
//       (wgmma_tf32_tile.cuh: one block per SM over every batch row, the
//       scores in 3xTF32 on Hopper's warpgroup MMAs) with the tensor-core
//       route's epilogue; its head says more.
//     - elsewhere rank_partial_kernel: the grid is (vocab splits x batch
//       tiles of 64 rows), sized by the caller to fill the SMs. Each block
//       keeps its 64 state rows in shared memory, walks its split in
//       tiles of 128 columns (the table tile staged in shared memory in
//       32-wide hidden chunks), computes the 64 x 128 fp32 dot products
//       with FMAs (4 x 8 per thread), applies the seen bit and the
//       n_valid bound, stages the masked tile in shared memory, and one
//       warp a row inserts the scores that can enter into the row's list.
//       Where all 64 state rows ([H][64] floats) do not fit beside the
//       lists (H > ~670 at k = 20, H > ~454 at k = 128), its wide form
//       (WIDE = true) stages the states a 32-wide hidden chunk at a time
//       beside the table's, 124,416 B at k = 128 and any H. It serves
//       B > 256 at H <= 256, and k > 32 at any H.
//     The on-chip and older routes compute each score as one FMA chain
//     over h in ascending order, so their scores, and with the strict
//     order their results, are bit-equal. The middle and tensor-core
//     routes sum each score in another order (three TF32 passes a k8
//     block, the blocks' sums added in fp32): where every score is exact
//     in any order (integer inputs) their values and ids are bit-equal to
//     the others'; elsewhere their values lie within fp32 rounding of
//     theirs, and an id can differ only where two scores lie that close.
//   pass 2 (rank_merge_kernel): one warp per row folds the n_splits
//     partial lists into the final k, offering each list's entries in
//     split order; at k <= 32 the running list sits in the warp's
//     registers, a slot a lane.
// On one "NVIDIA H100 80GB HBM3, 700.00 W" at B=256, V=1,000,000, H=64,
// k=20 (bsarec_tpu_torch/tools/time_kernels.py, chip_smoke.py): the
// on-chip route takes ~1.05 ms (in an eval trace the sample pass ~0.04,
// the sweep ~0.99), 47% of its 0.4891 ms fp32 bound; the older route
// ~2.15 ms. At H = 512 (chip_smoke.py) the tensor-core route takes ~5.9 ms
// at k = 20 (27% of its 1.589 ms 3xTF32 bound; the older route ~13.4, 29%
// of its 3.913 ms FMA bound) and the older route's wide form ~23 ms at
// k = 128; at H = 256 / 128 the middle route ~2.85 / ~1.98 ms (its head).
// The middle route runs wgmma; no kernel here uses TMA.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include "onchip_tile.cuh"
#include "tensor_core.cuh"
#include "wgmma_tf32_tile.cuh"

using namespace mf;

namespace {

constexpr int BT = 64;          // batch rows per block
constexpr int VT = 128;         // catalog columns per tile
constexpr int KC = 32;          // hidden-dim chunk staged per step
constexpr int THREADS = 256;    // 16 x 16 threads, each 4 rows x 8 columns
constexpr int MERGE_WARPS = 4;  // rows per merge block
constexpr int MERGE_BATCH = 8;  // splits' lists a merge warp loads at once
constexpr int MAX_K = 128;
constexpr int MAX_SMEM = 232448;  // usable shared memory per block on sm_90
constexpr int NO_ID = 0x7fffffff;
constexpr unsigned FULL = 0xffffffffu;
constexpr int OC_K = 32;  // the on-chip route: k <= OC_K (a list slot a lane), B <= 256, H <= 64
constexpr int OC_VT = onchip::VT;
constexpr int OC_WORDS = OC_VT / 32;  // bitmask words of a row per tile

// (v, id) ranks ahead of (ov, oid) in the (value desc, id asc) order.
__device__ __forceinline__ bool ahead(float v, int id, float ov, int oid) {
  return v > ov || (v == ov && id < oid);
}

// Insert (cv, cid) into the sorted list lv/li of length k (shared
// memory). Called by a whole warp; (cv, cid) must rank ahead of slot k-1.
__device__ void warp_insert(float* lv, int* li, int k, float cv, int cid, int lane) {
  int pos = 0;
  for (int j0 = 0; j0 < k; j0 += 32) {
    const int j = j0 + lane;
    const bool before = j < k && ahead(lv[j], li[j], cv, cid);
    pos += __popc(__ballot_sync(FULL, before));
  }
  float nv[MAX_K / 32];
  int ni[MAX_K / 32];
#pragma unroll
  for (int t = 0; t < MAX_K / 32; ++t) {
    const int j = t * 32 + lane;
    if (j < k && j >= pos) {
      const int src = max(j - 1, 0);  // never index below the list
      nv[t] = (j == pos) ? cv : lv[src];
      ni[t] = (j == pos) ? cid : li[src];
    }
  }
  __syncwarp();
#pragma unroll
  for (int t = 0; t < MAX_K / 32; ++t) {
    const int j = t * 32 + lane;
    if (j < k && j >= pos) {
      lv[j] = nv[t];
      li[j] = ni[t];
    }
  }
  __syncwarp();
}

// Offer one candidate per lane to the list; those that rank ahead of the
// current k-th entry are inserted one at a time, lowest lane first (the
// order of insertion does not change the result).
__device__ void warp_offer(float* lv, int* li, int k, float v, int id, int lane) {
  bool pending = v > -INFINITY;
  while (true) {
    const float kv = lv[k - 1];
    const int ki = li[k - 1];
    const unsigned m = __ballot_sync(FULL, pending && ahead(v, id, kv, ki));
    if (m == 0) break;
    const int src = __ffs(m) - 1;
    const float cv = __shfl_sync(FULL, v, src);
    const int cid = __shfl_sync(FULL, id, src);
    warp_insert(lv, li, k, cv, cid, lane);
    if (lane == src) pending = false;
  }
}

// WIDE: the states are staged a hidden chunk at a time beside the table's
// ([KC][BT], not [H][BT]), so shared memory does not grow with H; the
// route the C entry takes where the [H][BT] staging does not fit. Each
// score is the same FMA chain either way, so WIDE changes no result.
template <bool WIDE>
__global__ void __launch_bounds__(THREADS, 2)
rank_partial_kernel(const float* __restrict__ states, const float* __restrict__ table,
                    const int32_t* __restrict__ mask, int B, int V, int H, int W,
                    int n_valid, float seen_value, int k, int tiles_per_split,
                    float* __restrict__ part_v, int32_t* __restrict__ part_i) {
  extern __shared__ __align__(16) float smem[];
  float* sS = smem;                          // [H][BT] states, transposed ([KC][BT] if WIDE)
  float* sT = sS + (WIDE ? KC : H) * BT;     // [KC][VT]  table chunk, transposed
  float* sC = sT + KC * VT;             // [BT][VT+1] masked score tile
  float* lv = sC + BT * (VT + 1);       // [BT][k]   running top-k values
  int* li = reinterpret_cast<int*>(lv + BT * k);                // [BT][k] ids
  uint32_t* sM = reinterpret_cast<uint32_t*>(li + BT * k);      // [BT][VT/32]
  int* flag = reinterpret_cast<int*>(sM + BT * (VT / 32));      // [BT]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx = tid & 15, ty = tid >> 4;
  const int split = blockIdx.x, row0 = blockIdx.y * BT;
  const int n_tiles = (V + VT - 1) / VT;
  const int tile_begin = split * tiles_per_split;
  const int tile_end = min(tile_begin + tiles_per_split, n_tiles);

  if constexpr (!WIDE) {
    for (int i = tid; i < BT * H; i += THREADS) {
      const int r = i / H, h = i % H, row = row0 + r;
      sS[h * BT + r] = row < B ? states[(size_t)row * H + h] : 0.f;
    }
  }
  for (int i = tid; i < BT * k; i += THREADS) {
    lv[i] = -INFINITY;
    li[i] = NO_ID;
  }
  if (tid < BT) flag[tid] = 0;

  for (int tile = tile_begin; tile < tile_end; ++tile) {
    const int j0 = tile * VT;
    for (int i = tid; i < BT * (VT / 32); i += THREADS) {
      const int r = i / (VT / 32), w = (j0 >> 5) + i % (VT / 32), row = row0 + r;
      sM[i] = (row < B && w < W) ? static_cast<uint32_t>(mask[(size_t)row * W + w]) : 0u;
    }
    float acc[4][8];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 8; ++b) acc[a][b] = 0.f;

    for (int h0 = 0; h0 < H; h0 += KC) {
      const int hc = min(KC, H - h0);  // H % 4 == 0, so hc % 4 == 0
      __syncthreads();                 // earlier readers of sT/sC are done
      for (int i = tid; i < VT * (KC / 4); i += THREADS) {
        const int c = i % VT, q = i / VT, col = j0 + c;
        float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
        if (4 * q < hc && col < V)
          t = __ldg(reinterpret_cast<const float4*>(table + (size_t)col * H + h0 + 4 * q));
        sT[(4 * q + 0) * VT + c] = t.x;
        sT[(4 * q + 1) * VT + c] = t.y;
        sT[(4 * q + 2) * VT + c] = t.z;
        sT[(4 * q + 3) * VT + c] = t.w;
      }
      if constexpr (WIDE) {
        for (int i = tid; i < BT * hc; i += THREADS) {
          const int r = i / hc, h = i - r * hc, row = row0 + r;
          sS[h * BT + r] = row < B ? states[(size_t)row * H + h0 + h] : 0.f;
        }
      }
      __syncthreads();
#pragma unroll 4
      for (int h = 0; h < hc; ++h) {
        const float4 a = *reinterpret_cast<const float4*>(sS + ((WIDE ? 0 : h0) + h) * BT + ty * 4);
        const float4 b0 = *reinterpret_cast<const float4*>(sT + h * VT + tx * 4);
        const float4 b1 = *reinterpret_cast<const float4*>(sT + h * VT + 64 + tx * 4);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
      }
    }

    // mask the tile, stage it, and flag rows with a score that can enter
#pragma unroll
    for (int r4 = 0; r4 < 4; ++r4) {
      const int r = ty * 4 + r4;
      const float kv = lv[r * k + k - 1];
      const int ki = li[r * k + k - 1];
      bool any = false;
#pragma unroll
      for (int c8 = 0; c8 < 8; ++c8) {
        const int c = (c8 < 4) ? tx * 4 + c8 : 64 + tx * 4 + (c8 - 4);
        const int col = j0 + c;
        float v = acc[r4][c8];
        if (col >= n_valid) {
          v = -INFINITY;
        } else if ((sM[r * (VT / 32) + (c >> 5)] >> (c & 31)) & 1u) {
          v = seen_value;
        }
        sC[r * (VT + 1) + c] = v;
        any |= (v > -INFINITY) && ahead(v, col, kv, ki);
      }
      if (any && row0 + r < B) flag[r] = 1;
    }
    __syncthreads();

    for (int r = warp; r < BT; r += THREADS / 32) {
      if (!flag[r]) continue;  // warp-uniform
      for (int c0 = 0; c0 < VT; c0 += 32)
        warp_offer(lv + r * k, li + r * k, k, sC[r * (VT + 1) + c0 + lane], j0 + c0 + lane, lane);
      __syncwarp();
      if (lane == 0) flag[r] = 0;
    }
  }
  __syncthreads();

  for (int i = tid; i < BT * k; i += THREADS) {
    const int r = i / k, j = i % k, row = row0 + r;
    if (row < B) {
      const size_t o = ((size_t)split * B + row) * k + j;
      part_v[o] = lv[i];
      part_i[o] = li[i];
    }
  }
}

// Issue the 4-byte cp.async copies of bitmask words [w0, w0 + WORDS) of
// rows row0 .. row0 + ROWS - 1 into dst ([ROWS][WORDS]), the block's 256
// threads sharing them; rows >= B and words >= W are zero-filled. (W can be
// odd, so 8-byte copies would be misaligned.)
template <int ROWS, int WORDS>
__device__ __forceinline__ void load_mask_async(uint32_t* dst, const int32_t* __restrict__ mask,
                                                int row0, int B, int W, int w0) {
  static_assert(onchip::THREADS == THREADS, "the kernels that call it run 256 threads");
  for (int i = threadIdx.x; i < ROWS * WORDS; i += THREADS) {
    const int r = i / WORDS, w = w0 + i % WORDS;
    const bool ok = row0 + r < B && w < W;
    const int32_t* src = mask + (ok ? (size_t)(row0 + r) * W + w : 0);
    const unsigned dst_s = (unsigned)__cvta_generic_to_shared(dst + i);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst_s), "l"(src),
                 "r"(ok ? 4 : 0)
                 : "memory");
  }
}

// An order-preserving key of a float: key(a) < key(b) iff a < b, and 0 is
// below every score's key (it stands for "no score yet").
__device__ __forceinline__ unsigned order_key(float f) {
  const unsigned b = __float_as_uint(f);
  return (b & 0x80000000u) ? ~b : b | 0x80000000u;
}
__device__ __forceinline__ float from_order_key(unsigned u) {
  if (u < 0x00800000u) return -INFINITY;  // "no score yet" (and -inf itself)
  return __uint_as_float((u & 0x80000000u) ? u & 0x7fffffffu : ~u);
}

// The masked scores of the tile at column j0 for this thread's 8 x 8
// block: seen -> seen_value, columns >= n_valid -> -inf. words(i) gives
// row ty + 32i's two bitmask words of the tile.
template <class Words>
__device__ __forceinline__ void mask_scores(float acc[8][8], Words words, int j0, int n_valid,
                                            float seen_value, int tx) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint2 w = words(i);
    if (w.x | w.y) {  // a row's two words hold a seen bit in few tiles
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (((j < 4 ? w.x : w.y) >> (tx + 8 * (j & 3))) & 1u) acc[i][j] = seen_value;
    }
  }
  if (j0 + OC_VT > n_valid) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (j0 + tx + 8 * j >= n_valid)
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[i][j] = -INFINITY;
  }
}

// The on-chip route's sample pass: a lower bound on every row's final k-th
// score, so that the sweep skips what cannot enter the top k. Block b
// scores the catalog's tiles [SAMPLE_TILES * b, SAMPLE_TILES * (b + 1)),
// below sample_tiles, as the sweep does, and folds them into BUCKETS
// buckets a row (bucket c % 64 of column c): bucket_max[row][c % 64] = the
// largest masked score of its columns, by atomicMax on order keys (the
// caller zeroes the buckets). The buckets hold distinct columns, so the
// k-th largest bucket maximum is at most the row's k-th score: a score
// below it has k scores ahead of it. With seen_value = -inf a bucket may
// hold only -inf; the bound is then -inf and the sweep's bar -FLT_MAX.
constexpr int SAMPLE_TILES = 4;
constexpr int BUCKETS = OC_VT;
__global__ void __launch_bounds__(onchip::THREADS, 1)
rank_sample_kernel(const float* __restrict__ states, const float* __restrict__ table,
                   const int32_t* __restrict__ mask, int B, int V, int H, int W, int n_valid,
                   float seen_value, int sample_tiles, unsigned* __restrict__ bucket_max) {
  extern __shared__ __align__(16) float smem[];
  float* sS = smem;                       // [ROWS][LD] states
  float* sT = sS + onchip::STATE_FLOATS;  // [2][VT][LD] table ring
  const int tid = threadIdx.x, tx = tid & 7, ty = tid >> 3;
  const int t_begin = blockIdx.x * SAMPLE_TILES;
  const int t_end = min(sample_tiles, t_begin + SAMPLE_TILES);
  onchip::stage_states(sS, sT, states, B, H);
  onchip::load_tile_async(sT, table, t_begin * OC_VT, V, H);
  onchip::cp_async_commit();
  float mx[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) mx[i][j] = -INFINITY;
  for (int t = t_begin; t < t_end; ++t) {
    const int j0 = t * OC_VT, slot = (t - t_begin) & 1;
    uint2 w[8];  // issued before the products, used after them
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = ty + 32 * i, w0 = j0 / 32;
      w[i].x = row < B && w0 < W ? __ldg(mask + (size_t)row * W + w0) : 0;
      w[i].y = row < B && w0 + 1 < W ? __ldg(mask + (size_t)row * W + w0 + 1) : 0;
    }
    onchip::cp_async_wait_all();
    __syncthreads();
    if (t + 1 < t_end)
      onchip::load_tile_async(sT + (slot ^ 1) * onchip::VT * onchip::LD, table, j0 + OC_VT, V, H);
    onchip::cp_async_commit();
    float acc[8][8];
    onchip::tile_logits(sS, sT + slot * onchip::VT * onchip::LD, acc, tx, ty);
    mask_scores(acc, [&](int i) { return w[i]; }, j0, n_valid, seen_value, tx);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) mx[i][j] = fmaxf(mx[i][j], acc[i][j]);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = ty + 32 * i;
    if (row < B)
#pragma unroll
      for (int j = 0; j < 8; ++j) atomicMax(bucket_max + row * BUCKETS + tx + 8 * j, order_key(mx[i][j]));
  }
}

// Merge m unsorted entries, entry q held by lane q as (b_v, b_i), into a
// row's sorted list lv/li of k slots, by counting: a list entry moves down
// by the entries ahead of it, and an entry's slot is the number of list
// entries and entries ahead of it; slots >= k drop out. Called by the whole
// warp (k, m <= 32). No step waits on another's result.
__device__ __forceinline__ void merge_into_list(float* lv, int* li, int k, float b_v, int b_i, int m,
                                                int lane) {
  const float a_v = lane < k ? lv[lane] : -INFINITY;
  const int a_i = lane < k ? li[lane] : NO_ID;
  int a_pos = lane, b_pos = 0;
  for (int q = 0; q < m; ++q) {
    const float v = __shfl_sync(FULL, b_v, q);
    const int id = __shfl_sync(FULL, b_i, q);
    a_pos += ahead(v, id, a_v, a_i);
    b_pos += ahead(v, id, b_v, b_i);
    const int listed_ahead = __popc(__ballot_sync(FULL, lane < k && ahead(a_v, a_i, v, id)));
    if (lane == q) b_pos += listed_ahead;
  }
  __syncwarp();  // every lane has read the row before any slot is written
  if (lane < k && a_pos < k) {
    lv[a_pos] = a_v;
    li[a_pos] = a_i;
  }
  if (lane < m && b_pos < k) {
    lv[b_pos] = b_v;
    li[b_pos] = b_i;
  }
  __syncwarp();
}

// Merge row r's pending entries into its list and empty them. The row's
// pending buffer is 8 slices of S slots, slice tx (pv/pi + (8r + tx) S)
// filled by the row's lane tx; count is the calling lane's own slice's
// count, and the row's lanes are 8g .. 8g + 7. Called by the whole warp.
// Returns the row's new k-th value.
__device__ __forceinline__ float flush_row(float* lv, int* li, const float* pv, const int* pi,
                                           int k, int S, int r, int g, int count, int lane) {
  int m = 0, at = -1;  // lane q takes the row's q-th entry, slice by slice
#pragma unroll
  for (int sl = 0; sl < 8; ++sl) {
    const int c = __shfl_sync(FULL, count, 8 * g + sl);
    if (at < 0 && lane < m + c) at = (8 * r + sl) * S + lane - m;
    m += c;
  }
  const float b_v = lane < m ? pv[at] : -INFINITY;
  const int b_i = lane < m ? pi[at] : NO_ID;
  merge_into_list(lv + r * k, li + r * k, k, b_v, b_i, m, lane);
  return lv[r * k + k - 1];
}

// The on-chip route's sweep (B <= 256, H <= 64, k <= OC_K). One block per
// SM walks its split in tiles of 64 columns on onchip_tile.cuh's skeleton:
// every state row staged once, the table tile and the tile's bitmask words
// through a cp.async ring of two, 8 x 8 scores a thread (rows ty + 32i,
// columns tx + 8j) from the same ascending-h FMA chain as
// rank_partial_kernel, so the scores are bit-equal to that route's. Warp
// w holds all 64 columns of its 32 rows (4w + {0..3} + 32i), and the
// top-k lists of those rows in shared memory belong to it alone, so the
// ring's barrier is the tile's only one. Per row:
//   - a score is taken when it is at least the row's bar, held in a
//     register: the largest of tau, the row's sample bound (the k-th
//     largest of rank_sample_kernel's bucket maxima), kv, the sorted
//     list's k-th value as of its last merge (-inf while it is not full),
//     and -FLT_MAX (so -inf is never taken). Every score that ranks ahead
//     of the k-th entry passes; one that does not and passes (a tie with
//     kv) is dropped by the next merge. One compare a score;
//   - each lane appends the scores it takes to its own slice of the row's
//     pending buffer (8 slices of S slots), with no word to another lane:
//     the barrier-coupled sweep pays for a taken score only the lane's
//     few stores. At B=256, V=1M, k=20 a row takes ~5 scores a split
//     (~95 without the bound: a split's scores arrive in random order);
//   - a lane whose slice would overflow makes its warp merge the row's
//     pending entries into the sorted list by counting (flush_row); the
//     bar rises, and the lane's scores are tested and appended again, a
//     merge per S of them while some are left (only where scores keep
//     rising along the catalog does that take more than one);
//   - the split's end merges what is pending.
// The list ends as the exact top-k of the split's scores whatever the
// order of the merges, since (value desc, id asc) is a strict order. Rows
// past B are computed (zero states) and take nothing.
__global__ void __launch_bounds__(onchip::THREADS, 1)
rank_onchip_kernel(const float* __restrict__ states, const float* __restrict__ table,
                   const int32_t* __restrict__ mask, int B, int V, int H, int W, int n_valid,
                   float seen_value, int k, int S, int tiles_per_split,
                   const unsigned* __restrict__ bucket_max,
                   float* __restrict__ part_v, int32_t* __restrict__ part_i,
                   unsigned long long* __restrict__ taken) {
  extern __shared__ __align__(16) float smem[];
  float* sS = smem;                                                   // [ROWS][LD] states
  float* sT = sS + onchip::STATE_FLOATS;                              // [2][VT][LD] table ring
  uint32_t* sM = reinterpret_cast<uint32_t*>(sT + onchip::RING_FLOATS);  // [2][ROWS][OC_WORDS]
  float* lv = reinterpret_cast<float*>(sM + 2 * onchip::ROWS * OC_WORDS);  // [ROWS][k] values
  int* li = reinterpret_cast<int*>(lv + onchip::ROWS * k);               // [ROWS][k] ids
  float* pv = reinterpret_cast<float*>(li + onchip::ROWS * k);           // [ROWS][8][S] pending
  int* pi = reinterpret_cast<int*>(pv + onchip::ROWS * 8 * S);           // [ROWS][8][S]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx = tid & 7, ty = tid >> 3, grp = lane >> 3;  // grp = ty & 3
  const int split = blockIdx.x;
  const int n_tiles = (V + OC_VT - 1) / OC_VT;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(t_begin + tiles_per_split, n_tiles);
  constexpr int SLOT = onchip::VT * onchip::LD, MSLOT = onchip::ROWS * OC_WORDS;

  onchip::stage_states(sS, sT, states, B, H);
  onchip::load_tile_async(sT, table, t_begin * OC_VT, V, H);
  load_mask_async<onchip::ROWS, OC_WORDS>(sM, mask, 0, B, W, t_begin * OC_WORDS);
  onchip::cp_async_commit();
  for (int e = lane; e < 32 * k; e += 32) {  // this warp's lists start empty
    const int rr = e / k, row = 4 * warp + (rr & 3) + 32 * (rr >> 2);
    lv[row * k + e - rr * k] = -INFINITY;
    li[row * k + e - rr * k] = NO_ID;
  }
  // tau[i]: the k-th largest of row ty + 32i's bucket maxima (the row's 8
  // lanes hold 8 each, buckets tx + 8j, and rank them by (value, bucket));
  // bar[i] = max(kv, tau, -FLT_MAX), kv the list's k-th value as of its
  // last merge: a score below it is not taken (-inf never is), one at or
  // above it that is not ahead of the k-th entry is dropped by the next merge
  float tau[8], bar[8];
  int n_pend[8];  // the entries in this lane's slice of row ty + 32i's buffer
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = ty + 32 * i;
    float bm[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      bm[j] = row < B ? from_order_key(__ldcg(bucket_max + row * BUCKETS + tx + 8 * j)) : -INFINITY;
    int rank_of[8] = {0, 0, 0, 0, 0, 0, 0, 0};
#pragma unroll 1
    for (int src = 0; src < 8; ++src)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const float ov = __shfl_sync(FULL, bm[jj], (lane & ~7) | src);
#pragma unroll
        for (int j = 0; j < 8; ++j) rank_of[j] += ahead(ov, src + 8 * jj, bm[j], tx + 8 * j);
      }
    float t = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (rank_of[j] == k - 1) t = bm[j];
#pragma unroll
    for (int off = 1; off < 8; off <<= 1) t = fmaxf(t, __shfl_xor_sync(FULL, t, off));
    tau[i] = t;
    bar[i] = row < B ? fmaxf(t, -FLT_MAX) : INFINITY;  // rows past B take nothing
    n_pend[i] = 0;
  }
  unsigned long long n_taken = 0;  // this lane's
  for (int t = t_begin; t < t_end; ++t) {
    const int j0 = t * OC_VT, slot = (t - t_begin) & 1;
    onchip::cp_async_wait_all();  // this thread's copies of tile t have landed
    __syncthreads();              // everyone's have; every reader of the other slot is done
    if (t + 1 < t_end) {
      onchip::load_tile_async(sT + (slot ^ 1) * SLOT, table, j0 + OC_VT, V, H);
      load_mask_async<onchip::ROWS, OC_WORDS>(sM + (slot ^ 1) * MSLOT, mask, 0, B, W,
                                              (j0 + OC_VT) / 32);
    }
    onchip::cp_async_commit();
    float acc[8][8];
    onchip::tile_logits(sS, sT + slot * SLOT, acc, tx, ty);
    const uint32_t* sMt = sM + slot * MSLOT;
    mask_scores(acc, [&](int i) {
      return *reinterpret_cast<const uint2*>(sMt + (ty + 32 * i) * OC_WORDS);
    }, j0, n_valid, seen_value, tx);
    // take: each lane into its own slice; `over` marks the i it cannot fit
    unsigned over = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      unsigned cand = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) cand |= (acc[i][j] >= bar[i] ? 1u : 0u) << j;
      if (cand == 0) continue;  // the usual case
      const int c = __popc(cand);
      if (n_pend[i] + c > S) {
        over |= 1u << i;
        continue;
      }
      int at = ((ty + 32 * i) * 8 + tx) * S + n_pend[i];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if ((cand >> j) & 1u) {
          pv[at] = acc[i][j];
          pi[at] = j0 + tx + 8 * j;
          ++at;
        }
      n_pend[i] += c;
      n_taken += c;
    }
    if (!__any_sync(FULL, over != 0)) continue;
    // rare: the rows with a lane that could not fit, one at a time. Merge
    // the row's pending entries, test that lane's scores again (the list
    // may now hold this tile's ids: compare in full), and append up to S
    // of them; repeat while some are left (a lane holds at most 8)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const unsigned lanes = __ballot_sync(FULL, (over >> i) & 1u);
#pragma unroll 1
      for (int g = 0; g < 4; ++g) {
        if (!((lanes >> (8 * g)) & 0xffu)) continue;  // the same in every lane
        const int r = 4 * warp + g + 32 * i;
        unsigned rest = 0;  // the overflowing lane's scores still to place
        if (grp == g && ((over >> i) & 1u))
#pragma unroll
          for (int j = 0; j < 8; ++j) rest |= (acc[i][j] >= bar[i] ? 1u : 0u) << j;
        while (__any_sync(FULL, rest != 0)) {
          const float nk = flush_row(lv, li, pv, pi, k, S, r, g, n_pend[i], lane);
          const int nki = li[r * k + k - 1];
          if (grp == g) {
            bar[i] = fmaxf(fmaxf(nk, tau[i]), -FLT_MAX);
            n_pend[i] = 0;
#pragma unroll
            for (int j = 0; j < 8; ++j)
              if (!(acc[i][j] >= bar[i] && ahead(acc[i][j], j0 + tx + 8 * j, nk, nki)))
                rest &= ~(1u << j);
            const int at = (r * 8 + tx) * S;
#pragma unroll
            for (int j = 0; j < 8; ++j)
              if (((rest >> j) & 1u) && n_pend[i] < S) {
                pv[at + n_pend[i]] = acc[i][j];
                pi[at + n_pend[i]] = j0 + tx + 8 * j;
                ++n_pend[i];
                rest &= ~(1u << j);
              }
            n_taken += n_pend[i];
          }
        }
      }
    }
  }
  // merge what is pending into the lists, then write them
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const unsigned lanes = __ballot_sync(FULL, n_pend[i] > 0);
#pragma unroll 1
    for (int g = 0; g < 4; ++g)
      if ((lanes >> (8 * g)) & 0xffu)
        flush_row(lv, li, pv, pi, k, S, 4 * warp + g + 32 * i, g, n_pend[i], lane);
  }
  __syncwarp();
  for (int e = lane; e < 32 * k; e += 32) {
    const int rr = e / k, row = 4 * warp + (rr & 3) + 32 * (rr >> 2), j = e - rr * k;
    if (row < B) {
      const size_t o = ((size_t)split * B + row) * k + j;
      part_v[o] = lv[row * k + j];
      part_i[o] = li[row * k + j];
    }
  }
  if (taken != nullptr) atomicAdd(taken, n_taken);
}

// ---- the tensor-core route: rank_wide_tf32_kernel ------------------------------
//
// Pass 1 at H > TW_MIN_H and k <= TW_K (the hidden-512 eval path's B=256,
// H=512, k=20), the counterpart of pallas_rank.py:165 _rank_kernel at f32,
// whose scores are an f32 dot_general (pallas_rank.py:193-196). The scores
// are streaming_ce.cu's ce_fwd_wide_tf32_kernel's product S . T^T (row 2w):
// the same operands, the same shape, both K-major as stored. So it takes
// that kernel's grid, product and ring (tensor_core.cuh's wide geometry),
// and puts a top-k epilogue where that kernel folds (max, sum).
//
// Bound at B=256, V=1M, H=512: 3 x 2BVH = 786.43 GFLOP, three TF32 passes at
// the dense TF32 rate (495 TFLOP/s), 1.589 ms; the fp32 table read once,
// 2.05 GB, 0.612 ms at 3.35 TB/s. (The same work in fp32 FMAs is 3.913 ms;
// rank_partial_kernel, which took this shape before, reads the table once
// per 64-row batch tile, 8.2 GB, and runs ~13.56 ms.)
//
// What the design does about it:
//   - the table is read once per group of up to TW_ROWS = 256 batch rows:
//     one block of 256 threads per SM walks its split in tiles of
//     TW_COLS = 128 catalog columns against the whole group (a loop over
//     groups for B > 256), 8 warps as 4 x 2 warp tiles of 64 x 64;
//   - the scores on the tensor cores in 3xTF32 (tensor_core.cuh: each fp32
//     operand as a TF32 hi and lo, three mma.sync m16n8k8 a product), which
//     keeps fp32 accuracy; 1xTF32 keeps about three digits, and FLOAT_TOL
//     (1e-4 on scores up to ~50) would not hold. Per k8 block and m16
//     fragment the three passes' sums start from 0 and are added to the
//     running scores with one fp32 rounding (ce_bwd_wide_tf32_kernel's head);
//   - the state and table rows come as they are, by cp.async two steps
//     ahead through a ring of TW_STAGES = 3 slots of 16 hidden columns, one
//     barrier a step; each fragment is one ldmatrix split into hi and lo in
//     registers (tensor_core.cuh: split_tf32). The tile's bitmask words (4 a
//     row) come with its first step's copies, 4 bytes each (load_mask_async:
//     a row of W = 31,250 words at V = 1M is 8-byte aligned, not 16), into
//     one of two mask slots;
//   - the epilogue, after a tile's last step (offer_tile, then
//     merge_pending): each thread holds 8 rows x 16 columns of scores in
//     mma.sync's accumulator layout (a row's 128 columns spread over the 4
//     lanes of a quad in two warps). Seen items take seen_value, columns
//     >= n_valid -inf, and a score is offered when it ranks ahead of its
//     row's bar, the row's k-th (value, id) as of the last merge (-inf
//     never is). A row whose 16 raw scores in a thread all lie below the
//     bar, with no seen column that seen_value would lift to it, offers
//     nothing from that thread (the usual case past a split's first
//     tiles: one max and one compare). An offered score is written at
//     once, unsorted, to the row's next pending entry, which a per-row
//     shared count hands out (atomicAdd): the first TW_PEND = 16 in shared
//     memory, the rest in the split's overflow area in device memory (a
//     row offers at most 128 a tile; only a split's first tiles offer more
//     than 16). After one barrier (__syncthreads_or, skipped past when no
//     thread offered), each thread merges one row's entries into its
//     sorted list: the slot by binary search, the entries below it moved
//     down a slot. On random data a row's t-th tile of a split offers ~k/t
//     scores;
//   - the lists and pending entries live in shared memory for the group
//     (row strides of 33 and 17, odd, so that a warp's 32 rows fall on
//     distinct banks); nothing is held in registers across the MMA loop
//     or across a barrier. Row 2w's loop alone runs at 255 registers: a
//     longer epilogue (offers kept for rounds of merges when the shared
//     slots filled, one warp merging a row at a time) made the compiler
//     spill inside the MMA loop, and moving it into a call cost as much
//     in local-memory traffic, since the 204 KB of shared memory leave
//     L1 little room (PERF.md §6);
//   - a warp whose m16 fragments hold no row < B skips their MMAs, and one
//     whose fragments are not all full runs the loop with a branch per
//     fragment, so a small batch (the exported scorer serves b = 1-256)
//     does not pay for 256 rows of products; the barriers are still
//     reached by every warp.
// The keys (value, id) are distinct under a strict order, so the order of
// the offers and merges does not change a list: two calls give the same
// bits. The lists of rows < B are written as the split's partial
// ([n_splits, B, k]) at the group's end; slots never filled stay (-inf,
// NO_ID) and rank_merge_kernel gives them (-inf, 0).
// Why the MMA loop is written here again rather than shared with
// ce_fwd_wide_tf32_kernel: this loop skips the m16 fragments past B, and
// that kernel's loop is the text tools/ablate_ce_tc.py cuts for its fwd32
// readings (PERF.md §6); the pieces (ldmatrix, split_tf32, mma_3xtf32,
// copy_chunk_async) and the geometry are tensor_core.cuh's.
// Shared memory: the ring 92,160 B, the mask slots 8,192, the counts
// 1,024, the pending slots 34,816, the lists at 32 slots a row 67,584:
// 203,776 B at any k <= 32. At k > 32 the lists alone would need 256 KB at
// k = 128: those widths keep rank_partial_kernel. 255 registers, 12 bytes
// of spills.
// On one "NVIDIA H100 80GB HBM3, 700.00 W" at V=1M, H=512, k=20
// (chip_smoke.py, tools/time_kernels.py, tools/ablate_rank_tc.py; PERF.md
// row 1w): ~5.9 ms at B=256, 27% of its bound and 0.65x its library call
// (rank_partial_kernel ~13.4 in turns); without the epilogue ~4.9, the MMA
// loop's time in ce_fwd_wide_tf32_kernel too, so the epilogue costs ~1 ms
// with the tensor cores idle. At B=16 ~2.8 ms against rank_partial_kernel's
// ~3.4 in turns: the route keeps every B.
constexpr int TW_ROWS = tc::WIDE_ROWS;       // batch rows a group
constexpr int TW_COLS = tc::WIDE_COLS;       // catalog columns a tile
constexpr int TW_WORDS = TW_COLS / 32;       // bitmask words of a row a tile
constexpr int TW_HC = tc::WIDE_HC;           // hidden columns a step
constexpr int TW_LD = tc::WIDE_LD;           // a row's stride in a slot (floats)
constexpr int TW_STAGES = tc::WIDE_STAGES;   // slots in the ring
constexpr int TW_SPLANE = TW_ROWS * TW_LD;   // a slot's states
constexpr int TW_SLOT = TW_SPLANE + TW_COLS * TW_LD;  // states, then table rows
constexpr int TW_MSLOT = TW_ROWS * TW_WORDS;  // a mask slot
constexpr int TW_PEND = 16;                  // pending slots a row
constexpr int TW_PLD = TW_PEND + 1;          // their row stride (odd: a warp's rows on distinct banks)
constexpr int TW_K = 32;                     // the route: k <= TW_K ...
constexpr int TW_MIN_H = 256;                // ... and H > TW_MIN_H (the CE kernels' wide boundary)
constexpr int TW_LLD = TW_K + 1;             // a list's row stride (odd, as TW_PLD)
// Shared memory, every region at a fixed offset (the lists at TW_K slots a
// row whatever k, so that no region's address depends on k): the ring, the
// mask slots, the pending counts, the pending slots, the lists
constexpr int TW_MASK_AT = TW_STAGES * TW_SLOT;              // (in 4-byte words)
constexpr int TW_CNT_AT = TW_MASK_AT + 2 * TW_MSLOT;
constexpr int TW_PV_AT = TW_CNT_AT + TW_ROWS;
constexpr int TW_PI_AT = TW_PV_AT + TW_ROWS * TW_PLD;
constexpr int TW_LV_AT = TW_PI_AT + TW_ROWS * TW_PLD;
constexpr int TW_LI_AT = TW_LV_AT + TW_ROWS * TW_LLD;
constexpr long long TW_SMEM = 4LL * (TW_LI_AT + TW_ROWS * TW_LLD);  // 203,776 B
static_assert(THREADS == TW_ROWS && TW_COLS == 128 && TW_HC % 8 == 0 && TW_K <= 32 &&
                  TW_PEND <= 32 && TW_SMEM <= MAX_SMEM,
              "8 warps of 64 x 64 over a 256 x 128 tile; merge_into_list takes k, m <= 32");
// The mask slot of local tile T is refilled at step (T + 2) nk - 2, after
// tile T's epilogue at step (T + 1) nk - 1 as long as a tile takes two steps
static_assert(TW_MIN_H >= 2 * TW_HC, "at least two steps a tile");

// Merge row r = threadIdx.x's pending entries into its sorted list and empty
// them: one row a thread, so that the 256 rows merge at once. Entry q of
// the row lies in its PEND shared slots (rows PEND + 1 apart) for q < PEND,
// past that in the block's overflow area (ov, oi: [TW_ROWS][TW_COLS]
// values, then ids). An entry no longer ahead of the k-th is dropped; one
// that is finds its slot by binary search and the entries below it move
// down a slot (a loop with no compare in it), while the next entry's load
// is in flight.
template <int PEND = TW_PEND>
__device__ __forceinline__ void merge_pending(float* lv, int* li, int* cnt, const float* pv,
                                              const int* pi, const float* ov, const int* oi,
                                              int k) {
  const int r = threadIdx.x, n = cnt[r];
  if (n == 0) return;
  float* L = lv + r * TW_LLD;
  int* I = li + r * TW_LLD;
  auto entry_v = [&](int q) { return q < PEND ? pv[r * (PEND + 1) + q] : ov[r * TW_COLS + q]; };
  auto entry_i = [&](int q) { return q < PEND ? pi[r * (PEND + 1) + q] : oi[r * TW_COLS + q]; };
  float nv = entry_v(0);
  int nid = entry_i(0);
  for (int q = 0; q < n; ++q) {
    const float v = nv;
    const int id = nid;
    if (q + 1 < n) {
      nv = entry_v(q + 1);
      nid = entry_i(q + 1);
    }
    if (!ahead(v, id, L[k - 1], I[k - 1])) continue;
    int lo = 0, hi = k - 1;  // the slot: the first entry that (v, id) ranks ahead of
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (ahead(L[mid], I[mid], v, id)) lo = mid + 1;
      else hi = mid;
    }
    for (int j = k - 1; j > lo; --j) {
      L[j] = L[j - 1];
      I[j] = I[j - 1];
    }
    L[lo] = v;
    I[lo] = id;
  }
  cnt[r] = 0;
}

// The top-k epilogue of a finished tile (catalog columns j0 ..): this
// thread's scores acc[i][j][2 half + e] of row 64 wm + 16 i + g + 8 half
// (mma.sync's warp tiles; MID: row 64 i + 16 wm + g + 8 half, wgmma's m64
// tiles) and tile column 64 wn + 8 j + 2 t + e (lane l, g = l >> 2, t = l &
// 3, wm = warp & 3, wn = warp >> 2), masked in place (the tile's bitmask
// words in sMt), and each that ranks ahead of its row's bar offered:
// written, unsorted, to the row's next entry (a per-row shared count hands
// them out), in its PEND shared slots (rows PEND + 1 apart) or past them
// in the block's overflow area. Rows >= rows (past B) offer nothing.
// Returns whether this thread offered a score. Nothing waits between two
// offers and nothing is kept for later: with the 128 accumulators live, a
// longer epilogue made the compiler spill inside the MMA loop.
template <int PEND = TW_PEND, bool MID = false>
__device__ __forceinline__ bool offer_tile(float (&acc)[4][8][4], const uint32_t* sMt,
                                           const float* lv, const int* li, int* cnt, float* pv,
                                           int* pi, float* ov, int* oi, int k, int j0,
                                           int n_valid, float seen_value, int rows) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp & 3, wn = warp >> 2, g = lane >> 2, t4 = lane & 3;
  const int c0 = j0 + 64 * wn + 2 * t4;  // this thread's columns: c0 + 8 j + e
  const bool ragged = c0 + 63 >= n_valid;
  bool offered = false;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int i = q >> 1, half = q & 1;
    const int r = MID ? 64 * i + 16 * wm + g + 8 * half : 64 * wm + 16 * i + g + 8 * half;
    if (r >= rows) continue;
    const float kv = lv[r * TW_LLD + k - 1];
    const int ki = li[r * TW_LLD + k - 1];
    // words 2 wn, 2 wn + 1 of the row's 4 hold this thread's columns: bit
    // 8 (j & 3) + 2 t + e of word j >> 2
    const uint2 w = *reinterpret_cast<const uint2*>(sMt + r * TW_WORDS + 2 * wn);
    // the usual case past a split's first tiles: every raw score below the
    // bar, and no seen column that seen_value would lift to it; the masks
    // can then only lower a score (to seen_value or -inf), so none is offered
    const bool seen_here = ((w.x | w.y) >> (2 * t4)) & 0x03030303u;
    float top = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      top = fmaxf(top, fmaxf(acc[i][j][2 * half], acc[i][j][2 * half + 1]));
    if (top < kv && (!seen_here || seen_value < kv)) continue;
    unsigned cand = 0;  // bit 2 j + e: that score is offered
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& v = acc[i][j][2 * half + e];
        if ((((j < 4) ? w.x : w.y) >> (8 * (j & 3) + 2 * t4 + e)) & 1u) v = seen_value;
        if (ragged && c0 + 8 * j + e >= n_valid) v = -INFINITY;
        if (v > -INFINITY && ahead(v, c0 + 8 * j + e, kv, ki)) cand |= 1u << (2 * j + e);
      }
    if (cand == 0) continue;
    offered = true;
    int at = atomicAdd(cnt + r, __popc(cand));
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if ((cand >> (2 * j + e)) & 1u) {
          if (at < PEND) {
            pv[r * (PEND + 1) + at] = acc[i][j][2 * half + e];
            pi[r * (PEND + 1) + at] = c0 + 8 * j + e;
          } else {
            ov[r * TW_COLS + at] = acc[i][j][2 * half + e];
            oi[r * TW_COLS + at] = c0 + 8 * j + e;
          }
          ++at;
        }
  }
  return offered;
}

// acc[i][j] += S[64 wm + 16 i, :] . T[64 wn + 8 j, :]^T over one slot's
// TW_HC hidden columns (states S, table rows T, rows TW_LD floats apart) in
// 3xTF32, for the m16 fragments i < n_i; ALL: all four, with no branch
// between them, so that the compiler can overlap one fragment's loads with
// the MMAs before them.
template <bool ALL>
__device__ __forceinline__ void wide_step(float (&acc)[4][8][4], const float* S, const float* T,
                                          int wm, int wn, int lane, int n_i) {
  // a fragment's hi and lo, split in registers from one ldmatrix at p
  auto frags = [](uint32_t (&h)[4], uint32_t (&l)[4], const float* p) {
    tc::ldmatrix_x4(h, p);
#pragma unroll
    for (int e = 0; e < 4; ++e) tc::split_tf32(h[e], h[e], l[e]);
  };
#pragma unroll
  for (int kk = 0; kk < TW_HC; kk += 8) {
    uint32_t bh[8][2], bl[8][2];
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
      uint32_t rh[4], rl[4];
      frags(rh, rl, T + (64 * wn + 16 * jp + tc::b_row(lane)) * TW_LD + kk + tc::b_col32(lane));
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        bh[2 * jp + (e >> 1)][e & 1] = rh[e];
        bl[2 * jp + (e >> 1)][e & 1] = rl[e];
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (!ALL && i >= n_i) break;
      uint32_t ah[1][4], al[1][4];
      frags(ah[0], al[0], S + (64 * wm + 16 * i + tc::a_row(lane)) * TW_LD + kk + tc::a_col32(lane));
      float part[1][8][4] = {};
      tc::mma_3xtf32(part, ah, al, bh, bl);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += part[0][j][e];
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1)
rank_wide_tf32_kernel(const float* __restrict__ states, const float* __restrict__ table,
                      const int32_t* __restrict__ mask, int B, int V, int H, int W, int n_valid,
                      float seen_value, int k, int tiles_per_split, float* __restrict__ overflow,
                      float* __restrict__ part_v, int32_t* __restrict__ part_i) {
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;                                                   // [TW_STAGES][TW_SLOT]
  uint32_t* sM = reinterpret_cast<uint32_t*>(smem + TW_MASK_AT);        // [2][TW_ROWS][TW_WORDS]
  int* cnt = reinterpret_cast<int*>(smem + TW_CNT_AT);                  // [TW_ROWS] pending counts
  float* pv = smem + TW_PV_AT;                                          // [TW_ROWS][TW_PLD] pending
  int* pi = reinterpret_cast<int*>(smem + TW_PI_AT);                    // [TW_ROWS][TW_PLD]
  float* lv = smem + TW_LV_AT;                                          // [TW_ROWS][TW_LLD] lists
  int* li = reinterpret_cast<int*>(smem + TW_LI_AT);                    // [TW_ROWS][TW_LLD]
  // this block's overflow area: [TW_ROWS][TW_COLS] values, then ids
  float* ov = overflow + (size_t)blockIdx.x * 2 * TW_ROWS * TW_COLS;
  int* oi = reinterpret_cast<int*>(ov + TW_ROWS * TW_COLS);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2;  // the warp tile: rows 64 wm, columns 64 wn of a tile
  const int nk = (H + TW_HC - 1) / TW_HC;
  const int n_tiles = (V + TW_COLS - 1) / TW_COLS;
  const int t_begin = blockIdx.x * tiles_per_split, t_end = min(t_begin + tiles_per_split, n_tiles);
  const int n_steps = max(t_end - t_begin, 0) * nk;

  // step s: hidden chunk s % nk of local tile s / nk, in slot s % TW_STAGES
  auto slot = [&](int s) { return ring + (s % TW_STAGES) * TW_SLOT; };

  for (int g0 = 0; g0 < B; g0 += TW_ROWS) {
    const int rows = min(TW_ROWS, B - g0);  // the group's rows
    // this warp's m16 fragments that hold a row < B (warp-uniform)
    const int n_i = min(4, max(0, (rows - 64 * wm + 15) / 16));
    auto issue = [&](int s) {  // step s's state and table rows, as they are; a tile's mask words
      float* S = slot(s);
      const int h0 = (s % nk) * TW_HC, tile = t_begin + s / nk;
      tc::copy_chunk_async<TW_ROWS, TW_HC>(S, TW_LD, states, g0, B, H, h0);
      tc::copy_chunk_async<TW_COLS, TW_HC>(S + TW_SPLANE, TW_LD, table, tile * TW_COLS, V, H, h0);
      if (s % nk == 0)
        load_mask_async<TW_ROWS, TW_WORDS>(sM + ((s / nk) & 1) * TW_MSLOT, mask, g0, B, W,
                                           tile * TW_WORDS);
    };
    float acc[4][8][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

    __syncthreads();  // the group before is done with the ring, the mask slots and the lists
    for (int e = tid; e < TW_ROWS * TW_LLD; e += THREADS) {
      lv[e] = -INFINITY;
      li[e] = NO_ID;
    }
    cnt[tid] = 0;
#pragma unroll
    for (int s = 0; s < TW_STAGES - 1; ++s) {
      if (s < n_steps) issue(s);
      onchip::cp_async_commit();
    }
    for (int s = 0; s < n_steps; ++s) {
      tc::cp_async_wait_group<TW_STAGES - 2>();  // this thread's copies of step s have landed
      __syncthreads();  // everyone's; step s - 1's MMAs and epilogue are done
      if (s + TW_STAGES - 1 < n_steps) issue(s + TW_STAGES - 1);
      onchip::cp_async_commit();  // (empty past the last step: one group a step)
      const float* S = slot(s);
      if (n_i == 4)  // (warp-uniform) the usual case: no branch inside the loop
        wide_step<true>(acc, S, S + TW_SPLANE, wm, wn, lane, 4);
      else if (n_i > 0)
        wide_step<false>(acc, S, S + TW_SPLANE, wm, wn, lane, n_i);
      if (s % nk == nk - 1) {  // the tile's scores are complete: offer them, then merge
        const bool offered =
            offer_tile(acc, sM + ((s / nk) & 1) * TW_MSLOT, lv, li, cnt, pv, pi, ov, oi, k,
                       (t_begin + s / nk) * TW_COLS, n_valid, seen_value, rows);
        // every offer is written; the merges are seen by the next tile's
        // offers after the next step's barrier
        if (__syncthreads_or(offered)) merge_pending(lv, li, cnt, pv, pi, ov, oi, k);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
      }
    }
    __syncthreads();  // every warp's last merges are done
    for (int e = tid; e < rows * k; e += THREADS) {
      const int r = e / k, j = e - r * k;
      const size_t o = ((size_t)blockIdx.x * B + g0 + r) * k + j;
      part_v[o] = lv[r * TW_LLD + j];
      part_i[o] = li[r * TW_LLD + j];
    }
  }
}

// ---- the middle route: rank_mid_tf32_kernel -------------------------------------
//
// Pass 1 at B <= RM_ROWS = 256, 64 < H <= RM_MAX_H = 256 and k <= TW_K (the
// hidden-256 eval path's B=256, H=256, k=20), the counterpart of
// pallas_rank.py:165 _rank_kernel at f32 on those widths. The scores are
// streaming_ce.cu's ce_fwd_mid_tf32_kernel's product S . T^T (row 2m): so it
// takes that kernel's grid, staging and product (wgmma_tf32_tile.cuh:
// Hopper's warpgroup MMAs, m64n64k8 TF32 in 3xTF32, a from registers, b
// from split planes in shared memory) and puts row 1w's top-k epilogue
// (offer_tile, merge_pending) where that kernel folds (max, sum).
//
// Bound at B=256, V=1M, H=256 (H=128): 3 x 2BVH = 393.2 (196.6) GFLOP of
// TF32 passes, 0.794 (0.397) ms at the dense TF32 rate (495 TFLOP/s); the
// fp32 table read once, 1.02 (0.51) GB, 0.306 (0.153) ms at 3.35 TB/s. So
// operations bound it. (rank_partial_kernel, which took these shapes
// before, runs fp32 FMAs, 1.957 ms of them at 67 TFLOP/s at H=256, and
// reads the table once per 64-row batch tile.)
//
// What the design does about it:
//   - the table is read once: one block of 256 threads (two warpgroups)
//     per SM walks its split of whole MF_COLS = 128-column tiles against
//     every batch row, the m64 tiles past B skipped by a block-uniform
//     bound (mf_logits), so a small batch (the exported scorer serves b =
//     1-256) pays for ceil(B / 64) m64 tiles of products, not four;
//   - the scores on wgmma in 3xTF32, which keeps fp32 accuracy (FLOAT_TOL);
//     wgmma's m64n64 MMAs run the middle CE forward at ~41% of its bound
//     where mma.sync's wide kernels reach ~32%;
//   - a step is MF_FKC = 32 hidden columns: the state rows by cp.async a
//     step ahead, the table rows by 16-byte loads into registers a step
//     ahead, split into the other slot's hi and lo planes after the step's
//     MMAs (before the epilogue, so that those registers are free there);
//     two slots, one barrier a step;
//   - the epilogue after a tile's last step, on wgmma's accumulators,
//     whose columns are mma.sync's (a thread holds 8 rows x 16 columns of
//     a row's 128 in two warpgroups, as row 1w's in two warps): seen items
//     take seen_value, columns >= n_valid -inf, and a score that ranks
//     ahead of its row's bar (the list's k-th) goes to the row's next
//     pending entry through a shared count, past the RM_PEND shared slots
//     into the split's overflow area in device memory; after one barrier
//     one thread a row merges (offer_tile<RM_PEND, true>, merge_pending);
//   - the tile's bitmask words (4 a row) come into one mask slot with the
//     copies of the tile's second step: the tile before read its words in
//     its epilogue, before this step's barrier, and the route's H > 64
//     gives every tile at least three steps, so they land before the
//     tile's own epilogue.
// Shared memory: the forward's two slots of 69,632 B (the states [256][36],
// the table's hi and lo planes [128][32]), the mask slot 4,096 B, the
// pending counts 1,024, the pending slots at RM_PEND = 8 a row (stride 9,
// odd: a warp's rows on distinct banks) 18,432, the lists at TW_K + 1 = 33
// slots a row 67,584: 230,400 B of the 232,448 a block may use. Row 1w's 16
// pending slots and two mask slots would need 250,880: the forward's
// exchange (2,048 B) is not needed here, one mask slot suffices, and past
// a split's first tiles a row's t-th tile offers ~k/t scores, so 8 shared
// slots spill to the overflow area only in the first few tiles.
// The keys (value, id) are distinct under a strict order, so the order of
// the offers and merges does not change a list: two calls give the same
// bits. Where every score is exact in any order (integer inputs) the
// values and ids are bit-equal to the other routes'; elsewhere the values
// lie within fp32 rounding of them. Slots never filled stay (-inf, NO_ID)
// and rank_merge_kernel gives them (-inf, 0). 255 registers, 72 bytes of
// spills (without the epilogue 252 and none).
// On one "NVIDIA H100 80GB HBM3, 700.00 W" at V=1M, k=20, B=256
// (tools/ablate_rank_tc.py --mid, tools/time_kernels.py, chip_smoke.py;
// PERF.md row 1m): ~2.85 ms at H = 256 (28% of its bound, 0.40x its library
// call; rank_partial_kernel ~7.5 in turns), ~1.98 at H = 128 (20%, 0.35x;
// ~3.27). Without the epilogue ~1.70 / ~0.91: the epilogue costs ~1.1 ms
// with the tensor cores idle, as row 1w's does, ~0.2 ms at B = 1.
// rank_wide_tf32_kernel with its H bound lifted takes ~3.50 / ~2.32 on
// these shapes (its mma.sync loop ~2.49 / ~1.30), so the route takes this
// kernel. At B = 1 / 16 and H = 256 ~1.13 / ~1.39 ms against the older
// route's ~1.78 / ~1.92; at H = 128 the older route reads faster at B = 8
// to 32 (by at most ~0.14 ms) and slower at B <= 2 and B >= 64, so the
// route keeps every B <= 256.
constexpr int RM_ROWS = MF_ROWS;            // the route: B <= RM_ROWS ...
constexpr int RM_MAX_H = 256;               // ... 64 < H <= RM_MAX_H, k <= TW_K
constexpr int RM_PEND = 8;                  // pending slots a row in shared memory
constexpr int RM_SLOT = mf_lslot(MF_FKC);   // a step's slot (floats)
constexpr int RM_MASK_AT = 2 * RM_SLOT;     // one mask slot [RM_ROWS][TW_WORDS] (4-byte words)
constexpr int RM_CNT_AT = RM_MASK_AT + RM_ROWS * TW_WORDS;
constexpr int RM_PV_AT = RM_CNT_AT + RM_ROWS;
constexpr int RM_PI_AT = RM_PV_AT + RM_ROWS * (RM_PEND + 1);
constexpr int RM_LV_AT = RM_PI_AT + RM_ROWS * (RM_PEND + 1);
constexpr int RM_LI_AT = RM_LV_AT + RM_ROWS * TW_LLD;
constexpr long long RM_SMEM = 4LL * (RM_LI_AT + RM_ROWS * TW_LLD);  // 230,400 B
static_assert(RM_SMEM <= MAX_SMEM && RM_ROWS == TW_ROWS && MF_COLS == TW_COLS && MF_COLS == VT &&
                  MF_THREADS == THREADS && (RM_PEND + 1) % 2 == 1 && RM_MAX_H % 4 == 0,
              "two warpgroups over 256 rows x 128 columns; the older route's tiles");
static_assert(onchip::MAX_H >= 2 * MF_FKC, "H > onchip::MAX_H: at least three steps a tile");

__global__ void __launch_bounds__(THREADS, 1)
rank_mid_tf32_kernel(const float* __restrict__ states, const float* __restrict__ table,
                     const int32_t* __restrict__ mask, int B, int V, int H, int W, int n_valid,
                     float seen_value, int k, int tiles_per_split, float* __restrict__ overflow,
                     float* __restrict__ part_v, int32_t* __restrict__ part_i) {
  constexpr int KC = MF_FKC, NP = MF_COLS * KC / 4 / THREADS;
  extern __shared__ __align__(128) float rm_smem[];
  uint32_t* sM = reinterpret_cast<uint32_t*>(rm_smem + RM_MASK_AT);  // [RM_ROWS][TW_WORDS]
  int* cnt = reinterpret_cast<int*>(rm_smem + RM_CNT_AT);            // [RM_ROWS] pending counts
  float* pv = rm_smem + RM_PV_AT;                                    // [RM_ROWS][RM_PEND + 1] pending
  int* pi = reinterpret_cast<int*>(rm_smem + RM_PI_AT);              // [RM_ROWS][RM_PEND + 1]
  float* lv = rm_smem + RM_LV_AT;                                    // [RM_ROWS][TW_LLD] lists
  int* li = reinterpret_cast<int*>(rm_smem + RM_LI_AT);              // [RM_ROWS][TW_LLD]
  // this block's overflow area: [TW_ROWS][TW_COLS] values, then ids
  float* ov = overflow + (size_t)blockIdx.x * 2 * TW_ROWS * TW_COLS;
  int* oi = reinterpret_cast<int*>(ov + TW_ROWS * TW_COLS);
  const int tid = threadIdx.x;
  const int nk = (H + KC - 1) / KC;
  const int n_tiles = (V + MF_COLS - 1) / MF_COLS;
  const int t_begin = blockIdx.x * tiles_per_split, t_end = min(t_begin + tiles_per_split, n_tiles);
  const int n_steps = max(t_end - t_begin, 0) * nk;
  const int mt_end = (B + 63) / 64;

  // step s: hidden chunk s % nk of local tile s / nk, in slot s & 1
  auto slot = [&](int s) { return rm_smem + (s & 1) * RM_SLOT; };
  auto th = [&](int s) { return slot(s) + RM_ROWS * (KC + 4); };
  float4 pre[NP];  // a step's table pieces, loaded a step ahead
  auto issue = [&](int s) {  // step s's state rows by cp.async, its table rows into pre
    const int tile = t_begin + s / nk;
    tc::copy_chunk_async<RM_ROWS, KC>(slot(s), KC + 4, states, 0, B, H, (s % nk) * KC);
    if (s % nk == 1)  // the tile's bitmask words, with its second step's copies
      load_mask_async<RM_ROWS, TW_WORDS>(sM, mask, 0, B, W, tile * TW_WORDS);
    mf_load_table<KC>(pre, table, tile * MF_COLS, (s % nk) * KC, V, H);
  };
  auto store_table = [&](int s) {
    mf_store_table<KC>(pre, th(s), th(s) + MF_COLS * KC);
    wg::fence_proxy_async();
  };

  float acc[4][8][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  for (int e = tid; e < RM_ROWS * TW_LLD; e += THREADS) {
    lv[e] = -INFINITY;
    li[e] = NO_ID;
  }
  cnt[tid] = 0;
  if (n_steps > 0) {
    issue(0);
    store_table(0);
  }
  onchip::cp_async_commit();
  for (int s = 0; s < n_steps; ++s) {
    onchip::cp_async_wait_all();  // this thread's copies of step s have landed
    __syncthreads();  // everyone's, and step s's table planes; step s - 1's MMAs and epilogue are done
    if (s + 1 < n_steps) issue(s + 1);
    onchip::cp_async_commit();
    mf_logits<KC>(acc, slot(s), th(s), th(s) + MF_COLS * KC, mt_end);
    if (s + 1 < n_steps) store_table(s + 1);  // its slot was last read by step s - 1
    if (s % nk == nk - 1) {  // the tile's scores are complete: offer them, then merge
      const bool offered = offer_tile<RM_PEND, true>(acc, sM, lv, li, cnt, pv, pi, ov, oi, k,
                                                     (t_begin + s / nk) * MF_COLS, n_valid,
                                                     seen_value, B);
      // every offer is written; the merges are seen by the next tile's
      // offers after the next step's barrier
      if (__syncthreads_or(offered)) merge_pending<RM_PEND>(lv, li, cnt, pv, pi, ov, oi, k);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    }
  }
  __syncthreads();  // every thread's last merges are done
  for (int e = tid; e < B * k; e += THREADS) {
    const int r = e / k, j = e - r * k;
    const size_t o = ((size_t)blockIdx.x * B + r) * k + j;
    part_v[o] = lv[r * TW_LLD + j];
    part_i[o] = li[r * TW_LLD + j];
  }
}

__global__ void __launch_bounds__(32 * MERGE_WARPS)
rank_merge_kernel(const float* __restrict__ part_v, const int32_t* __restrict__ part_i,
                  int B, int k, int n_splits, float* __restrict__ out_v,
                  int32_t* __restrict__ out_i) {
  extern __shared__ __align__(16) float msmem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row = blockIdx.x * MERGE_WARPS + warp;
  float* lv = msmem + warp * k;
  int* li = reinterpret_cast<int*>(msmem + MERGE_WARPS * k) + warp * k;
  if (row >= B) return;  // whole warp leaves; warps share nothing
  if (k <= 32) {  // the list in registers, slot j in lane j: no shared memory
    float sv = -INFINITY, kv = -INFINITY;
    int si = NO_ID, ki = NO_ID;
    for (int s0 = 0; s0 < n_splits; s0 += MERGE_BATCH) {  // a batch of splits' loads at once
      float bv[MERGE_BATCH];
      int bi[MERGE_BATCH];
#pragma unroll
      for (int b = 0; b < MERGE_BATCH; ++b) {
        const bool ok = s0 + b < n_splits && lane < k;
        const size_t o = ((size_t)(s0 + b) * B + row) * k + lane;
        bv[b] = ok ? part_v[o] : -INFINITY;
        bi[b] = ok ? part_i[o] : NO_ID;
      }
#pragma unroll
      for (int b = 0; b < MERGE_BATCH; ++b)
        for (unsigned m = __ballot_sync(FULL, bv[b] > -INFINITY && ahead(bv[b], bi[b], kv, ki));
             m != 0; m &= m - 1) {  // lowest lane first, as warp_offer
          const int src = __ffs(m) - 1;
          const float cv = __shfl_sync(FULL, bv[b], src);
          const int cid = __shfl_sync(FULL, bi[b], src);
          if (!ahead(cv, cid, kv, ki)) continue;  // an earlier insertion raised the k-th
          const int pos = __popc(__ballot_sync(FULL, lane < k && ahead(sv, si, cv, cid)));
          const float uv = __shfl_up_sync(FULL, sv, 1);
          const int ui = __shfl_up_sync(FULL, si, 1);
          if (lane == pos) {
            sv = cv;
            si = cid;
          } else if (lane > pos) {
            sv = uv;
            si = ui;
          }
          kv = __shfl_sync(FULL, sv, k - 1);
          ki = __shfl_sync(FULL, si, k - 1);
        }
    }
    if (lane < k) {
      out_v[(size_t)row * k + lane] = sv;
      out_i[(size_t)row * k + lane] = (sv == -INFINITY) ? 0 : si;
    }
    return;
  }
  for (int j = lane; j < k; j += 32) {
    lv[j] = -INFINITY;
    li[j] = NO_ID;
  }
  __syncwarp();
  for (int s = 0; s < n_splits; ++s) {
    const size_t base = ((size_t)s * B + row) * k;
    for (int j0 = 0; j0 < k; j0 += 32) {
      const int j = j0 + lane;
      const float v = j < k ? part_v[base + j] : -INFINITY;
      const int id = j < k ? part_i[base + j] : NO_ID;
      warp_offer(lv, li, k, v, id, lane);
    }
  }
  for (int j = lane; j < k; j += 32) {
    const float v = lv[j];
    out_v[(size_t)row * k + j] = v;
    out_i[(size_t)row * k + j] = (v == -INFINITY) ? 0 : li[j];
  }
}

// The on-chip route's domain, by shape.
bool onchip_route(int B, int H, int k) { return B <= onchip::ROWS && H <= onchip::MAX_H && k <= OC_K; }

// The tensor-core route's domain (rank_wide_tf32_kernel), by shape.
bool tc_route(int B, int H, int k) { return H > TW_MIN_H && k <= TW_K; }

// The middle route's domain (rank_mid_tf32_kernel), by shape.
bool mid_route(int B, int H, int k) {
  return B <= RM_ROWS && H > onchip::MAX_H && H <= RM_MAX_H && k <= TW_K;
}

// Shared memory of rank_partial_kernel<wide>.
long long partial_smem(int H, int k, bool wide) {
  return (long long)sizeof(float) * ((long long)(wide ? KC : H) * BT + KC * VT + BT * (VT + 1) + BT * k) +
         (long long)sizeof(int) * BT * k + (long long)sizeof(uint32_t) * BT * (VT / 32) +
         (long long)sizeof(int) * BT;
}

// The older route stages its states in hidden chunks (WIDE) where all of
// them do not fit: past H ~ 670 at k = 20, H ~ 454 at k = 128.
bool wide_route(int H, int k) { return partial_smem(H, k, false) > MAX_SMEM; }

// Shared memory of the on-chip sweep's staging: states, the table ring and
// the bitmask ring.
constexpr long long ONCHIP_STAGING =
    (long long)sizeof(float) * (onchip::STATE_FLOATS + onchip::RING_FLOATS) +
    (long long)sizeof(uint32_t) * 2 * onchip::ROWS * OC_WORDS;

// The slots of a lane's slice of a row's pending buffer on the on-chip
// route: up to 4, as many as fit beside the row's k list slots (a slot is
// a value and an id; a row has 8 slices).
int onchip_slice(int k) {
  const long long fit = ((MAX_SMEM - ONCHIP_STAGING) / (8LL * onchip::ROWS) - k) / 8;
  return (int)(fit < 4 ? fit : 4);
}

}  // namespace

extern "C" {

// 1 where streaming_rank takes the on-chip route at batch B, hidden size
// H and top-k width k (unless its caller turns the route off).
int streaming_rank_onchip(int B, int H, int k) { return onchip_route(B, H, k) ? 1 : 0; }

// 1 where streaming_rank takes the tensor-core route at batch B, hidden
// size H and top-k width k (unless its caller turns the route off).
int streaming_rank_tc(int B, int H, int k) { return tc_route(B, H, k) ? 1 : 0; }

// 1 where streaming_rank takes the middle route at batch B, hidden size H
// and top-k width k (unless its caller turns the route off).
int streaming_rank_mid(int B, int H, int k) { return mid_route(B, H, k) ? 1 : 0; }

// 1 where the older route stages the states in hidden chunks (its wide
// form) at hidden size H and top-k width k.
int streaming_rank_wide(int H, int k) { return wide_route(H, k) ? 1 : 0; }

// Bytes of the tensor-core and middle routes' overflow area at n_splits
// splits: a block's offers of a tile past a row's shared slots (256 rows x
// 128 columns, values and ids).
long long streaming_rank_overflow_bytes(int n_splits) {
  return 8LL * n_splits * TW_ROWS * TW_COLS;
}

// Shared memory of pass 1 on the on-chip route (route = 1), the
// tensor-core route (route = 2), the middle route (route = 3) or the older
// one (route = 0, in the form H and k take) at hidden size H and top-k
// width k.
long long streaming_rank_smem_bytes(int H, int k, int route) {
  if (route == 1) return ONCHIP_STAGING + 8LL * onchip::ROWS * (k + 8 * onchip_slice(k));
  if (route == 2) return TW_SMEM;
  if (route == 3) return RM_SMEM;
  return partial_smem(H, k, wide_route(H, k));
}

// Launch the passes on `stream`. Pass 1 takes the on-chip route where the
// shape allows it (streaming_rank_onchip) and allow_onchip is 1: a sample
// pass (rank_sample_kernel into `buckets`, [B, 64] 32-bit words that the
// caller allocates and this entry zeroes) and then rank_onchip_kernel; the
// middle route (rank_mid_tf32_kernel) where the shape allows it
// (streaming_rank_mid) and allow_mid is 1, and the tensor-core route
// (rank_wide_tf32_kernel) where the shape allows it (streaming_rank_tc) and
// allow_tc is 1, both with `overflow`, n_splits * 256 KB that the caller
// allocates (streaming_rank_overflow_bytes). Elsewhere it is
// rank_partial_kernel, in its wide form where the shape asks for it
// (streaming_rank_wide). The on-chip and older routes give bit-equal
// results; the middle and tensor-core routes sum each score in another
// order, so their results are bit-equal to the others' where the scores are
// exact in any order (integer inputs) and within fp32 rounding elsewhere.
// The caller allocates the partials ([n_splits, B, k]) and outputs ([B,
// k]); n_splits * tiles_per_split must cover the catalog in tiles of the
// route's width (64 columns on-chip, 128 otherwise), and on the on-chip,
// middle and tensor-core routes every split must hold a tile. `taken`, when not
// null, receives the on-chip route's count of scores its lists took. A
// seen item scores seen_value (0.0 for eval, -inf for serving). Returns 0
// or a cudaError_t code.
int streaming_rank(const void* states, const void* table, const void* mask, int B, int V,
                   int H, int W, int n_valid, float seen_value, int k, int n_splits,
                   int tiles_per_split, int allow_onchip, int allow_tc, int allow_mid,
                   void* buckets, void* overflow, void* part_v, void* part_i, void* out_v,
                   void* out_i, void* taken, void* stream) {
  const bool onchip = allow_onchip && onchip_route(B, H, k);
  const bool mid = !onchip && allow_mid && mid_route(B, H, k);
  const bool tc = !onchip && !mid && allow_tc && tc_route(B, H, k);
  const int width = onchip ? OC_VT : VT;
  const long long n_tiles = (V + width - 1) / width;
  if (B < 1 || V < 1 || H < 4 || H % 4 != 0 || k < 1 || k > MAX_K || n_splits < 1 ||
      tiles_per_split < 1 || (long long)n_splits * tiles_per_split < n_tiles ||
      ((onchip || mid || tc) && (long long)(n_splits - 1) * tiles_per_split >= n_tiles) ||
      (onchip && buckets == nullptr) || ((mid || tc) && overflow == nullptr) ||
      W < (V + 31) / 32 || n_valid < 0 || n_valid > V)
    return (int)cudaErrorInvalidValue;
  const long long smem = streaming_rank_smem_bytes(H, k, onchip ? 1 : tc ? 2 : mid ? 3 : 0);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (onchip) {
    // the sample: SAMPLE_TILES tiles for each split, from the catalog's start
    const int sample_tiles = (int)min(n_tiles, (long long)SAMPLE_TILES * n_splits);
    const int sample_smem = (int)(sizeof(float) * (onchip::STATE_FLOATS + onchip::RING_FLOATS));
    e = cudaMemsetAsync(buckets, 0, sizeof(unsigned) * BUCKETS * B, s);
    if (e != cudaSuccess) return (int)e;
    e = cudaFuncSetAttribute(rank_sample_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             sample_smem);
    if (e != cudaSuccess) return (int)e;
    rank_sample_kernel<<<(sample_tiles + SAMPLE_TILES - 1) / SAMPLE_TILES, onchip::THREADS,
                         (size_t)sample_smem, s>>>(
        static_cast<const float*>(states), static_cast<const float*>(table),
        static_cast<const int32_t*>(mask), B, V, H, W, n_valid, seen_value, sample_tiles,
        static_cast<unsigned*>(buckets));
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    e = cudaFuncSetAttribute(rank_onchip_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    rank_onchip_kernel<<<n_splits, onchip::THREADS, (size_t)smem, s>>>(
        static_cast<const float*>(states), static_cast<const float*>(table),
        static_cast<const int32_t*>(mask), B, V, H, W, n_valid, seen_value, k, onchip_slice(k),
        tiles_per_split, static_cast<const unsigned*>(buckets), static_cast<float*>(part_v),
        static_cast<int32_t*>(part_i), static_cast<unsigned long long*>(taken));
  } else if (mid) {
    e = cudaFuncSetAttribute(rank_mid_tf32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    rank_mid_tf32_kernel<<<n_splits, THREADS, (size_t)smem, s>>>(
        static_cast<const float*>(states), static_cast<const float*>(table),
        static_cast<const int32_t*>(mask), B, V, H, W, n_valid, seen_value, k, tiles_per_split,
        static_cast<float*>(overflow), static_cast<float*>(part_v), static_cast<int32_t*>(part_i));
  } else if (tc) {
    e = cudaFuncSetAttribute(rank_wide_tf32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    rank_wide_tf32_kernel<<<n_splits, THREADS, (size_t)smem, s>>>(
        static_cast<const float*>(states), static_cast<const float*>(table),
        static_cast<const int32_t*>(mask), B, V, H, W, n_valid, seen_value, k, tiles_per_split,
        static_cast<float*>(overflow), static_cast<float*>(part_v), static_cast<int32_t*>(part_i));
  } else {
    auto sweep = wide_route(H, k) ? rank_partial_kernel<true> : rank_partial_kernel<false>;
    e = cudaFuncSetAttribute(sweep, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid(n_splits, (B + BT - 1) / BT);
    sweep<<<grid, THREADS, (size_t)smem, s>>>(
        static_cast<const float*>(states), static_cast<const float*>(table),
        static_cast<const int32_t*>(mask), B, V, H, W, n_valid, seen_value, k, tiles_per_split,
        static_cast<float*>(part_v), static_cast<int32_t*>(part_i));
  }
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t msm = (size_t)MERGE_WARPS * k * (sizeof(float) + sizeof(int));
  rank_merge_kernel<<<(B + MERGE_WARPS - 1) / MERGE_WARPS, 32 * MERGE_WARPS, msm, s>>>(
      static_cast<const float*>(part_v), static_cast<const int32_t*>(part_i), B, k, n_splits,
      static_cast<float*>(out_v), static_cast<int32_t*>(out_i));
  return (int)cudaGetLastError();
}

const char* streaming_rank_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
