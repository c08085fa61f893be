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
// So the bound is fp32 compute, unless TF32/bf16 is admitted later.
//
// Design. The TPU kernel walks the catalog in one sequential grid and
// carries a running top-k in VMEM across steps. Hopper blocks run in no
// order, so this is two passes:
//   pass 1, per vocab split: the masked scores of a tile of the catalog,
//     folded into a sorted top-k list per row. Only scores that beat the
//     row's current k-th entry are offered (the counted-merge idea of
//     pallas_rank.py:209-247), so after the first tiles a row costs a
//     compare. Two routes, picked by shape in the C entry:
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
//       beside the table's, 124,416 B at k = 128 and any H.
//     Both compute each score as one FMA chain over h in ascending order,
//     so their scores, and with the strict order their results, are
//     bit-equal.
//   pass 2 (rank_merge_kernel): one warp per row folds the n_splits
//     partial lists into the final k, offering each list's entries in
//     split order; at k <= 32 the running list sits in the warp's
//     registers, a slot a lane.
// On one "NVIDIA H100 80GB HBM3, 700.00 W" at B=256, V=1,000,000, H=64,
// k=20 (bsarec_tpu_torch/tools/time_kernels.py, chip_smoke.py): the
// on-chip route takes ~1.05 ms (in an eval trace the sample pass ~0.04,
// the sweep ~0.99), 47% of its 0.4891 ms fp32 bound; the older route
// ~2.15 ms. At H = 512 (chip_smoke.py) the older route takes ~13.5 ms at
// k = 20 (29% of its 3.913 ms bound) and its wide form ~23 ms at k = 128.
// No wgmma or TMA.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include "onchip_tile.cuh"

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

// Issue the 4-byte cp.async copies of bitmask words [w0, w0 + OC_WORDS) of
// every row into dst ([ROWS][OC_WORDS]); rows >= B and words >= W are
// zero-filled. (W can be odd, so 8-byte copies would be misaligned.)
__device__ __forceinline__ void load_mask_async(uint32_t* dst, const int32_t* __restrict__ mask,
                                                int B, int W, int w0) {
  for (int i = threadIdx.x; i < onchip::ROWS * OC_WORDS; i += onchip::THREADS) {
    const int r = i / OC_WORDS, w = w0 + i % OC_WORDS;
    const bool ok = r < B && w < W;
    const int32_t* src = mask + (ok ? (size_t)r * W + w : 0);
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
  load_mask_async(sM, mask, B, W, t_begin * OC_WORDS);
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
      load_mask_async(sM + (slot ^ 1) * MSLOT, mask, B, W, (j0 + OC_VT) / 32);
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

// 1 where the older route stages the states in hidden chunks (its wide
// form) at hidden size H and top-k width k.
int streaming_rank_wide(int H, int k) { return wide_route(H, k) ? 1 : 0; }

// Shared memory of pass 1 on the on-chip route (onchip = 1) or the other
// (onchip = 0, in the form H and k take) at hidden size H and top-k width k.
long long streaming_rank_smem_bytes(int H, int k, int onchip) {
  if (onchip) return ONCHIP_STAGING + 8LL * onchip::ROWS * (k + 8 * onchip_slice(k));
  return partial_smem(H, k, wide_route(H, k));
}

// Launch the passes on `stream`. Pass 1 takes the on-chip route where the
// shape allows it (streaming_rank_onchip) and allow_onchip is 1: a sample
// pass (rank_sample_kernel into `buckets`, [B, 64] 32-bit words that the
// caller allocates and this entry zeroes) and then rank_onchip_kernel.
// Elsewhere it is rank_partial_kernel, in its wide form where the shape
// asks for it (streaming_rank_wide). The two routes give bit-equal
// results. The caller allocates the partials ([n_splits, B, k]) and
// outputs ([B, k]); n_splits * tiles_per_split must cover the catalog in
// tiles of the route's width (64 columns on-chip, 128 otherwise), and
// on-chip every split must hold a tile. `taken`, when not null, receives
// the on-chip route's count of scores its lists took. A seen item scores
// seen_value (0.0 for eval, -inf for serving). Returns 0 or a cudaError_t
// code.
int streaming_rank(const void* states, const void* table, const void* mask, int B, int V,
                   int H, int W, int n_valid, float seen_value, int k, int n_splits,
                   int tiles_per_split,
                   int allow_onchip, void* buckets, void* part_v, void* part_i, void* out_v,
                   void* out_i, void* taken, void* stream) {
  const bool onchip = allow_onchip && onchip_route(B, H, k);
  const int width = onchip ? OC_VT : VT;
  const long long n_tiles = (V + width - 1) / width;
  if (B < 1 || V < 1 || H < 4 || H % 4 != 0 || k < 1 || k > MAX_K || n_splits < 1 ||
      tiles_per_split < 1 || (long long)n_splits * tiles_per_split < n_tiles ||
      (onchip && ((long long)(n_splits - 1) * tiles_per_split >= n_tiles || buckets == nullptr)) ||
      W < (V + 31) / 32 || n_valid < 0 || n_valid > V)
    return (int)cudaErrorInvalidValue;
  const long long smem = streaming_rank_smem_bytes(H, k, onchip);
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
