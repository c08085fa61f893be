// Streaming full-catalog masked top-k for Hopper (sm_90a), fp32.
//
// Replaces bsarec_tpu/ops/pallas_rank.py:_rank_kernel (the Pallas TPU
// kernel behind streaming_masked_topk). Per user row it returns the top k
// of the catalog scores s . T^T without writing the [B, V] score matrix:
//   - seen items (bit v & 31 of word v >> 5 of the row's bitmask; the
//     builders always set item 0) score 0.0, not -inf;
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
//   pass 1 (rank_partial_kernel): the grid is (vocab splits x batch tiles
//     of 64 rows), sized by the caller to fill the SMs. Each block keeps
//     its 64 state rows in shared memory, walks its split in tiles of 128
//     columns (the table tile staged in shared memory in 32-wide hidden
//     chunks), computes the 64 x 128 fp32 dot products with FMAs (4 x 8
//     per thread), applies the seen bit and the n_valid bound, and folds
//     the tile into a per-row sorted top-k list in shared memory. Only
//     scores that beat the row's current k-th entry are offered (the
//     counted-merge idea of pallas_rank.py:209-247), and one warp inserts
//     them into the list, so after the first tiles a row costs a compare.
//   pass 2 (rank_merge_kernel): one warp per row folds the n_splits
//     partial lists into the final k with the same insertion.
// Simple first: no wgmma/TMA/cp.async pipelining yet.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BT = 64;          // batch rows per block
constexpr int VT = 128;         // catalog columns per tile
constexpr int KC = 32;          // hidden-dim chunk staged per step
constexpr int THREADS = 256;    // 16 x 16 threads, each 4 rows x 8 columns
constexpr int MERGE_WARPS = 4;  // rows per merge block
constexpr int MAX_K = 128;
constexpr int MAX_SMEM = 232448;  // usable shared memory per block on sm_90
constexpr int NO_ID = 0x7fffffff;
constexpr unsigned FULL = 0xffffffffu;

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

__global__ void __launch_bounds__(THREADS, 2)
rank_partial_kernel(const float* __restrict__ states, const float* __restrict__ table,
                    const int32_t* __restrict__ mask, int B, int V, int H, int W,
                    int n_valid, int k, int tiles_per_split,
                    float* __restrict__ part_v, int32_t* __restrict__ part_i) {
  extern __shared__ __align__(16) float smem[];
  float* sS = smem;                     // [H][BT]   states, transposed
  float* sT = sS + H * BT;              // [KC][VT]  table chunk, transposed
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

  for (int i = tid; i < BT * H; i += THREADS) {
    const int r = i / H, h = i % H, row = row0 + r;
    sS[h * BT + r] = row < B ? states[(size_t)row * H + h] : 0.f;
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
      __syncthreads();
#pragma unroll 4
      for (int h = 0; h < hc; ++h) {
        const float4 a = *reinterpret_cast<const float4*>(sS + (h0 + h) * BT + ty * 4);
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
          v = 0.f;
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

}  // namespace

extern "C" {

// Shared memory pass 1 needs at hidden size H and top-k width k.
long long streaming_rank_smem_bytes(int H, int k) {
  return (long long)sizeof(float) * ((long long)H * BT + KC * VT + BT * (VT + 1) + BT * k) +
         (long long)sizeof(int) * BT * k + (long long)sizeof(uint32_t) * BT * (VT / 32) +
         (long long)sizeof(int) * BT;
}

// Launch both passes on `stream`. The caller allocates the partials
// ([n_splits, B, k]) and outputs ([B, k]); n_splits * tiles_per_split
// must cover ceil(V / 128) tiles. Returns 0 or a cudaError_t code.
int streaming_rank(const void* states, const void* table, const void* mask, int B, int V,
                   int H, int W, int n_valid, int k, int n_splits, int tiles_per_split,
                   void* part_v, void* part_i, void* out_v, void* out_i, void* stream) {
  if (B < 1 || V < 1 || H < 4 || H % 4 != 0 || k < 1 || k > MAX_K || n_splits < 1 ||
      (long long)n_splits * tiles_per_split * VT < V || W < (V + 31) / 32)
    return (int)cudaErrorInvalidValue;
  const long long smem = streaming_rank_smem_bytes(H, k);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaFuncSetAttribute(rank_partial_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(n_splits, (B + BT - 1) / BT);
  rank_partial_kernel<<<grid, THREADS, (size_t)smem, s>>>(
      static_cast<const float*>(states), static_cast<const float*>(table),
      static_cast<const int32_t*>(mask), B, V, H, W, n_valid, k, tiles_per_split,
      static_cast<float*>(part_v), static_cast<int32_t*>(part_i));
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
