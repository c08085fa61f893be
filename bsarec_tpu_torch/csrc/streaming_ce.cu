// Streaming full-catalog softmax cross-entropy for Hopper (sm_90a), fp32.
//
// Replaces the three Pallas TPU kernels of bsarec_tpu/ops/pallas_ce.py:
//   - _fwd_kernel    -> ce_fwd_partial_kernel + ce_fwd_merge_kernel:
//       per row, logZ = logsumexp(s . T^T) over the columns < n_valid and,
//       when answers are given, loss = logZ - <s, T[a]>;
//   - _gather_kernel -> gold_rows_kernel: the answers' table rows T[a]
//       (zeros where a is outside [0, V));
//   - _grads_kernel  -> ce_bwd_sweep_kernel + ce_ds_reduce_kernel: with
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
// None of them writes the [B, V] logit matrix.
//
// What bounds them: at B=256, V=1,000,000, H=64 the forward is 2*B*V*H ~
// 32.8 GFLOP (~0.49 ms at the H100 SXM's 67 TFLOP/s fp32 peak outside the
// tensor cores) and the backward three such products, ~98.3 GFLOP
// (~1.47 ms); the 256 MB table read (and the 256 MB dT write) take
// ~0.08 ms each at 3.35 TB/s. So both are bound by fp32 FMAs. The gather
// moves B*H floats and is bound by latency.
//
// Design. The TPU kernels walk the catalog in one sequential grid and
// carry (max, sum) or the ds accumulator in VMEM from step to step.
// Hopper blocks run in no order, so each reduction across the catalog
// takes a second pass:
//   forward, pass 1: grid (vocab splits x batch tiles of 64 rows). A block
//     keeps its 64 state rows in shared memory, walks its split in tiles
//     of 64 columns, computes the 64 x 64 logits with fp32 FMAs (4 x 4 a
//     thread), masks columns >= n_valid, and folds each tile into a
//     per-thread online (max, sum); the 16 threads of a row merge by
//     shuffles and write one partial (m, s) per (split, row).
//   forward, pass 2: one warp per row. logZ = M + log(sum_s s_s *
//     exp(m_s - M)), each lane taking every 32nd split and the lanes
//     merged by a fixed shuffle tree; then the gold logit <s, T[a]> from
//     coalesced float4 reads of the two rows, reduced the same way.
//   backward, pass 1: one block per vocab split. For each 64-column tile
//     it loops over the batch in 64-row chunks: it recomputes the logits,
//     forms p in shared memory, adds p^T @ s_chunk into the tile's dT held
//     in shared memory, and adds p @ T_tile into its split's own partial
//     ds rows in device memory (each element has one writer, so no
//     atomics). After the batch, the one-hot term dT[a_i] -= d_i * s_i is
//     applied for the answers inside the tile, in ascending i, so
//     duplicate answers accumulate in a fixed order; the tile's dT rows
//     are then written once. Every dT row belongs to one block.
//   backward, pass 2: ds = sum of the splits' partials, in split order,
//     minus dloss_i * T[a_i][h], the product and the difference each
//     rounded once (__fmul_rn, __fsub_rn: no FMA contraction), so that ds
//     equals bit for bit the sum alone minus dloss[:, None] * T[a] taken
//     by two elementwise passes.
// Every sum is taken in a fixed order: results are deterministic.
// Shared-memory rows are padded to H + 4 floats, so the float4 reads of a
// quarter warp fall on distinct banks. Simple first: no wgmma, TMA or
// cp.async pipelining yet.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BT = 64;            // batch rows per tile / chunk
constexpr int VT = 64;            // catalog columns per tile
constexpr int HB = 64;            // hidden columns per output block (backward)
constexpr int THREADS = 256;      // 16 x 16 threads
constexpr int MAX_H = 256;
constexpr int MAX_SMEM = 232448;  // usable shared memory per block on sm_90
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
// memory with row stride H + 4; rows >= R are zero.
__device__ __forceinline__ void stage_rows(float* dst, const float* __restrict__ src, int row0,
                                           int R, int H, int n) {
  const int q = H / 4;
  for (int i = threadIdx.x; i < n * q; i += THREADS) {
    const int r = i / q, c4 = i - r * q, row = row0 + r;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < R) v = __ldg(reinterpret_cast<const float4*>(src + (size_t)row * H) + c4);
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

  stage_rows(sS, states, row0, B, H, BT);
  float m[4], s[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    s[i] = 0.f;
  }
  for (int t = t_begin; t < t_end; ++t) {
    const int j0 = t * VT;
    __syncthreads();  // earlier readers of sT are done
    stage_rows(sT, table, j0, V, H, VT);
    __syncthreads();
    float acc[4][4];
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

// One warp per row: logz[row] from the splits' partials and, when answers
// is not null, loss[row] = logz[row] - <states[row], table[answers[row]]>
// (gold 0 for an answer outside [0, n_valid)).
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
      const float4 x = __ldg(s4 + c4), y = __ldg(t4 + c4);
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
    stage_rows(sT, table, j0, V, H, VT);
    for (int i = tid; i < VT * ld; i += THREADS) sG[i] = 0.f;

    for (int chunk = 0; chunk < n_chunks; ++chunk) {
      const int row0 = chunk * BT;
      __syncthreads();  // earlier readers of sS and sP are done
      stage_rows(sS, states, row0, B, H, BT);
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
          sP[r * pld + c] =
              (row_ok && j0 + c < n_valid) ? expf(acc[i][j] - sZ[r]) * sD[r] : 0.f;
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

bool bad_shape(int B, int V, int H) {
  return B < 1 || V < 1 || H < 4 || H > MAX_H || H % 4 != 0;
}

}  // namespace

extern "C" {

// Shared memory of the forward's pass 1 (which = 0) and of the backward's
// pass 1 (which = 1) at hidden size H.
long long streaming_ce_smem_bytes(int H, int which) {
  const long long ld = H + 4;
  if (which == 0) return (long long)sizeof(float) * (BT + VT) * ld;
  return (long long)sizeof(float) * (BT * ld + 2 * VT * ld + BT * (VT + 4) + 2 * BT);
}

// logZ [B] of states [B, H] against table [V, H] over columns < n_valid,
// and, when answers (int64 [B]) and loss are not null, loss [B] = logZ -
// <states[i], table[answers[i]]> with gold 0 for answers outside
// [0, n_valid). answers and loss are both given or both null. The caller
// allocates the partials part_m, part_s ([n_splits, B]); n_splits *
// tiles_per_split tiles must cover V. Returns 0 or a cudaError_t code.
int ce_logz(const void* states, const void* table, const void* answers, int B, int V, int H,
            int n_valid, int n_splits, int tiles_per_split, void* part_m, void* part_s,
            void* logz, void* loss, void* stream) {
  if (bad_shape(B, V, H) || n_valid < 0 || n_valid > V || n_splits < 1 ||
      (long long)n_splits * tiles_per_split * VT < V || (answers == nullptr) != (loss == nullptr))
    return (int)cudaErrorInvalidValue;
  const long long smem = streaming_ce_smem_bytes(H, 0);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaFuncSetAttribute(ce_fwd_partial_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  ce_fwd_partial_kernel<<<dim3(n_splits, (B + BT - 1) / BT), THREADS, (size_t)smem, s>>>(
      static_cast<const float*>(states), static_cast<const float*>(table), B, V, H, n_valid,
      tiles_per_split, static_cast<float*>(part_m), static_cast<float*>(part_s));
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  constexpr int rows_per_block = MERGE_THREADS / 32;
  ce_fwd_merge_kernel<<<(B + rows_per_block - 1) / rows_per_block, MERGE_THREADS, 0, s>>>(
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
// term). The caller allocates ds_part ([n_splits, B, H]); n_splits *
// tiles_per_split tiles must cover V, and every split must hold at least
// one tile. Returns 0 or a cudaError_t code.
int ce_grads(const void* states, const void* table, const void* answers, const void* logz,
             const void* dloss, int B, int V, int H, int n_valid, int n_splits,
             int tiles_per_split, void* ds_part, void* ds, void* dtable, void* stream) {
  const int n_tiles = (V + VT - 1) / VT;
  if (bad_shape(B, V, H) || n_valid < 0 || n_valid > V || n_splits < 1 ||
      tiles_per_split < 1 || (long long)n_splits * tiles_per_split < n_tiles ||
      (long long)(n_splits - 1) * tiles_per_split >= n_tiles)
    return (int)cudaErrorInvalidValue;
  const long long smem = streaming_ce_smem_bytes(H, 1);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaFuncSetAttribute(ce_bwd_sweep_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  ce_bwd_sweep_kernel<<<n_splits, THREADS, (size_t)smem, s>>>(
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
