// Fused dropout for Hopper (sm_90a), fp32 and bf16, with its random bits
// made inside the kernel.
//
// Replaces the Pallas TPU kernel bsarec_tpu/ops/pallas_dropout.py:_kernel
// (pallas_call at :91, driven by pallas_dropout at :105-125):
//   y_i = x_i * inv_keep   where bits_i >= threshold,   else 0,
// with threshold = min(floor(rate * 2^32), 2^32 - 1) and inv_keep =
// 1 / (1 - rate) rounded to x's type, the product taken in fp32 and rounded
// to x's type. The backward of a dropout site is the same function applied
// to the cotangent with the same seeds and call index: the mask is made
// again, never stored.
//
// The random word of element i (the flat index into the tensor) is word
// i mod 4 of Philox4x32-10 (Salmon, Moraes, Dror and Shaw, "Parallel
// random numbers: as easy as 1, 2, 3", SC'11; the Random123 definition)
// at counter (q mod 2^32, q >> 32, call, 0), q = i / 4, under the key
// (seed[0], seed[1]). It depends on the two seed words, the site's call
// index and i only, never on the launch shape or the pointer's alignment,
// so the forward and backward masks agree by construction and a plain
// version (bsarec_tpu_torch/ops/dropout.py) reproduces every bit. The
// TPU kernel's per-block seed hash (pallas_dropout.py:74-75) and its
// [rows, 128] full-block rule (:46-66) exist only for Mosaic and have no
// counterpart here: any element count >= 1 is taken.
//
// What bounds it: the pass reads x once and writes y once, 2 * N *
// sizeof(x) bytes; at SASRec's sites ([256, 50, 64] and [256, 2, 50, 50]
// fp32) that is 6.6 MB and 10.2 MB, about 1.96 us and 3.06 us at the H100
// SXM's 3.35 TB/s. Philox costs 10 rounds of two 32x32->64-bit products
// (mul.lo and mul.hi) and a few xors per four elements: about 12 integer
// operations per element, far under the memory time. So the kernel is
// bound by memory, and at these sizes by its launch.
//
// Design. One thread per group of four consecutive elements and one
// Philox call per thread; 16-byte (fp32) or 8-byte (bf16) vector loads and
// stores where both pointers are aligned to four elements, element by
// element otherwise and in the ragged last group. The seeds are read from
// device memory by the kernel, so the host never waits for them. No
// shared memory, no scratch; the kernel runs on the caller's stream.
// At these sizes the grid is one wave, so a thread's chain of latencies
// is the kernel's time: the vector load of x goes out first and its
// latency overlaps the seeds' load and the generator (see the kernel).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t PHILOX_M0 = 0xD2511F53u;
constexpr uint32_t PHILOX_M1 = 0xCD9E8D57u;
constexpr uint32_t PHILOX_W0 = 0x9E3779B9u;
constexpr uint32_t PHILOX_W1 = 0xBB67AE85u;
constexpr int THREADS = 256;

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    if (round > 0) {  // the key is bumped before every round but the first
      k0 += PHILOX_W0;
      k1 += PHILOX_W1;
    }
    const uint32_t lo0 = PHILOX_M0 * c.x, hi0 = __umulhi(PHILOX_M0, c.x);
    const uint32_t lo1 = PHILOX_M1 * c.z, hi1 = __umulhi(PHILOX_M1, c.z);
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

__device__ __forceinline__ float apply(float v, uint32_t bits, uint32_t threshold, float inv_keep) {
  return bits >= threshold ? v * inv_keep : 0.0f;
}

__device__ __forceinline__ __nv_bfloat16 apply(__nv_bfloat16 v, uint32_t bits, uint32_t threshold,
                                               float inv_keep) {
  return bits >= threshold ? __float2bfloat16(__bfloat162float(v) * inv_keep)
                           : __float2bfloat16(0.0f);
}

// Four elements as one aligned vector: float4 (16 bytes) or 4 x bf16 (8 bytes).
template <typename T> struct Quad;
template <> struct Quad<float> { using type = float4; };
template <> struct Quad<__nv_bfloat16> { struct alignas(8) type { __nv_bfloat16 v[4]; }; };

__device__ __forceinline__ void quad_apply(float4& q, const uint32_t* bits, uint32_t t, float s) {
  q.x = apply(q.x, bits[0], t, s);
  q.y = apply(q.y, bits[1], t, s);
  q.z = apply(q.z, bits[2], t, s);
  q.w = apply(q.w, bits[3], t, s);
}

template <typename Q>
__device__ __forceinline__ void quad_apply(Q& q, const uint32_t* bits, uint32_t t, float s) {
#pragma unroll
  for (int j = 0; j < 4; ++j) q.v[j] = apply(q.v[j], bits[j], t, s);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
fused_dropout_kernel(const T* __restrict__ x, T* __restrict__ y, long long n,
                     const long long* __restrict__ seed, uint32_t call, uint32_t threshold,
                     float inv_keep, int vectorized) {
  using V = typename Quad<T>::type;
  const long long q = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long i0 = 4 * q;
  if (i0 >= n) return;
  const bool whole = vectorized && i0 + 4 <= n;
  // The input's load is issued before the seeds' and the generator's ten
  // rounds, so that its memory latency runs under them: loaded after them,
  // as the compiler placed it when the load sat behind the generator, the
  // latency of a cold read followed theirs.
  V v;
  if (whole) v = reinterpret_cast<const V*>(x)[q];
  const uint4 r = philox4x32_10(make_uint4((uint32_t)q, (uint32_t)(q >> 32), call, 0u),
                                (uint32_t)seed[0], (uint32_t)seed[1]);
  const uint32_t bits[4] = {r.x, r.y, r.z, r.w};
  if (whole) {
    quad_apply(v, bits, threshold, inv_keep);
    reinterpret_cast<V*>(y)[q] = v;
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (i0 + j < n) y[i0 + j] = apply(x[i0 + j], bits[j], threshold, inv_keep);
  }
}

template <typename T>
int launch(const void* x, void* y, long long n, const void* seed, uint32_t call,
           uint32_t threshold, float inv_keep, cudaStream_t stream) {
  const uintptr_t quad_bytes = 4 * sizeof(T);
  const int vectorized = ((uintptr_t)x % quad_bytes == 0) && ((uintptr_t)y % quad_bytes == 0);
  const long long groups = (n + 3) / 4;
  const long long blocks = (groups + THREADS - 1) / THREADS;
  fused_dropout_kernel<T><<<(unsigned)blocks, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), n, static_cast<const long long*>(seed), call,
      threshold, inv_keep, vectorized);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// y = dropout(x) over n >= 1 contiguous elements of type dtype (0: fp32,
// 1: bf16). seed: two int64 words on the device, of which the low 32 bits
// are Philox's key; call: the site's call index; threshold and inv_keep as
// in the note above (inv_keep already rounded to x's type). Returns 0 or a
// cudaError_t code.
int fused_dropout(const void* x, void* y, long long n, int dtype, const void* seed,
                  unsigned call, unsigned threshold, float inv_keep, void* stream) {
  if (n < 1 || (n + 3) / 4 > (long long)THREADS * 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, y, n, seed, call, threshold, inv_keep, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, y, n, seed, call, threshold, inv_keep, s);
  return (int)cudaErrorInvalidValue;
}

const char* fused_dropout_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
