// K2 · per-client squared divergence on Hopper (sm_90a):
//   out[k] = sum_n (g[n] - x[k, n])^2,  f32 [K]
//
// Replaces the Pallas TPU kernel `divergence_sq` in
// src/repro/kernels/divergence.py (pallas_call at :54, body `_kernel` at
// :19): the streamed ||w_G - w_k||^2 behind the paper's Md criterion.
//
// Bound on the card ("NVIDIA H100 80GB HBM3, 700.00 W" as nvidia-smi
// prints it; data-sheet rates 3.35 TB/s HBM, 67 TFLOP/s f32): memory.  The
// function reads K*N + N input values once and writes K, at 3 flops per
// wave value, so at [37, 6603710] f32 it moves 1,003 MB and needs
// 1,003 MB / 3.35 TB/s ~= 0.30 ms; its 0.73 GFLOP would take ~11 us at the
// f32 rate.  These are data-sheet figures; the times measured on that card
// are in PERF.md.
//
// Design for that bound.  The TPU kernel keeps a [K] accumulator resident
// across its sequential grid steps; GPU blocks run in no order and carry
// nothing from one to the next, so the sum takes two passes, with no
// atomics (the sums repeat bit for bit from run to run):
//   1. grid (k, part): block (k, p) walks the column chunks p, p + P,
//      p + 2P, ... of row k (P = gridDim.y parts), each thread summing
//      kItems coalesced columns per chunk into one f32 register, then
//      reduces its threads in a fixed tree and writes partial[k, p].
//      k is the fastest grid index, so the K blocks that read the same
//      chunk of g run together and g comes from L2 after the first.
//   2. one block per row sums its P partials in a fixed order.
// bf16 inputs are widened to f32 before the subtraction.  Any K >= 1 and
// N >= 1; any P in [1, 65535] gives the same sums up to f32 rounding.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;  // columns per thread per chunk, kThreads apart
constexpr int64_t kChunk = static_cast<int64_t>(kThreads) * kItems;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Sum of `v` over the block's kThreads threads in a fixed order; the
// result is valid in thread 0.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float s[kThreads];
  s[threadIdx.x] = v;
  __syncthreads();
#pragma unroll
  for (unsigned int stride = kThreads / 2; stride > 0; stride >>= 1) {
    if (threadIdx.x < stride) s[threadIdx.x] += s[threadIdx.x + stride];
    __syncthreads();
  }
  return s[0];
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    divergence_partial_kernel(const T* __restrict__ x,
                              const T* __restrict__ g,
                              float* __restrict__ partial, int64_t N) {
  const int64_t k = blockIdx.x;
  const int64_t parts = gridDim.y;
  const int64_t chunks = (N + kChunk - 1) / kChunk;
  const T* __restrict__ row = x + k * N;
  float acc = 0.0f;
  for (int64_t c = blockIdx.y; c < chunks; c += parts) {
    const int64_t base = c * kChunk + threadIdx.x;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int64_t n = base + static_cast<int64_t>(j) * kThreads;
      if (n < N) {
        const float d = widen(g[n]) - widen(row[n]);
        acc = fmaf(d, d, acc);
      }
    }
  }
  const float total = block_sum(acc);
  if (threadIdx.x == 0) partial[k * parts + blockIdx.y] = total;
}

__global__ void __launch_bounds__(kThreads)
    divergence_finish_kernel(const float* __restrict__ partial,
                             float* __restrict__ out, int64_t parts) {
  const int64_t k = blockIdx.x;
  float acc = 0.0f;
  for (int64_t i = threadIdx.x; i < parts; i += kThreads) {
    acc += partial[k * parts + i];
  }
  const float total = block_sum(acc);
  if (threadIdx.x == 0) out[k] = total;
}

template <typename T>
int launch(const void* x, const void* g, float* partial, float* out,
           int64_t K, int64_t N, int64_t parts, void* stream) {
  if (K < 1 || N < 1 || K > 0x7fffffffLL || parts < 1 || parts > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned int>(K),
                  static_cast<unsigned int>(parts));
  divergence_partial_kernel<T><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), partial, N);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  divergence_finish_kernel<<<static_cast<unsigned int>(K), kThreads, 0, s>>>(
      partial, out, parts);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points for ctypes.  x: [K, N] row-major, g: [N] of x's
// dtype, partial: [K, parts] f32 scratch, out: [K] f32; all on the
// current device.  Launches both passes on `stream` without synchronising
// and returns cudaGetLastError() (0 on success).
extern "C" int divergence_sq_f32(const void* x, const void* g, float* partial,
                                 float* out, int64_t K, int64_t N,
                                 int64_t parts, void* stream) {
  return launch<float>(x, g, partial, out, K, N, parts, stream);
}

extern "C" int divergence_sq_bf16(const void* x, const void* g,
                                  float* partial, float* out, int64_t K,
                                  int64_t N, int64_t parts, void* stream) {
  return launch<__nv_bfloat16>(x, g, partial, out, K, N, parts, stream);
}
