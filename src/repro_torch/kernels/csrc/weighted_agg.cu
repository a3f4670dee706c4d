// K1 · weighted aggregation on Hopper (sm_90a):  out[n] = sum_k w[k] * x[k, n]
//
// Replaces the Pallas TPU kernel `weighted_agg` in
// src/repro/kernels/weighted_agg.py (pallas_call at :58, body `_kernel` at
// :26): the server's commit w_G = sum_k p_k w_k over the round's flat
// [K, N] client matrix.
//
// Bound on the card ("NVIDIA H100 80GB HBM3, 700.00 W" as nvidia-smi
// prints it; data-sheet rates 3.35 TB/s HBM, 67 TFLOP/s f32): memory.  The
// kernel reads K*N input values once and writes N, at 2 flops per input
// value, so at [37, 6603710] f32 it moves 1,003 MB (977 MB of them the
// wave) and needs 1,003 MB / 3.35 TB/s ~= 0.30 ms; its 0.49 GFLOP would
// take ~7 us at the f32 rate.  These are data-sheet figures; the times
// measured on that card are in PERF.md.
//
// Design for that bound.  The TPU kernel streams one [K, block_n] tile per
// sequential grid step.  Here every thread owns kCols columns, spaced
// kThreads apart so that a warp's loads of one row are 32 consecutive
// elements (coalesced), and walks the K rows in a fixed order with one f32
// accumulator per column.  The kCols independent loads per row, and the
// unrolled row loop, keep enough loads in flight per SM to stream HBM.
// Each output element is reduced by one thread in the order k = 0..K-1:
// no atomics, so the result repeats bit for bit from run to run.  bf16
// inputs are widened to f32, accumulated in f32, and rounded once to
// bf16 (round to nearest even) on the store.  Any K >= 1 and N >= 1.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 4;  // columns per thread, kThreads apart

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void narrow_store(float* p, float v) { *p = v; }
__device__ __forceinline__ void narrow_store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    weighted_agg_kernel(const T* __restrict__ x, const float* __restrict__ w,
                        T* __restrict__ out, int64_t K, int64_t N) {
  const int64_t base =
      static_cast<int64_t>(blockIdx.x) * (kThreads * kCols) + threadIdx.x;
  float acc[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) acc[j] = 0.0f;
#pragma unroll 4
  for (int64_t k = 0; k < K; ++k) {
    const float wk = w[k];
    const T* __restrict__ row = x + k * N;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int64_t n = base + static_cast<int64_t>(j) * kThreads;
      if (n < N) acc[j] = fmaf(wk, widen(row[n]), acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    const int64_t n = base + static_cast<int64_t>(j) * kThreads;
    if (n < N) narrow_store(out + n, acc[j]);
  }
}

template <typename T>
int launch(const void* x, const float* w, void* out, int64_t K, int64_t N,
           void* stream) {
  const int64_t per_block = static_cast<int64_t>(kThreads) * kCols;
  const int64_t blocks = (N + per_block - 1) / per_block;
  if (K < 1 || N < 1 || blocks > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  weighted_agg_kernel<T><<<static_cast<unsigned int>(blocks), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), w, static_cast<T*>(out), K, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points for ctypes.  x: [K, N] row-major, w: [K] f32,
// out: [N] of x's dtype; all on the current device.  Launches on `stream`
// without synchronising and returns cudaGetLastError() (0 on success).
extern "C" int weighted_agg_f32(const void* x, const float* w, void* out,
                                int64_t K, int64_t N, void* stream) {
  return launch<float>(x, w, out, K, N, stream);
}

extern "C" int weighted_agg_bf16(const void* x, const float* w, void* out,
                                 int64_t K, int64_t N, void* stream) {
  return launch<__nv_bfloat16>(x, w, out, K, N, stream);
}
