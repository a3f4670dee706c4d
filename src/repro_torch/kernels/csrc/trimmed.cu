// K4 · coordinate-wise weighted trimmed mean on Hopper (sm_90a):
//   out[n] = sum_{k kept} w[k] x[k, n] / sum_{k kept} w[k]
// where, per column n, the `trim` largest and `trim` smallest of the S
// values are not kept.
//
// Replaces the Pallas TPU kernel `trimmed_agg` in
// src/repro/kernels/trimmed.py (pallas_call at :79, body `_kernel` at :25):
// the commit of the trimmed-mean robust strategy over the round's flat
// [S, N] client matrix.
//
// Bound on the card ("NVIDIA H100 80GB HBM3, 700.00 W" as nvidia-smi
// prints it; data-sheet rates 3.35 TB/s HBM, 67 TFLOP/s f32): memory.  The
// function reads S*N + S input values once and writes N, so at
// [37, 6603710] f32 it moves 1,003,764,068 bytes and needs 0.30 ms; its
// work is 2 * sum_{r < trim} (S - 2r) comparisons plus 3 * (S - 2 trim)
// sums per column, 579 at trim = 9 (3.8 G operations), 0.06 ms at the
// f32 rate.
// These are data-sheet figures; the times measured on that card are in
// PERF.md.
//
// Design.  The TPU kernel peels extremes from a [S, block_n] tile held in
// VMEM.  Here one thread owns one column: a block of `threads` threads
// stages its [S, threads] tile in shared memory as order-preserving int32
// keys (row s of the block's column t at keys[s * threads + t], so every
// row's load is coalesced along N and no two threads of a warp touch one
// bank; a pick is then one integer compare), with the weights once per
// block and a keep bit mask per column (word q of column t at
// keep[q * threads + t]).  A register array indexed by a runtime S would
// spill to local memory; shared memory keeps it on chip.  Threads share
// nothing but the weights, so the only barrier is the one after those.
//
// Each of the `trim` rounds makes one pass over the kept rows in
// ascending order and finds both the maximum (the LAST duplicate wins) and
// the minimum (the FIRST duplicate wins), then clears both bits.  That is
// the TPU kernel's max peel followed by its min peel (trimmed.py:29-43),
// and the stable-argsort rule of the plain version, because the two picks
// never coincide: before each round at least 3 rows are kept (2*trim <
// S), so the maximum's row differs from the minimum's unless every kept
// value is equal, and then the last kept row differs from the first.
// Comparisons are exact; as in torch.sort, -0 equals +0 and NaN counts as
// larger than any number and equal to NaN.  The sums then run over every
// row in row order in f32, each value (mapped back from its key) times
// its 0/1 keep flag: num, den and, when den <= 1e-12, the unweighted mean
// of the kept values (trimmed.py:44-48), so a column holding a NaN, or a
// trimmed inf, gives NaN as the plain version does.  bf16 inputs are
// widened on the load and the result rounded once on the store.  Columns past N are
// neither read nor written.  No atomics: results repeat bit for bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void narrow_store(float* p, float v) { *p = v; }
__device__ __forceinline__ void narrow_store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// An int32 key that orders like torch.sort orders floats: -0 and +0
// equal, NaN above +inf and equal to NaN (v != v holds for NaN alone:
// nothing is built with fast math).  Keys lie strictly between INT_MIN
// and INT_MAX.
constexpr int kNanKey = 0x7ffffffe;
__device__ __forceinline__ int to_key(float v) {
  if (v != v) return kNanKey;
  const int bits = __float_as_int(v == 0.0f ? 0.0f : v);
  return bits >= 0 ? bits : bits ^ 0x7fffffff;
}
__device__ __forceinline__ float from_key(int key) {
  return __int_as_float(key >= 0 ? key : key ^ 0x7fffffff);
}

// Shared memory of one block: the [S, threads] key tile, the keep bit
// masks and the [S] weights.
size_t smem_bytes(int64_t S, int threads) {
  const size_t words = (static_cast<size_t>(S) + 31) / 32;
  return 4 * (static_cast<size_t>(S) * threads + words * threads + S);
}

// The shared memory a block may opt in to on the current device (227 KB
// on an H100), or 0 if it cannot be read.
size_t smem_limit() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess) {
    return 0;
  }
  return static_cast<size_t>(bytes);
}

// Columns per block, the most of 256, 128, 64 and 32 whose block fits;
// 0 if not even 32 do.
int pick_threads(int64_t S, size_t limit) {
  for (int threads = 256; threads >= 32; threads /= 2) {
    if (smem_bytes(S, threads) <= limit) return threads;
  }
  return 0;
}

template <typename T>
__global__ void trimmed_agg_kernel(const T* __restrict__ x,
                                   const float* __restrict__ w,
                                   T* __restrict__ out, int S, int64_t N,
                                   int trim) {
  extern __shared__ int smem[];
  const int threads = blockDim.x;
  const int t = threadIdx.x;
  const int words = (S + 31) >> 5;
  int* keys = smem;
  uint32_t* keep = reinterpret_cast<uint32_t*>(keys + S * threads);
  float* ws = reinterpret_cast<float*>(keep + words * threads);

  for (int s = t; s < S; s += threads) ws[s] = w[s];
  __syncthreads();
  const int64_t n = static_cast<int64_t>(blockIdx.x) * threads + t;
  if (n >= N) return;

  const T* __restrict__ col = x + n;
#pragma unroll 8
  for (int s = 0; s < S; ++s) {
    keys[s * threads + t] = to_key(widen(col[static_cast<int64_t>(s) * N]));
  }
  for (int q = 0; q < words; ++q) {
    const int rows = S - 32 * q;
    keep[q * threads + t] = rows >= 32 ? 0xffffffffu : (1u << rows) - 1u;
  }

  for (int r = 0; r < trim; ++r) {
    int hi = INT_MIN, lo = INT_MAX, ihi = 0, ilo = 0;
    for (int q = 0; q < words; ++q) {
      uint32_t m = keep[q * threads + t];
      while (m) {
        const int s = 32 * q + __ffs(m) - 1;
        m &= m - 1;
        const int key = keys[s * threads + t];
        if (key >= hi) {
          hi = key;
          ihi = s;
        }
        if (key < lo) {
          lo = key;
          ilo = s;
        }
      }
    }
    keep[(ihi >> 5) * threads + t] &= ~(1u << (ihi & 31));
    keep[(ilo >> 5) * threads + t] &= ~(1u << (ilo & 31));
  }

  // every row, each times its keep flag (0 or 1), as trimmed.py:44-48
  // does: a trimmed inf or NaN makes the result NaN there too
  float num = 0.0f, den = 0.0f, sum = 0.0f;
  for (int s = 0; s < S; ++s) {
    const float kept =
        static_cast<float>((keep[(s >> 5) * threads + t] >> (s & 31)) & 1u);
    const float v = from_key(keys[s * threads + t]);
    const float wk = ws[s] * kept;
    num += v * wk;
    den += wk;
    sum += v * kept;
  }
  const float result = den > 1e-12f
                           ? num / fmaxf(den, 1e-12f)
                           : sum / static_cast<float>(S - 2 * trim);
  narrow_store(out + n, result);
}

template <typename T>
int launch(const void* x, const float* w, void* out, int64_t S, int64_t N,
           int64_t trim, void* stream) {
  if (S < 1 || N < 1 || trim < 0 || 2 * trim >= S || S > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int threads = pick_threads(S, smem_limit());
  if (threads == 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = (N + threads - 1) / threads;
  const size_t bytes = smem_bytes(S, threads);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        trimmed_agg_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  trimmed_agg_kernel<T>
      <<<static_cast<unsigned int>(blocks), static_cast<unsigned int>(threads),
         bytes, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(x), w, static_cast<T*>(out),
          static_cast<int>(S), N, static_cast<int>(trim));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points for ctypes.  x: [S, N] row-major, w: [S] f32, out:
// [N] of x's dtype; all on the current device.  Each block takes as many
// columns (256, 128, 64 or 32) as its shared memory allows.  Launches on
// `stream` without synchronising and returns cudaGetLastError() (0 on
// success), or cudaErrorInvalidValue for S above trimmed_agg_max_rows().
extern "C" int trimmed_agg_f32(const void* x, const float* w, void* out,
                               int64_t S, int64_t N, int64_t trim,
                               void* stream) {
  return launch<float>(x, w, out, S, N, trim, stream);
}

extern "C" int trimmed_agg_bf16(const void* x, const float* w, void* out,
                                int64_t S, int64_t N, int64_t trim,
                                void* stream) {
  return launch<__nv_bfloat16>(x, w, out, S, N, trim, stream);
}

// The largest S whose tile fits a block of 32 columns on the current
// device (1,708 on an H100).
extern "C" int64_t trimmed_agg_max_rows() {
  const size_t limit = smem_limit();
  int64_t S = static_cast<int64_t>(limit / (4 * 32));
  while (S > 0 && pick_threads(S, limit) == 0) --S;
  return S;
}
