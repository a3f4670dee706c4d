// K5 · pairwise squared distances on Hopper (sm_90a):
//   G = X X^T (f32),  d2[i, j] = max(G[i, i] + G[j, j] - 2 G[i, j], 0),
//   d2[i, i] = 0,  over the round's flat [S, N] client matrix X.
//
// Replaces the Pallas TPU kernel `pairwise_sq_dists` in
// src/repro/kernels/krum.py (pallas_call at :72, body `_gram_kernel` at
// :36): the distances behind Krum / multi-Krum.
//
// Bound on the card ("NVIDIA H100 80GB HBM3, 700.00 W" as nvidia-smi
// prints it; data-sheet rates 3.35 TB/s HBM, 67 TFLOP/s f32 outside the
// tensor cores).  At [37, 6603710] f32 the function reads 977,349,080
// bytes (0.29 ms) and does 2 S^2 N = 18.1 GFLOP (0.27 ms), or S (S + 1) N
// = 9.3 GFLOP (0.14 ms) with the symmetry: the two bounds are close, so
// the kernel is balanced rather than purely memory-bound.  These are
// data-sheet figures; the times measured on that card are in PERF.md.
//
// Design.  The TPU kernel keeps an [S, S] accumulator in VMEM across its
// sequential grid over N tiles; GPU blocks run in no order and carry
// nothing, so the sum takes two passes and no atomics (the result repeats
// bit for bit):
//   1. split-K Gram.  The N axis is cut into `parts` chunks, a number the
//      wrapper derives from S and N alone (never from the device), and the
//      upper triangle of G into 64x64 output tiles.  Block (tile pair,
//      chunk) streams [64, kDepth] sub-tiles of its two row ranges through
//      shared memory (rows padded by one word: no bank conflicts), loading
//      the next sub-tile into registers while it computes on this one.
//      Each thread owns a 4x4 micro-tile of pairs and accumulates it with
//      f32 FMA on the CUDA cores, in column order.  No TF32 and no tensor
//      cores: the reference's gate is rtol 1e-5 in f32.  On a diagonal
//      tile the 136 micro-tiles on or above its diagonal are numbered so
//      that those of the first rows come first, so the working micro-tiles
//      fill the first slots (55 at S = 37).  When they fit in a quarter
//      (or a half) of the block's 256 threads, each quarter (half) takes a
//      quarter (half) of every sub-tile's columns, and the groups' sums
//      are added in group order at the end: at S = 37 all eight warps
//      compute.  Each block writes its pairs of partial[chunk].
//   2. one warp per (i, j) sums G[i, j], G[i, i] and G[j, j] over the
//      chunks in a fixed order (each lane every 32nd chunk, then a fixed
//      butterfly), writes G (both triangles from one sum) and the
//      epilogue d2, with an exact zero diagonal.
// bf16 inputs are widened on the load.  Rows past S and columns past N
// are staged as zeros and never written.  Any S >= 1, N >= 1.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTile = 64;                    // output tile side (rows)
constexpr int kMicro = 4;                    // a thread's micro-tile side
constexpr int kSide = kTile / kMicro;        // 16 micro-tiles per side
constexpr int kThreads = kSide * kSide;      // 256
constexpr int kDepth = 32;                   // columns per sub-tile
constexpr int kRowsPerPass = kThreads / kDepth;      // 8
constexpr int kLoads = kTile / kRowsPerPass;         // 8 per thread
constexpr int kFinishThreads = 256;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Thread's share of rows [row0, row0 + kTile) x columns [k0, k0 + kDepth)
// of x, zeros outside [0, S) x [k0, end).
template <typename T>
__device__ __forceinline__ void fetch(float (&r)[kLoads],
                                      const T* __restrict__ x, int row0,
                                      int S, int64_t N, int64_t k0,
                                      int64_t end) {
  const int64_t n = k0 + threadIdx.x % kDepth;
#pragma unroll
  for (int i = 0; i < kLoads; ++i) {
    const int row = row0 + threadIdx.x / kDepth + i * kRowsPerPass;
    r[i] = (row < S && n < end) ? widen(x[static_cast<int64_t>(row) * N + n])
                                : 0.0f;
  }
}

__device__ __forceinline__ void stash(float (*sm)[kDepth + 1],
                                      const float (&r)[kLoads]) {
#pragma unroll
  for (int i = 0; i < kLoads; ++i) {
    sm[threadIdx.x / kDepth + i * kRowsPerPass][threadIdx.x % kDepth] = r[i];
  }
}

// The micro-tiles a thread may own, in the order the block's slots take
// them: on a diagonal tile the pairs a <= b, numbered p = b (b + 1) / 2 + a
// (the pairs of the first rows come first); elsewhere b-major, so that the
// rows of tile tj past S are the last slots.
__device__ __forceinline__ void micro_pair(bool diag, int p, int& a, int& b) {
  if (diag) {
    b = static_cast<int>((sqrtf(8.0f * p + 1.0f) - 1.0f) * 0.5f);
    while (b * (b + 1) / 2 > p) --b;
    while ((b + 1) * (b + 2) / 2 <= p) ++b;
    a = p - b * (b + 1) / 2;
  } else {
    b = p / kSide;
    a = p % kSide;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    gram_partial_kernel(const T* __restrict__ x, float* __restrict__ partial,
                        int S, int64_t N, int64_t chunk) {
  // two [kTile][kDepth + 1] sub-tiles; at the end, the k-groups' sums
  __shared__ float smem[2 * kTile * (kDepth + 1)];
  float (*xa)[kDepth + 1] = reinterpret_cast<float (*)[kDepth + 1]>(smem);
  float (*xb)[kDepth + 1] =
      reinterpret_cast<float (*)[kDepth + 1]>(smem + kTile * (kDepth + 1));
  const int tiles = (S + kTile - 1) / kTile;
  int pair = blockIdx.x, ti = 0;
  while (pair >= tiles - ti) {  // row-major walk of the upper triangle
    pair -= tiles - ti;
    ++ti;
  }
  const int tj = ti + pair;
  const bool diag = ti == tj;
  if (diag) xb = xa;

  // The tile pair's working micro-tiles fill slots [0, work).  When they
  // fit in a half or a quarter of the block, the block splits each
  // sub-tile's columns between `groups` groups of `slots` threads, which
  // sum their own columns and add up in group order at the end.
  const int rows_i = min(kSide, (S - ti * kTile + kMicro - 1) / kMicro);
  const int rows_j = min(kSide, (S - tj * kTile + kMicro - 1) / kMicro);
  const int work = diag ? rows_i * (rows_i + 1) / 2 : kSide * rows_j;
  const int groups = work <= kThreads / 4 ? 4 : work <= kThreads / 2 ? 2 : 1;
  const int slots = kThreads / groups;
  const int slot = threadIdx.x % slots, group = threadIdx.x / slots;
  int a, b;
  micro_pair(diag, slot, a, b);
  const int row_a = ti * kTile + a * kMicro;
  const int row_b = tj * kTile + b * kMicro;
  const bool active = slot < work;
  const int k_lo = group * (kDepth / groups);
  const int k_hi = k_lo + kDepth / groups;

  const int64_t begin = static_cast<int64_t>(blockIdx.y) * chunk;
  const int64_t end = begin + chunk < N ? begin + chunk : N;
  float acc[kMicro][kMicro];
#pragma unroll
  for (int u = 0; u < kMicro; ++u)
#pragma unroll
    for (int v = 0; v < kMicro; ++v) acc[u][v] = 0.0f;

  float ra[kLoads], rb[kLoads];
  fetch(ra, x, ti * kTile, S, N, begin, end);
  if (!diag) fetch(rb, x, tj * kTile, S, N, begin, end);
  for (int64_t k0 = begin; k0 < end; k0 += kDepth) {
    __syncthreads();  // the previous sub-tile is no longer read
    stash(xa, ra);
    if (!diag) stash(xb, rb);
    __syncthreads();
    if (k0 + kDepth < end) {  // in flight while this sub-tile computes
      fetch(ra, x, ti * kTile, S, N, k0 + kDepth, end);
      if (!diag) fetch(rb, x, tj * kTile, S, N, k0 + kDepth, end);
    }
    if (active) {
#pragma unroll 8
      for (int k = k_lo; k < k_hi; ++k) {
        float va[kMicro], vb[kMicro];
#pragma unroll
        for (int u = 0; u < kMicro; ++u) {
          va[u] = xa[a * kMicro + u][k];
          vb[u] = xb[b * kMicro + u][k];
        }
#pragma unroll
        for (int u = 0; u < kMicro; ++u)
#pragma unroll
          for (int v = 0; v < kMicro; ++v)
            acc[u][v] = fmaf(va[u], vb[v], acc[u][v]);
      }
    }
  }

  // add the groups' sums in group order (smem[uv][thread]: no conflicts)
  __syncthreads();
#pragma unroll
  for (int u = 0; u < kMicro; ++u)
#pragma unroll
    for (int v = 0; v < kMicro; ++v)
      smem[(u * kMicro + v) * kThreads + threadIdx.x] = acc[u][v];
  __syncthreads();
  if (group != 0 || !active) return;
  float* __restrict__ out =
      partial + static_cast<int64_t>(blockIdx.y) * S * S;
#pragma unroll
  for (int u = 0; u < kMicro; ++u)
#pragma unroll
    for (int v = 0; v < kMicro; ++v) {
      float sum = smem[(u * kMicro + v) * kThreads + slot];
      for (int g = 1; g < groups; ++g) {
        sum += smem[(u * kMicro + v) * kThreads + g * slots + slot];
      }
      const int i = row_a + u, j = row_b + v;
      if (i < S && j < S) out[static_cast<int64_t>(i) * S + j] = sum;
    }
}

// One warp per (i, j): lane l sums chunks l, l + 32, ... in order, then
// the lanes add up in a fixed butterfly, so every warp that needs G[i, i]
// computes the same bits and G comes out exactly symmetric.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, offset);
  }
  return v;
}

__global__ void __launch_bounds__(kFinishThreads)
    gram_finish_kernel(const float* __restrict__ partial, int S, int parts,
                       float* __restrict__ gram, float* __restrict__ d2) {
  const int64_t ss = static_cast<int64_t>(S) * S;
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * (kFinishThreads / 32)
                      + threadIdx.x / 32;
  if (idx >= ss) return;  // whole warps leave together
  const int lane = threadIdx.x % 32;
  const int i = static_cast<int>(idx / S), j = static_cast<int>(idx % S);
  const int lo = i < j ? i : j, hi = i < j ? j : i;
  const int64_t at_ij = static_cast<int64_t>(lo) * S + hi;
  const int64_t at_ii = static_cast<int64_t>(i) * S + i;
  const int64_t at_jj = static_cast<int64_t>(j) * S + j;
  float gij = 0.0f, gii = 0.0f, gjj = 0.0f;
#pragma unroll 4
  for (int p = lane; p < parts; p += 32) {
    const float* __restrict__ part = partial + p * ss;
    gij += part[at_ij];
    gii += part[at_ii];
    gjj += part[at_jj];
  }
  gij = warp_sum(gij);
  gii = warp_sum(gii);
  gjj = warp_sum(gjj);
  if (lane != 0) return;
  gram[idx] = gij;
  d2[idx] = i == j ? 0.0f : fmaxf(gii + gjj - 2.0f * gij, 0.0f);
}

template <typename T>
int launch(const void* x, float* partial, float* gram, float* d2, int64_t S,
           int64_t N, int64_t chunk, int64_t parts, void* stream) {
  const int64_t tiles = (S + kTile - 1) / kTile;
  const int64_t pairs = tiles * (tiles + 1) / 2;
  if (S < 1 || N < 1 || chunk < 1 || chunk % kDepth != 0 || parts < 1 ||
      parts > 65535 || (parts - 1) * chunk >= N || parts * chunk < N ||
      pairs > 0x7fffffffLL || S * S / (kFinishThreads / 32) >= 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned int>(pairs),
                  static_cast<unsigned int>(parts));
  gram_partial_kernel<T><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(x), partial, static_cast<int>(S), N, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t per_block = kFinishThreads / 32;
  const int64_t blocks = (S * S + per_block - 1) / per_block;
  gram_finish_kernel<<<static_cast<unsigned int>(blocks), kFinishThreads, 0,
                       s>>>(partial, static_cast<int>(S),
                            static_cast<int>(parts), gram, d2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points for ctypes.  x: [S, N] row-major; partial:
// [parts, S, S] f32 scratch; gram, d2: [S, S] f32; all on the current
// device.  Chunk p covers columns [p * chunk, min((p + 1) * chunk, N));
// `chunk` is a multiple of 32 and every chunk is non-empty.  Launches
// both passes on `stream` without synchronising and returns
// cudaGetLastError() (0 on success).
extern "C" int pairwise_sq_dists_f32(const void* x, float* partial,
                                     float* gram, float* d2, int64_t S,
                                     int64_t N, int64_t chunk, int64_t parts,
                                     void* stream) {
  return launch<float>(x, partial, gram, d2, S, N, chunk, parts, stream);
}

extern "C" int pairwise_sq_dists_bf16(const void* x, float* partial,
                                      float* gram, float* d2, int64_t S,
                                      int64_t N, int64_t chunk,
                                      int64_t parts, void* stream) {
  return launch<__nv_bfloat16>(x, partial, gram, d2, S, N, chunk, parts,
                               stream);
}
