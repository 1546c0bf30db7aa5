// Shared device helpers for the port's kernels: storage-type rounding and a
// deterministic block reduction.
//
// Rounding contract (matches PyTorch eager, and the JAX package in its
// strict-precision mode): every elementwise op is computed in f32 and rounded
// to its dtype right after, in the order the JAX expression is written.  For
// bf16 that is one f32 op then round-to-nearest-even to bf16 (the product of
// two bf16 values is exact in f32; for the sum, f32 then bf16 rounding equals
// one bf16 rounding since 24 >= 2*8+2).  The sources are built with
// --fmad=false and use __fmul_rn/__fadd_rn, so no a*b+c is ever contracted.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

using bf16 = __nv_bfloat16;

// dtype codes shared with the Python wrappers (kernels/_build.py)
enum DType : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16_rn(x); }

// x rounded to T's precision, held as f32
template <typename T> __device__ __forceinline__ float rnd(float x) { return to_f(from_f<T>(x)); }

// one arithmetic op in dtype T
template <typename T> __device__ __forceinline__ float mul(float a, float b) {
  return rnd<T>(__fmul_rn(a, b));
}
template <typename T> __device__ __forceinline__ float add(float a, float b) {
  return rnd<T>(__fadd_rn(a, b));
}
template <typename T> __device__ __forceinline__ float sub(float a, float b) {
  return rnd<T>(__fadd_rn(a, -b));
}

// Streaming passes: a fixed grid of at most kMaxBlocks blocks of kThreads
// threads walks the vector grid-stride; each block writes its f32 partial
// sums to a scratch buffer and one more block sums those in a fixed order.
// No atomics, so every run gives the same bits.
constexpr int kThreads = 256;
constexpr int kMaxBlocks = 4 * 132;

// Right-hand sides of one batched launch: the streaming passes put the RHS on
// the grid's y axis, whose extent is at most 65535.
constexpr int kMaxBatch = 65535;

inline int reduce_blocks(long long n) {
  long long b = (n + kThreads - 1) / kThreads;
  return (int)(b < kMaxBlocks ? b : kMaxBlocks);
}

// Per-thread f32 sums over a grid-stride loop, two levels deep: each run of
// kChunk consecutive terms goes to an inner sum, which is then added to the
// outer one.  One long chain of f32 adds drifts: over the ~4200 terms a thread
// takes at 608x608x1536, a chain of squared bf16 values lost 3.8e-6 of its
// sum; chains of at most kChunk terms, then of the chunk sums, keep the drift
// to a few 1e-8.  The order stays fixed, so a run repeats bit for bit.
constexpr int kChunk = 32;

template <int ND>
struct ChunkedSum {
  float outer[ND], inner[ND];
  int k = 0;

  __device__ __forceinline__ ChunkedSum() {
#pragma unroll
    for (int d = 0; d < ND; ++d) outer[d] = inner[d] = 0.0f;
  }
  __device__ __forceinline__ void add(const float (&x)[ND]) {
#pragma unroll
    for (int d = 0; d < ND; ++d) inner[d] = __fadd_rn(inner[d], x[d]);
    if (++k == kChunk) {
#pragma unroll
      for (int d = 0; d < ND; ++d) {
        outer[d] = __fadd_rn(outer[d], inner[d]);
        inner[d] = 0.0f;
      }
      k = 0;
    }
  }
  // N terms x[0] .. x[N-1] into the inner sums, and the inner sums into the
  // outer ones: a caller that adds runs of N terms, N | kChunk, and calls
  // flush after every kChunk / N runs gets the sums of N calls of add per
  // run, without the counter's register.
  template <int N>
  __device__ __forceinline__ void add_run(const float (&x)[N][ND]) {
    static_assert(kChunk % N == 0, "runs of N terms tile the chunks");
#pragma unroll
    for (int j = 0; j < N; ++j) {
#pragma unroll
      for (int d = 0; d < ND; ++d) inner[d] = __fadd_rn(inner[d], x[j][d]);
    }
  }
  __device__ __forceinline__ void flush() {
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      outer[d] = __fadd_rn(outer[d], inner[d]);
      inner[d] = 0.0f;
    }
  }
  __device__ __forceinline__ void total(float (&v)[ND]) const {
#pragma unroll
    for (int d = 0; d < ND; ++d) v[d] = __fadd_rn(outer[d], inner[d]);
  }
};

// Sum ND values over the block (blockDim.x == kThreads) in a fixed order;
// thread 0 gets the totals in v.
template <int ND>
__device__ __forceinline__ void block_sum(float (&v)[ND]) {
  __shared__ float sh[ND][kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 0; d < ND; ++d) {
    for (int o = 16; o > 0; o >>= 1) v[d] = __fadd_rn(v[d], __shfl_down_sync(0xffffffffu, v[d], o));
    if (lane == 0) sh[d][warp] = v[d];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      v[d] = lane < kThreads / 32 ? sh[d][lane] : 0.0f;
      for (int o = 16; o > 0; o >>= 1) v[d] = __fadd_rn(v[d], __shfl_down_sync(0xffffffffu, v[d], o));
    }
  }
}

// Grid-stride loop over n points (the streaming passes' fixed grid).
#define REPRO_GRID_STRIDE(i, n)                                             \
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < (n); \
       i += (int64_t)gridDim.x * kThreads)

// Reduce a thread's chunked sums over the block and write the block's ND
// partials to part[blockIdx.x * ND + d].
template <int ND>
__device__ __forceinline__ void store_partials(const ChunkedSum<ND>& acc, float* part) {
  float v[ND];
  acc.total(v);
  block_sum<ND>(v);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int d = 0; d < ND; ++d) part[blockIdx.x * ND + d] = v[d];
  }
}

// One block of kThreads per right-hand side b = blockIdx.x: out[d * B + b] =
// sum over blocks k of part[(b * nblk + k) * ND + d], with B = gridDim.x.
// Each RHS is summed in the same fixed order as a lone vector (B = 1).
template <int ND>
__global__ void __launch_bounds__(kThreads) sum_partials(const float* __restrict__ part, int nblk,
                                                         float* __restrict__ out) {
  part += (int64_t)blockIdx.x * nblk * ND;
  float v[ND];
#pragma unroll
  for (int d = 0; d < ND; ++d) v[d] = 0.0f;
  for (int b = threadIdx.x; b < nblk; b += kThreads) {
#pragma unroll
    for (int d = 0; d < ND; ++d) v[d] = __fadd_rn(v[d], part[b * ND + d]);
  }
  block_sum<ND>(v);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int d = 0; d < ND; ++d) out[d * gridDim.x + blockIdx.x] = v[d];
  }
}

}  // namespace repro
