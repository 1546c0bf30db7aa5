// Fused BiCGStab vector-update + inner-product passes, for one right-hand
// side or a batch of B.
//
// Replace the TPU kernels of src/repro/kernels/fused_iter/kernel.py:
//   update_q_dots_pallas  (_update_q_kernel):  q = r - st(a)*s;            <q,y>, <y,y>
//   update_xr_dots_pallas (_update_xr_kernel): x' = (x + st(a)*p) + st(w)*q,
//                                              r' = q - st(w)*y;           <r0,r'>, <r',r'>
//   update_p_pallas       (_update_p_kernel):  p' = r + st(b)*(p - st(w)*s)
//   dot_mixed_pallas      (_dot_kernel):       sum of f32(st(a*b))
// in their unbatched and batched (batched=True) forms, where st() rounds to
// the storage dtype.  The fused dots are taken in f32 from the upcast values;
// dot_mixed rounds each product to the storage dtype first (kernel.py:199).
//
// Bound: device-memory bytes.  Words moved per point: update_q_dots 4
// (r, s, y in; q out), update_xr_dots 7 (x, p, q, y, r0 in; x, r out),
// update_p 4, dot_mixed 2; a handful of flops each.  Design: one streaming
// pass per update, so each vector is read once and the dot partials come out
// of the same pass instead of another sweep; a fixed grid walks the vectors
// grid-stride, each thread sums in chunks, and the partial sums reduce
// without atomics (common.cuh), so the same inputs give the same bits on
// every run.  dot_mixed, which only reads, has a grid and loads of its own
// (below): with the update passes' grid (half the card's threads) and one
// 2-byte load of each operand per step, it had about 4 B in flight per thread
// and ran at a third of its byte bound.  The scalars come in by device
// pointer to f32 tensors and are rounded to storage here, so the solver loop
// never waits on the card to read them.
//
// Batch: the B right-hand sides lie back to back, n points each, and the grid
// is (reduce_blocks(n), B), dot_mixed's (dot_blocks(n), B), with blockIdx.y
// the RHS, which reads its own scalars alpha[b] (omega[b], beta[b]).  Each
// RHS runs the very grid, chunks and block tree of a lone vector, and sum_partials gives it one block of its
// own, so every RHS's outputs, dots included, equal the unbatched launch on
// that slice bit for bit.  The unbatched launch is the batched one with B = 1.
#include "common.cuh"

namespace repro {

template <typename T>
__global__ void __launch_bounds__(kThreads)
    update_q_dots_kernel(const float* __restrict__ alpha, const T* __restrict__ r,
                         const T* __restrict__ s, const T* __restrict__ y, T* __restrict__ q,
                         float* __restrict__ part, int64_t n) {
  const int64_t off = (int64_t)blockIdx.y * n;
  r += off, s += off, y += off, q += off;
  part += (int64_t)blockIdx.y * gridDim.x * 2;
  const float a = rnd<T>(alpha[blockIdx.y]);
  ChunkedSum<2> acc;
  REPRO_GRID_STRIDE(i, n) {
    const float qi = sub<T>(to_f(r[i]), mul<T>(a, to_f(s[i])));
    q[i] = from_f<T>(qi);
    const float yi = to_f(y[i]);
    acc.add({__fmul_rn(qi, yi), __fmul_rn(yi, yi)});
  }
  store_partials<2>(acc, part);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    update_xr_dots_kernel(const float* __restrict__ alpha, const float* __restrict__ omega,
                          const T* __restrict__ x, const T* __restrict__ p,
                          const T* __restrict__ q, const T* __restrict__ y,
                          const T* __restrict__ r0, T* __restrict__ xo, T* __restrict__ ro,
                          float* __restrict__ part, int64_t n) {
  const int64_t off = (int64_t)blockIdx.y * n;
  x += off, p += off, q += off, y += off, r0 += off, xo += off, ro += off;
  part += (int64_t)blockIdx.y * gridDim.x * 2;
  const float a = rnd<T>(alpha[blockIdx.y]), w = rnd<T>(omega[blockIdx.y]);
  ChunkedSum<2> acc;
  REPRO_GRID_STRIDE(i, n) {
    const float qi = to_f(q[i]);
    xo[i] = from_f<T>(add<T>(add<T>(to_f(x[i]), mul<T>(a, to_f(p[i]))), mul<T>(w, qi)));
    const float ri = sub<T>(qi, mul<T>(w, to_f(y[i])));
    ro[i] = from_f<T>(ri);
    acc.add({__fmul_rn(to_f(r0[i]), ri), __fmul_rn(ri, ri)});
  }
  store_partials<2>(acc, part);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    update_p_kernel(const float* __restrict__ beta, const float* __restrict__ omega,
                    const T* __restrict__ r, const T* __restrict__ p, const T* __restrict__ s,
                    T* __restrict__ po, int64_t n) {
  const int64_t off = (int64_t)blockIdx.y * n;
  r += off, p += off, s += off, po += off;
  const float b = rnd<T>(beta[blockIdx.y]), w = rnd<T>(omega[blockIdx.y]);
  REPRO_GRID_STRIDE(i, n) {
    po[i] = from_f<T>(add<T>(to_f(r[i]), mul<T>(b, sub<T>(to_f(p[i]), mul<T>(w, to_f(s[i]))))));
  }
}

// dot_mixed: its own grid, filling the card (kDotBlocks blocks of kThreads,
// 2048 threads on each of the 132 SMs), and 16-B loads.  Elements group by
// index within the RHS into vectors of G = 16 B / itemsize (8 bf16, 4 f32);
// each group's G rounded products sum in a fixed tree, a thread's group sums
// in chunks of kChunk, and the blocks' partials in sum_partials.  A thread
// takes two groups a step, so 64 B of a and b are in flight per thread.
// Where n % G != 0 or an operand is not 16-B aligned the same groups load
// element by element (the last one zero-padded), so the sums depend only on
// n and the elements, never on the addresses: each RHS of a batch equals the
// B = 1 launch on it bit for bit, also where RHS b > 0 starts off a 16-B
// boundary (n odd).
constexpr int kDotBlocks = 8 * 132;

inline int dot_blocks(long long n) {
  const long long b = (n + kThreads * 8 - 1) / (kThreads * 8);
  return (int)(b < kDotBlocks ? b : kDotBlocks);
}

// group j (elements G j .. G j + G-1) of p: one 16-B load when wide
template <typename T>
__device__ __forceinline__ uint4 load_group(const T* p, uint32_t j, int64_t n, bool wide) {
  constexpr int G = 16 / (int)sizeof(T);
  if (wide) return __ldg(reinterpret_cast<const uint4*>(p) + j);
  float v[G];
#pragma unroll
  for (int e = 0; e < G; ++e) {
    const int64_t i = (int64_t)j * G + e;
    v[e] = i < n ? to_f(p[i]) : 0.0f;
  }
  uint32_t w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if constexpr (G == 4) w[k] = __float_as_uint(v[k]);
    else w[k] = (__float_as_uint(v[2 * k]) >> 16) | (__float_as_uint(v[2 * k + 1]) & 0xffff0000u);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// sum of the group's products rounded to T, in a fixed tree
template <typename T>
__device__ __forceinline__ float group_dot(const uint4& a, const uint4& b) {
  const uint32_t wa[4] = {a.x, a.y, a.z, a.w}, wb[4] = {b.x, b.y, b.z, b.w};
  float p[8];
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int k = 0; k < 4; ++k) p[k] = __fmul_rn(__uint_as_float(wa[k]), __uint_as_float(wb[k]));
    return __fadd_rn(__fadd_rn(p[0], p[1]), __fadd_rn(p[2], p[3]));
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      p[2 * k] = mul<T>(__uint_as_float(wa[k] << 16), __uint_as_float(wb[k] << 16));
      p[2 * k + 1] = mul<T>(__uint_as_float(wa[k] & 0xffff0000u),
                            __uint_as_float(wb[k] & 0xffff0000u));
    }
    return __fadd_rn(__fadd_rn(__fadd_rn(p[0], p[1]), __fadd_rn(p[2], p[3])),
                     __fadd_rn(__fadd_rn(p[4], p[5]), __fadd_rn(p[6], p[7])));
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 8)
    dot_mixed_kernel(const T* __restrict__ a, const T* __restrict__ b, float* __restrict__ part,
                     int64_t n, int wide) {
  constexpr int G = 16 / (int)sizeof(T);
  const int64_t off = (int64_t)blockIdx.y * n;
  a += off, b += off;
  part += (int64_t)blockIdx.y * gridDim.x;
  const uint32_t ng = (uint32_t)((n + G - 1) / G), stride = gridDim.x * kThreads;
  uint32_t j = blockIdx.x * kThreads + threadIdx.x;
  float inner = 0.0f, outer = 0.0f;
  int k = 0;
  for (; j + stride < ng; j += 2 * stride) {
    const uint4 a0 = load_group(a, j, n, wide), b0 = load_group(b, j, n, wide);
    const uint4 a1 = load_group(a, j + stride, n, wide), b1 = load_group(b, j + stride, n, wide);
    inner = __fadd_rn(inner, group_dot<T>(a0, b0));
    inner = __fadd_rn(inner, group_dot<T>(a1, b1));
    if (++k == kChunk / 2) {
      outer = __fadd_rn(outer, inner);
      inner = 0.0f;
      k = 0;
    }
  }
  if (j < ng) inner = __fadd_rn(inner, group_dot<T>(load_group(a, j, n, wide),
                                                    load_group(b, j, n, wide)));
  float v[1] = {__fadd_rn(outer, inner)};
  block_sum<1>(v);
  if (threadIdx.x == 0) part[blockIdx.x] = v[0];
}

}  // namespace repro

extern "C" {

// Blocks of the partial-sum pass over n points: the scratch buffer of a
// dot-producing launch holds B * repro_reduce_blocks(n) * n_dots floats ...
int repro_reduce_blocks(long long n) { return repro::reduce_blocks(n); }

// ... except dot_mixed's, which holds B * repro_dot_mixed_blocks(n) floats.
int repro_dot_mixed_blocks(long long n) { return repro::dot_blocks(n); }

// Every entry point runs one pass over B right-hand sides of n points each,
// back to back, with B scalars of each kind (a 0-d scalar is B = 1), and
// returns a cudaError_t code (0 on success).  `partials` is f32 scratch of
// B * repro_reduce_blocks(n) * n_dots floats (B * repro_dot_mixed_blocks(n)
// for dot_mixed); `out` receives the n_dots x B
// f32 sums, dot-major.

#define REPRO_CHECK_SIZE(n, nb) \
  if ((n) < 1 || (nb) < 1 || (nb) > repro::kMaxBatch) return (int)cudaErrorInvalidValue

int repro_update_q_dots(int dtype, const void* alpha, const void* r, const void* s,
                        const void* y, void* q, void* partials, void* out, long long n,
                        long long nb, void* stream) {
  using namespace repro;
  REPRO_CHECK_SIZE(n, nb);
  const dim3 grid(reduce_blocks(n), (unsigned)nb);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) {
    update_q_dots_kernel<float><<<grid, kThreads, 0, st>>>(
        (const float*)alpha, (const float*)r, (const float*)s, (const float*)y, (float*)q,
        (float*)partials, n);
  } else if (dtype == kBF16) {
    update_q_dots_kernel<bf16><<<grid, kThreads, 0, st>>>(
        (const float*)alpha, (const bf16*)r, (const bf16*)s, (const bf16*)y, (bf16*)q,
        (float*)partials, n);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  sum_partials<2><<<(unsigned)nb, kThreads, 0, st>>>((const float*)partials, grid.x, (float*)out);
  return (int)cudaGetLastError();
}

int repro_update_xr_dots(int dtype, const void* alpha, const void* omega, const void* x,
                         const void* p, const void* q, const void* y, const void* r0, void* xo,
                         void* ro, void* partials, void* out, long long n, long long nb,
                         void* stream) {
  using namespace repro;
  REPRO_CHECK_SIZE(n, nb);
  const dim3 grid(reduce_blocks(n), (unsigned)nb);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) {
    update_xr_dots_kernel<float><<<grid, kThreads, 0, st>>>(
        (const float*)alpha, (const float*)omega, (const float*)x, (const float*)p,
        (const float*)q, (const float*)y, (const float*)r0, (float*)xo, (float*)ro,
        (float*)partials, n);
  } else if (dtype == kBF16) {
    update_xr_dots_kernel<bf16><<<grid, kThreads, 0, st>>>(
        (const float*)alpha, (const float*)omega, (const bf16*)x, (const bf16*)p,
        (const bf16*)q, (const bf16*)y, (const bf16*)r0, (bf16*)xo, (bf16*)ro,
        (float*)partials, n);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  sum_partials<2><<<(unsigned)nb, kThreads, 0, st>>>((const float*)partials, grid.x, (float*)out);
  return (int)cudaGetLastError();
}

int repro_update_p(int dtype, const void* beta, const void* omega, const void* r, const void* p,
                   const void* s, void* po, long long n, long long nb, void* stream) {
  using namespace repro;
  REPRO_CHECK_SIZE(n, nb);
  const dim3 grid(reduce_blocks(n), (unsigned)nb);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) {
    update_p_kernel<float><<<grid, kThreads, 0, st>>>(
        (const float*)beta, (const float*)omega, (const float*)r, (const float*)p,
        (const float*)s, (float*)po, n);
  } else if (dtype == kBF16) {
    update_p_kernel<bf16><<<grid, kThreads, 0, st>>>(
        (const float*)beta, (const float*)omega, (const bf16*)r, (const bf16*)p,
        (const bf16*)s, (bf16*)po, n);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int repro_dot_mixed(int dtype, const void* a, const void* b, void* partials, void* out,
                    long long n, long long nb, void* stream) {
  using namespace repro;
  REPRO_CHECK_SIZE(n, nb);
  const long long G = dtype == kF32 ? 4 : 8;
  if ((n + G - 1) / G > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid(dot_blocks(n), (unsigned)nb);
  const int wide = n % G == 0 && ((uintptr_t)a & 15) == 0 && ((uintptr_t)b & 15) == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) {
    dot_mixed_kernel<float><<<grid, kThreads, 0, st>>>((const float*)a, (const float*)b,
                                                       (float*)partials, n, wide);
  } else if (dtype == kBF16) {
    dot_mixed_kernel<bf16><<<grid, kThreads, 0, st>>>((const bf16*)a, (const bf16*)b,
                                                      (float*)partials, n, wide);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  sum_partials<1><<<(unsigned)nb, kThreads, 0, st>>>((const float*)partials, grid.x, (float*)out);
  return (int)cudaGetLastError();
}

#undef REPRO_CHECK_SIZE

}  // extern "C"
