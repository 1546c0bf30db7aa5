// Fused BiCGStab vector-update + inner-product passes.
//
// Replace the TPU kernels of src/repro/kernels/fused_iter/kernel.py:
//   update_q_dots_pallas  (_update_q_kernel):  q = r - st(a)*s;            <q,y>, <y,y>
//   update_xr_dots_pallas (_update_xr_kernel): x' = (x + st(a)*p) + st(w)*q,
//                                              r' = q - st(w)*y;           <r0,r'>, <r',r'>
//   update_p_pallas       (_update_p_kernel):  p' = r + st(b)*(p - st(w)*s)
//   dot_mixed_pallas      (_dot_kernel):       sum of f32(st(a*b))
// where st() rounds to the storage dtype.  The fused dots are taken in f32 from
// the upcast values; dot_mixed rounds each product to the storage dtype first
// (kernel.py:199).
//
// Bound: device-memory bytes.  Words moved per point: update_q_dots 4
// (r, s, y in; q out), update_xr_dots 7 (x, p, q, y, r0 in; x, r out),
// update_p 4, dot_mixed 2; a handful of flops each.  Design: one streaming
// pass per update, so each vector is read once and the dot partials come out
// of the same pass instead of another sweep; a fixed grid walks the vectors
// grid-stride, each thread sums in chunks, and the partial sums reduce
// without atomics (common.cuh), so the same inputs give the same bits on
// every run.  The scalars come in by device pointer to a 0-d f32 tensor and
// are rounded to storage here, so the solver loop never waits on the card to
// read them.
#include "common.cuh"

namespace repro {

#define GRID_STRIDE(i, n)                                                   \
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < (n); \
       i += (int64_t)gridDim.x * kThreads)

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
    update_q_dots_kernel(const float* __restrict__ alpha, const T* __restrict__ r,
                         const T* __restrict__ s, const T* __restrict__ y, T* __restrict__ q,
                         float* __restrict__ part, int64_t n) {
  const float a = rnd<T>(*alpha);
  ChunkedSum<2> acc;
  GRID_STRIDE(i, n) {
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
  const float a = rnd<T>(*alpha), w = rnd<T>(*omega);
  ChunkedSum<2> acc;
  GRID_STRIDE(i, n) {
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
  const float b = rnd<T>(*beta), w = rnd<T>(*omega);
  GRID_STRIDE(i, n) {
    po[i] = from_f<T>(add<T>(to_f(r[i]), mul<T>(b, sub<T>(to_f(p[i]), mul<T>(w, to_f(s[i]))))));
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    dot_mixed_kernel(const T* __restrict__ a, const T* __restrict__ b, float* __restrict__ part,
                     int64_t n) {
  ChunkedSum<1> acc;
  GRID_STRIDE(i, n) { acc.add({mul<T>(to_f(a[i]), to_f(b[i]))}); }
  store_partials<1>(acc, part);
}

#undef GRID_STRIDE

}  // namespace repro

extern "C" {

// Blocks of the partial-sum pass over n points: the scratch buffer of a
// dot-producing launch holds reduce_blocks(n) * n_dots floats.
int repro_reduce_blocks(long long n) { return repro::reduce_blocks(n); }

// Every entry point returns a cudaError_t code (0 on success).  `partials`
// is f32 scratch of repro_reduce_blocks(n) * n_dots floats; `out` receives
// the n_dots f32 sums.

int repro_update_q_dots(int dtype, const void* alpha, const void* r, const void* s,
                        const void* y, void* q, void* partials, void* out, long long n,
                        void* stream) {
  using namespace repro;
  if (n < 1) return (int)cudaErrorInvalidValue;
  const int nblk = reduce_blocks(n);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) {
    update_q_dots_kernel<float><<<nblk, kThreads, 0, st>>>(
        (const float*)alpha, (const float*)r, (const float*)s, (const float*)y, (float*)q,
        (float*)partials, n);
  } else if (dtype == kBF16) {
    update_q_dots_kernel<bf16><<<nblk, kThreads, 0, st>>>(
        (const float*)alpha, (const bf16*)r, (const bf16*)s, (const bf16*)y, (bf16*)q,
        (float*)partials, n);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  sum_partials<2><<<1, kThreads, 0, st>>>((const float*)partials, nblk, (float*)out);
  return (int)cudaGetLastError();
}

int repro_update_xr_dots(int dtype, const void* alpha, const void* omega, const void* x,
                         const void* p, const void* q, const void* y, const void* r0, void* xo,
                         void* ro, void* partials, void* out, long long n, void* stream) {
  using namespace repro;
  if (n < 1) return (int)cudaErrorInvalidValue;
  const int nblk = reduce_blocks(n);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) {
    update_xr_dots_kernel<float><<<nblk, kThreads, 0, st>>>(
        (const float*)alpha, (const float*)omega, (const float*)x, (const float*)p,
        (const float*)q, (const float*)y, (const float*)r0, (float*)xo, (float*)ro,
        (float*)partials, n);
  } else if (dtype == kBF16) {
    update_xr_dots_kernel<bf16><<<nblk, kThreads, 0, st>>>(
        (const float*)alpha, (const float*)omega, (const bf16*)x, (const bf16*)p,
        (const bf16*)q, (const bf16*)y, (const bf16*)r0, (bf16*)xo, (bf16*)ro,
        (float*)partials, n);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  sum_partials<2><<<1, kThreads, 0, st>>>((const float*)partials, nblk, (float*)out);
  return (int)cudaGetLastError();
}

int repro_update_p(int dtype, const void* beta, const void* omega, const void* r, const void* p,
                   const void* s, void* po, long long n, void* stream) {
  using namespace repro;
  if (n < 1) return (int)cudaErrorInvalidValue;
  const int nblk = reduce_blocks(n);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) {
    update_p_kernel<float><<<nblk, kThreads, 0, st>>>(
        (const float*)beta, (const float*)omega, (const float*)r, (const float*)p,
        (const float*)s, (float*)po, n);
  } else if (dtype == kBF16) {
    update_p_kernel<bf16><<<nblk, kThreads, 0, st>>>(
        (const float*)beta, (const float*)omega, (const bf16*)r, (const bf16*)p,
        (const bf16*)s, (bf16*)po, n);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int repro_dot_mixed(int dtype, const void* a, const void* b, void* partials, void* out,
                    long long n, void* stream) {
  using namespace repro;
  if (n < 1) return (int)cudaErrorInvalidValue;
  const int nblk = reduce_blocks(n);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) {
    dot_mixed_kernel<float><<<nblk, kThreads, 0, st>>>((const float*)a, (const float*)b,
                                                       (float*)partials, n);
  } else if (dtype == kBF16) {
    dot_mixed_kernel<bf16><<<nblk, kThreads, 0, st>>>((const bf16*)a, (const bf16*)b,
                                                      (float*)partials, n);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  sum_partials<1><<<1, kThreads, 0, st>>>((const float*)partials, nblk, (float*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
