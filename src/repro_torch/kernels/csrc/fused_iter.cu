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
// of the same pass instead of another sweep; each thread sums in chunks, and
// the partial sums reduce without atomics (common.cuh), so the same inputs
// give the same bits on every run.  What holds a streaming pass below its
// bound on this card is bytes in flight: one 2-byte load of each operand
// per thread per step, on a grid of half the card's threads, puts under a
// megabyte in flight, which keeps such a pass under two thirds of its byte
// bound; a few MB are needed.  So every pass takes a grid that fills the
// card and moves every operand and output in 16-B groups (below).  The
// scalars come in by device pointer to f32 tensors and are rounded to
// storage here, so the solver loop never waits on the card to read them.
//
// Batch: the B right-hand sides lie back to back, n points each, and the grid
// is (blocks(n), B), with blockIdx.y the RHS, which reads its own scalars
// alpha[b] (omega[b], beta[b]).  Each RHS runs the very grid, chunks and
// block tree of a lone vector, and sum_partials gives it one block of its
// own, so every RHS's outputs, dots included, equal the unbatched launch on
// that slice bit for bit.  The unbatched launch is the batched one with B = 1.
#include "common.cuh"

namespace repro {

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

// the G elements of a 16-B group as f32, and back (values exact in T)
template <typename T>
__device__ __forceinline__ void unpack(const uint4& g, float (&v)[16 / sizeof(T)]) {
  const uint32_t w[4] = {g.x, g.y, g.z, g.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if constexpr (sizeof(T) == 4) {
      v[k] = __uint_as_float(w[k]);
    } else {
      v[2 * k] = __uint_as_float(w[k] << 16);
      v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  }
}

template <typename T>
__device__ __forceinline__ uint4 pack(const float (&v)[16 / sizeof(T)]) {
  uint32_t w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if constexpr (sizeof(T) == 4) w[k] = __float_as_uint(v[k]);
    else w[k] = (__float_as_uint(v[2 * k]) >> 16) | (__float_as_uint(v[2 * k + 1]) & 0xffff0000u);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
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
  return pack<T>(v);
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

// update_q_dots, update_xr_dots and update_p: dot_mixed's groups, loaded
// and stored whole.  The grid fills the card (kStreamMinBlocks blocks of
// kThreads on each SM); thread t takes groups t, t + S, t + 2S, ... (S the
// grid's threads), loading kStepGroups of them, each a 16-B group of every
// operand, before it works on any: 96 B in flight per thread for the
// three-operand passes (about 13 MB on the card), 160 B for update_xr_dots'
// five.  The caller picks each launch's form: the wide one needs n a whole
// number of groups and every operand and output on a 16-B boundary (the
// entry points refuse it otherwise); the element-wise form (Wide = false)
// loads the same groups element by element (zero-padded) and stores only
// the elements i < n.  The dots follow the groups: each group's G products
// sum in a fixed tree, a thread's group sums in chunks of kChunk, the
// blocks' partials in sum_partials, so their order depends on n and the
// group index alone, never on the addresses or on the step depth.  The step
// depth and blocks per SM were chosen by timing variants in turns on one
// card (scripts/kernel_variants.py, PERF.md): evict-first hints
// (__ldcs/__stcs) on these read-once vectors were slower, and two groups a
// step need more than 32 registers.  update_xr_dots fits 64 registers at
// two groups a step without a spill, and ran no faster at one; at 3 blocks
// an SM it was 8% slower, and at 8 it spilled.
constexpr int kStepGroups = 2;         // groups of each operand per thread per step
constexpr int kStreamMinBlocks = 4;    // resident blocks per SM: 64 registers a thread

inline int stream_blocks(long long n) {
  const long long b = (n + kThreads * 8 - 1) / (kThreads * 8), cap = kStreamMinBlocks * 132LL;
  return (int)(b < cap ? b : cap);
}

// group j of p: one 16-B store when Wide, else the elements i < n one by one
template <typename T, bool Wide>
__device__ __forceinline__ void store_group(T* p, uint32_t j, int64_t n, const uint4& v) {
  constexpr int G = 16 / (int)sizeof(T);
  if constexpr (Wide) {
    reinterpret_cast<uint4*>(p)[j] = v;
  } else {
    float e[G];
    unpack<T>(v, e);
#pragma unroll
    for (int k = 0; k < G; ++k) {
      const int64_t i = (int64_t)j * G + k;
      if (i < n) p[i] = from_f<T>(e[k]);
    }
  }
}

// pairwise sum of G values in a fixed tree
template <int G>
__device__ __forceinline__ float tree_sum(const float* v) {
  if constexpr (G == 1) return v[0];
  else return __fadd_rn(tree_sum<G / 2>(v), tree_sum<G / 2>(v + G / 2));
}

// Walk one RHS's groups of the NI operands in `in`, kStepGroups groups of
// each a step; f(groups, j) takes the NI groups of index j, in the order
// j = t, t + S, t + 2S, ...
template <typename T, bool Wide, int NI, typename F>
__device__ __forceinline__ void stream_groups(const T* const (&in)[NI], int64_t n, F&& f) {
  constexpr int G = 16 / (int)sizeof(T);
  const uint32_t ng = (uint32_t)((n + G - 1) / G), stride = gridDim.x * kThreads;
  uint32_t j = blockIdx.x * kThreads + threadIdx.x;
  for (; j + (kStepGroups - 1) * stride < ng; j += kStepGroups * stride) {
    uint4 g[kStepGroups][NI];
#pragma unroll
    for (int u = 0; u < kStepGroups; ++u)
#pragma unroll
      for (int k = 0; k < NI; ++k) g[u][k] = load_group(in[k], j + u * stride, n, Wide);
#pragma unroll
    for (int u = 0; u < kStepGroups; ++u) f(g[u], j + u * stride);
  }
  for (; j < ng; j += stride) {
    uint4 g[NI];
#pragma unroll
    for (int k = 0; k < NI; ++k) g[k] = load_group(in[k], j, n, Wide);
    f(g, j);
  }
}

template <typename T, bool Wide>
__global__ void __launch_bounds__(kThreads, kStreamMinBlocks)
    update_q_dots_kernel(const float* __restrict__ alpha, const T* __restrict__ r,
                         const T* __restrict__ s, const T* __restrict__ y, T* __restrict__ q,
                         float* __restrict__ part, int64_t n) {
  constexpr int G = 16 / (int)sizeof(T);
  const int64_t off = (int64_t)blockIdx.y * n;
  const T* const in[3] = {r + off, s + off, y + off};
  q += off;
  part += (int64_t)blockIdx.y * gridDim.x * 2;
  const float a = rnd<T>(alpha[blockIdx.y]);
  ChunkedSum<2> acc;
  stream_groups<T, Wide>(in, n, [&](const uint4 (&g)[3], uint32_t j) {
    float rv[G], sv[G], yv[G], qy[G], yy[G];
    unpack<T>(g[0], rv);
    unpack<T>(g[1], sv);
    unpack<T>(g[2], yv);
#pragma unroll
    for (int k = 0; k < G; ++k) {
      rv[k] = sub<T>(rv[k], mul<T>(a, sv[k]));   // q
      qy[k] = __fmul_rn(rv[k], yv[k]);
      yy[k] = __fmul_rn(yv[k], yv[k]);
    }
    store_group<T, Wide>(q, j, n, pack<T>(rv));
    acc.add({tree_sum<G>(qy), tree_sum<G>(yy)});
  });
  store_partials<2>(acc, part);
}

// x' = (x + st(a) p) + st(w) q and r' = q - st(w) y, each op rounded to T
// as written; the dots take the rounded r'.
template <typename T, bool Wide>
__global__ void __launch_bounds__(kThreads, kStreamMinBlocks)
    update_xr_dots_kernel(const float* __restrict__ alpha, const float* __restrict__ omega,
                          const T* __restrict__ x, const T* __restrict__ p,
                          const T* __restrict__ q, const T* __restrict__ y,
                          const T* __restrict__ r0, T* __restrict__ xo, T* __restrict__ ro,
                          float* __restrict__ part, int64_t n) {
  constexpr int G = 16 / (int)sizeof(T);
  const int64_t off = (int64_t)blockIdx.y * n;
  const T* const in[5] = {x + off, p + off, q + off, y + off, r0 + off};
  xo += off, ro += off;
  part += (int64_t)blockIdx.y * gridDim.x * 2;
  const float a = rnd<T>(alpha[blockIdx.y]), w = rnd<T>(omega[blockIdx.y]);
  ChunkedSum<2> acc;
  stream_groups<T, Wide>(in, n, [&](const uint4 (&g)[5], uint32_t j) {
    float xv[G], pv[G], qv[G], yv[G], r0v[G];
    unpack<T>(g[0], xv);
    unpack<T>(g[1], pv);
    unpack<T>(g[2], qv);
    unpack<T>(g[3], yv);
    unpack<T>(g[4], r0v);
#pragma unroll
    for (int k = 0; k < G; ++k) {
      xv[k] = add<T>(add<T>(xv[k], mul<T>(a, pv[k])), mul<T>(w, qv[k]));   // x'
      qv[k] = sub<T>(qv[k], mul<T>(w, yv[k]));                              // r'
      pv[k] = __fmul_rn(r0v[k], qv[k]);
      yv[k] = __fmul_rn(qv[k], qv[k]);
    }
    store_group<T, Wide>(xo, j, n, pack<T>(xv));
    store_group<T, Wide>(ro, j, n, pack<T>(qv));
    acc.add({tree_sum<G>(pv), tree_sum<G>(yv)});
  });
  store_partials<2>(acc, part);
}

template <typename T, bool Wide>
__global__ void __launch_bounds__(kThreads, kStreamMinBlocks)
    update_p_kernel(const float* __restrict__ beta, const float* __restrict__ omega,
                    const T* __restrict__ r, const T* __restrict__ p, const T* __restrict__ s,
                    T* __restrict__ po, int64_t n) {
  constexpr int G = 16 / (int)sizeof(T);
  const int64_t off = (int64_t)blockIdx.y * n;
  const T* const in[3] = {r + off, p + off, s + off};
  po += off;
  const float b = rnd<T>(beta[blockIdx.y]), w = rnd<T>(omega[blockIdx.y]);
  stream_groups<T, Wide>(in, n, [&](const uint4 (&g)[3], uint32_t j) {
    float rv[G], pv[G], sv[G];
    unpack<T>(g[0], rv);
    unpack<T>(g[1], pv);
    unpack<T>(g[2], sv);
#pragma unroll
    for (int k = 0; k < G; ++k) rv[k] = add<T>(rv[k], mul<T>(b, sub<T>(pv[k], mul<T>(w, sv[k]))));
    store_group<T, Wide>(po, j, n, pack<T>(rv));
  });
}

// Where the wide form holds: n a whole number of groups and every operand
// and output on a 16-B boundary.
template <typename T, typename... P>
inline bool wide_groups(long long n, const P*... ptrs) {
  return n % (16 / (long long)sizeof(T)) == 0 && (((((uintptr_t)ptrs) & 15) == 0) && ...);
}

// Each launcher runs the form `wide` names, and refuses a wide form that
// does not hold (a 16-B access off its boundary would fault).
template <typename T>
int launch_update_q_dots(dim3 grid, cudaStream_t st, int wide, const void* alpha, const void* r,
                         const void* s, const void* y, void* q, void* part, long long n) {
  auto* a = (const float*)alpha;
  auto *rp = (const T*)r, *sp = (const T*)s, *yp = (const T*)y;
  if (wide && !wide_groups<T>(n, r, s, y, q)) return (int)cudaErrorInvalidValue;
  if (wide)
    update_q_dots_kernel<T, true><<<grid, kThreads, 0, st>>>(a, rp, sp, yp, (T*)q, (float*)part, n);
  else
    update_q_dots_kernel<T, false><<<grid, kThreads, 0, st>>>(a, rp, sp, yp, (T*)q, (float*)part, n);
  return 0;
}

template <typename T>
int launch_update_xr_dots(dim3 grid, cudaStream_t st, int wide, const void* alpha,
                          const void* omega, const void* x, const void* p, const void* q,
                          const void* y, const void* r0, void* xo, void* ro, void* part,
                          long long n) {
  auto *a = (const float*)alpha, *w = (const float*)omega;
  auto *xp = (const T*)x, *pp = (const T*)p, *qp = (const T*)q, *yp = (const T*)y;
  auto* r0p = (const T*)r0;
  if (wide && !wide_groups<T>(n, x, p, q, y, r0, xo, ro)) return (int)cudaErrorInvalidValue;
  if (wide)
    update_xr_dots_kernel<T, true><<<grid, kThreads, 0, st>>>(a, w, xp, pp, qp, yp, r0p, (T*)xo,
                                                               (T*)ro, (float*)part, n);
  else
    update_xr_dots_kernel<T, false><<<grid, kThreads, 0, st>>>(a, w, xp, pp, qp, yp, r0p, (T*)xo,
                                                                (T*)ro, (float*)part, n);
  return 0;
}

template <typename T>
int launch_update_p(dim3 grid, cudaStream_t st, int wide, const void* beta, const void* omega,
                    const void* r, const void* p, const void* s, void* po, long long n) {
  auto *b = (const float*)beta, *w = (const float*)omega;
  auto *rp = (const T*)r, *pp = (const T*)p, *sp = (const T*)s;
  if (wide && !wide_groups<T>(n, r, p, s, po)) return (int)cudaErrorInvalidValue;
  if (wide)
    update_p_kernel<T, true><<<grid, kThreads, 0, st>>>(b, w, rp, pp, sp, (T*)po, n);
  else
    update_p_kernel<T, false><<<grid, kThreads, 0, st>>>(b, w, rp, pp, sp, (T*)po, n);
  return 0;
}

}  // namespace repro

extern "C" {

// Blocks of the partial-sum pass over n points, one query per pass that
// produces dots: the scratch buffer of such a launch holds
// B * repro_<pass>_blocks(n) * n_dots floats.
int repro_update_q_dots_blocks(long long n) { return repro::stream_blocks(n); }
int repro_update_xr_dots_blocks(long long n) { return repro::stream_blocks(n); }
int repro_dot_mixed_blocks(long long n) { return repro::dot_blocks(n); }

// Every entry point runs one pass over B right-hand sides of n points each,
// back to back, with B scalars of each kind (a 0-d scalar is B = 1), and
// returns a cudaError_t code (0 on success).  The group passes take `wide`,
// the form of the launch (1: 16-B groups, 0: element by element), and refuse
// a wide form where n % G != 0 or a pointer is off a 16-B boundary.
// `partials` is f32 scratch of
// B * repro_<pass>_blocks(n) * n_dots floats; `out` receives the n_dots x B
// f32 sums, dot-major.

#define REPRO_CHECK_SIZE(n, nb) \
  if ((n) < 1 || (nb) < 1 || (nb) > repro::kMaxBatch) return (int)cudaErrorInvalidValue

// the group passes index groups with 32 bits
#define REPRO_CHECK_GROUPS(dtype, n) \
  if (((n) + ((dtype) == repro::kF32 ? 3 : 7)) / ((dtype) == repro::kF32 ? 4 : 8) > 0x7fffffffLL) \
  return (int)cudaErrorInvalidValue

int repro_update_q_dots(int dtype, int wide, const void* alpha, const void* r, const void* s,
                        const void* y, void* q, void* partials, void* out, long long n,
                        long long nb, void* stream) {
  using namespace repro;
  REPRO_CHECK_SIZE(n, nb);
  REPRO_CHECK_GROUPS(dtype, n);
  const dim3 grid(stream_blocks(n), (unsigned)nb);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int e = dtype == kF32 ? launch_update_q_dots<float>(grid, st, wide, alpha, r, s, y, q,
                                                            partials, n)
              : dtype == kBF16 ? launch_update_q_dots<bf16>(grid, st, wide, alpha, r, s, y, q,
                                                            partials, n)
              : (int)cudaErrorInvalidValue;
  if (e) return e;
  sum_partials<2><<<(unsigned)nb, kThreads, 0, st>>>((const float*)partials, grid.x, (float*)out);
  return (int)cudaGetLastError();
}

int repro_update_xr_dots(int dtype, int wide, const void* alpha, const void* omega,
                         const void* x, const void* p, const void* q, const void* y,
                         const void* r0, void* xo, void* ro, void* partials, void* out,
                         long long n, long long nb, void* stream) {
  using namespace repro;
  REPRO_CHECK_SIZE(n, nb);
  REPRO_CHECK_GROUPS(dtype, n);
  const dim3 grid(stream_blocks(n), (unsigned)nb);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int e = dtype == kF32 ? launch_update_xr_dots<float>(grid, st, wide, alpha, omega, x, p,
                                                             q, y, r0, xo, ro, partials, n)
              : dtype == kBF16 ? launch_update_xr_dots<bf16>(grid, st, wide, alpha, omega, x, p,
                                                             q, y, r0, xo, ro, partials, n)
              : (int)cudaErrorInvalidValue;
  if (e) return e;
  sum_partials<2><<<(unsigned)nb, kThreads, 0, st>>>((const float*)partials, grid.x, (float*)out);
  return (int)cudaGetLastError();
}

int repro_update_p(int dtype, int wide, const void* beta, const void* omega, const void* r,
                   const void* p, const void* s, void* po, long long n, long long nb,
                   void* stream) {
  using namespace repro;
  REPRO_CHECK_SIZE(n, nb);
  REPRO_CHECK_GROUPS(dtype, n);
  const dim3 grid(stream_blocks(n), (unsigned)nb);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int e = dtype == kF32 ? launch_update_p<float>(grid, st, wide, beta, omega, r, p, s, po, n)
              : dtype == kBF16 ? launch_update_p<bf16>(grid, st, wide, beta, omega, r, p, s, po, n)
              : (int)cudaErrorInvalidValue;
  if (e) return e;
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
#undef REPRO_CHECK_GROUPS

}  // extern "C"
