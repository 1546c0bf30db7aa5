// The 7-point stencil SpMV with an inner-product epilogue:
//   stencil7_dot:       s = A p,  <r0, s>
//   stencil7_two_dots:  y = A q,  <q, y>, <y, y>
//
// Replaces the TPU kernel src/repro/kernels/stencil_nd/fused.py:_call (body
// _kernel), reached through stencil7_dot and stencil7_two_dots; its only
// user is core/bicgstab.py:solve_ref_fused.
//
// Arithmetic: u = v + c_xp*v(x+1) + c_xm*v(x-1) + ... + c_zm*v(z-1), the terms
// in STAR7's canonical order (xp, xm, yp, ym, zp, zm), one rounding to the
// accumulation dtype per op (common.cuh), so with the same accumulation dtype
// u equals the stencil_nd kernel's bit for bit.  u is rounded to storage for
// the write, but the dots are taken from the unrounded accumulator, in f32,
// as the TPU kernel takes them (fused.py: uf = u.astype(f32) is the
// accumulator, before u_ref's cast): in bf16 storage the two differ.  w (r0
// or q itself) is read in storage and upcast.
//
// Bound: device-memory bytes.  Per point it reads the padded iterate, six
// coefficients and w, and writes u: 9 words (18 B in bf16) against ~14
// flops.  Design: the dot needs a reduction across the grid, so this kernel
// walks the points with the streaming passes' fixed grid (common.cuh), one
// thread per point per step of a grid-stride loop over the flat (x, y, z)
// index, Z fastest so neighbouring threads read neighbouring addresses; each
// thread sums its dot terms in chunks, blocks write partials, and one more
// block sums them in a fixed order: no atomics, the same bits on every run.
// The iterate is the r = 1 zero-padded copy the wrapper makes (F.pad), as the
// TPU wrapper pads before its pallas_call.
#include "common.cuh"

namespace repro {

template <typename T>
struct Stencil7DotArgs {
  const T* vp;        // (bx+2, by+2, Z+2), contiguous
  const T* w;         // (bx, by, Z): the dot's other operand
  const T* cf[6];     // xp, xm, yp, ym, zp, zm, each (bx, by, Z)
  T* u;               // (bx, by, Z)
  float* part;        // reduce_blocks(n) * ND partials
  int64_t by, z, n;
};

template <typename T, typename A, int ND>
__global__ void __launch_bounds__(kThreads) stencil7_dot_kernel(const Stencil7DotArgs<T> a) {
  const int64_t pz = a.z + 2, sx = (a.by + 2) * pz;   // padded strides of x and y
  const int64_t delta[6] = {sx, -sx, pz, -pz, 1, -1};
  ChunkedSum<ND> acc;
  REPRO_GRID_STRIDE(i, a.n) {
    const int64_t row = i / a.z, k = i - row * a.z;
    const int64_t x = row / a.by, y = row - x * a.by;
    const int64_t c = ((x + 1) * (a.by + 2) + (y + 1)) * pz + (k + 1);
    float u = rnd<A>(to_f(a.vp[c]));                 // unit main diagonal
#pragma unroll
    for (int t = 0; t < 6; ++t)
      u = add<A>(u, mul<A>(rnd<A>(to_f(a.cf[t][i])), rnd<A>(to_f(a.vp[c + delta[t]]))));
    a.u[i] = from_f<T>(u);
    const float wi = to_f(a.w[i]);
    if constexpr (ND == 1) {
      acc.add({__fmul_rn(wi, u)});
    } else {
      acc.add({__fmul_rn(wi, u), __fmul_rn(u, u)});
    }
  }
  store_partials<ND>(acc, a.part);
}

template <typename T, typename A>
static int launch(const void* vp, const void* w, const void* cf_ptrs, int n_dots, long long by,
                  long long z, long long n, void* u, void* partials, void* out,
                  cudaStream_t stream) {
  Stencil7DotArgs<T> a;
  a.vp = static_cast<const T*>(vp);
  a.w = static_cast<const T*>(w);
  const unsigned long long* cfp = static_cast<const unsigned long long*>(cf_ptrs);
  for (int t = 0; t < 6; ++t) a.cf[t] = reinterpret_cast<const T*>(cfp[t]);
  a.u = static_cast<T*>(u);
  a.part = static_cast<float*>(partials);
  a.by = by;
  a.z = z;
  a.n = n;
  const int nblk = reduce_blocks(n);
  if (n_dots == 1) {
    stencil7_dot_kernel<T, A, 1><<<nblk, kThreads, 0, stream>>>(a);
    sum_partials<1><<<1, kThreads, 0, stream>>>(a.part, nblk, static_cast<float*>(out));
  } else {
    stencil7_dot_kernel<T, A, 2><<<nblk, kThreads, 0, stream>>>(a);
    sum_partials<2><<<1, kThreads, 0, stream>>>(a.part, nblk, static_cast<float*>(out));
  }
  return (int)cudaGetLastError();
}

}  // namespace repro

extern "C" {

// u = A v on one block, v zero-padded by 1 (vp), plus n_dots f32 dots into
// out: <w, u> and, with n_dots == 2, <u, u>.  cf_ptrs: host array of the six
// coefficient fields' device pointers in STAR7 order; partials: f32 scratch
// of repro_reduce_blocks(bx * by * z) * n_dots floats.  Returns a cudaError_t
// code (0 on success).
int repro_stencil7_dot(int storage, int accum, const void* vp, const void* w,
                       const void* cf_ptrs, int n_dots, long long bx, long long by, long long z,
                       void* u, void* partials, void* out, void* stream) {
  using namespace repro;
  if ((n_dots != 1 && n_dots != 2) || bx < 1 || by < 1 || z < 1)
    return (int)cudaErrorInvalidValue;
  const long long n = bx * by * z;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (storage == kF32 && accum == kF32)
    return launch<float, float>(vp, w, cf_ptrs, n_dots, by, z, n, u, partials, out, s);
  if (storage == kF32 && accum == kBF16)
    return launch<float, bf16>(vp, w, cf_ptrs, n_dots, by, z, n, u, partials, out, s);
  if (storage == kBF16 && accum == kF32)
    return launch<bf16, float>(vp, w, cf_ptrs, n_dots, by, z, n, u, partials, out, s);
  if (storage == kBF16 && accum == kBF16)
    return launch<bf16, bf16>(vp, w, cf_ptrs, n_dots, by, z, n, u, partials, out, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
