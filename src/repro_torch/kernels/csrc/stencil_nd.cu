// Stencil SpMV for any star/box spec of the family: u = v + sum_i c_i * window(v_pad, off_i).
//
// Replaces the TPU kernel src/repro/kernels/stencil_nd/kernel.py:stencil_nd_pallas,
// its unbatched body _kernel and its batched (many-RHS) body _kernel_batched.
//
// Bound: device-memory bytes.  Each output point reads its n_off coefficients
// and the padded iterate once and writes u once; star7 moves 8 words per point
// (16 B in bf16) against 12 flops, far below the card's operations-per-byte
// line.  Design: one thread per output point, Z (the contiguous axis) across
// the threads of a block so neighbouring threads touch neighbouring addresses;
// the x/y neighbours of a point are read from rows the blocks of nearby x/y
// rows also read, which the 50 MB L2 keeps close.  Terms accumulate in the
// canonical offset order, one rounding per op (see common.cuh), so the output
// equals the plain PyTorch version bit for bit.  Indices are int64: the padded
// paper block has 572 M elements.
//
// The kernel reads the r-padded block that core.halo.gather_halo produces, so
// the multi-rank halo exchange feeds it unchanged.
//
// Batched form (B right-hand sides, one launch): the same grid, and each
// thread loads its point's n_off coefficients once into registers, then
// walks the RHS in chunks of kChunkB, reading each vp[b]'s window and writing
// u[b].  The coefficient fields are read once per SpMV, not B times: that
// sharing is the point of the TPU design too (its coefficient BlockSpec
// ignores the batch index).  The per-element arithmetic is the unbatched
// kernel's, so each slice of the output equals the unbatched kernel on that
// slice bit for bit.
#include "common.cuh"

namespace repro {

constexpr int kMaxOffsets = 32;
constexpr int kStencilTZ = 128;   // threads of a block, all along Z

template <typename T>
struct StencilArgs {
  const T* vp;                    // (bx+2r, by+2r, Z+2r), contiguous
  T* u;                           // (bx, by, Z), contiguous
  const T* cf[kMaxOffsets];       // n_off coefficient fields, each (bx, by, Z)
  int off[kMaxOffsets][3];
  int n_off, r, by;
  int64_t z;
};

// T: storage dtype; A: accumulation dtype
template <typename T, typename A>
__global__ void __launch_bounds__(kStencilTZ) stencil_nd_kernel(const StencilArgs<T> a) {
  const int64_t k = (int64_t)blockIdx.y * kStencilTZ + threadIdx.x;
  if (k >= a.z) return;
  const int row = blockIdx.x;                    // i * by + j
  const int i = row / a.by, j = row - i * a.by;
  const int64_t py = a.by + 2 * a.r, pz = a.z + 2 * a.r;
  const int64_t c = ((int64_t)(i + a.r) * py + (j + a.r)) * pz + (k + a.r);
  const int64_t o = (int64_t)row * a.z + k;
  float acc = rnd<A>(to_f(a.vp[c]));           // unit main diagonal
  for (int t = 0; t < a.n_off; ++t) {
    const int64_t src = c + ((int64_t)a.off[t][0] * py + a.off[t][1]) * pz + a.off[t][2];
    acc = add<A>(acc, mul<A>(rnd<A>(to_f(a.cf[t][o])), rnd<A>(to_f(a.vp[src]))));
  }
  a.u[o] = from_f<T>(acc);
}

template <typename T, typename A>
static int launch(const void* vp, const void* cf_ptrs, const int* offsets, int n_off, int r,
                  long long bx, long long by, long long z, void* u, cudaStream_t stream) {
  StencilArgs<T> a;
  a.vp = static_cast<const T*>(vp);
  a.u = static_cast<T*>(u);
  const unsigned long long* cfp = static_cast<const unsigned long long*>(cf_ptrs);
  for (int t = 0; t < n_off; ++t) {
    a.cf[t] = reinterpret_cast<const T*>(cfp[t]);
    for (int d = 0; d < 3; ++d) a.off[t][d] = offsets[3 * t + d];
  }
  a.n_off = n_off;
  a.r = r;
  a.by = (int)by;
  a.z = z;
  dim3 grid((unsigned)(bx * by), (unsigned)((z + kStencilTZ - 1) / kStencilTZ));
  stencil_nd_kernel<T, A><<<grid, kStencilTZ, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
struct StencilBatchedArgs {
  const T* vp;                    // (B, bx+2r, by+2r, Z+2r), contiguous
  T* u;                           // (B, bx, by, Z), contiguous
  const T* cf[kMaxOffsets];       // n_off coefficient fields, each (bx, by, Z)
  int64_t delta[kMaxOffsets];     // flat offset of term t's source from the centre
  int r, by, nb;
  int64_t z, vp_stride, u_stride; // per-RHS strides of vp and u
};

constexpr int kChunkB = 4;        // right-hand sides a thread carries at once

// NOFF: the offset count as a compile-time constant (the family's 6, 12, 24
// and 26), so the coefficients sit in exactly NOFF registers.  Terms run
// outer and the RHS of a chunk inner, and the chunk's outputs are stored at
// its end, so the loads of kChunkB right-hand sides are in flight together
// (a loop of whole RHS, each ending in its store, ran at half the speed of
// unbatched launches); each RHS still accumulates its terms in the
// canonical order.
template <typename T, typename A, int NOFF>
__global__ void __launch_bounds__(kStencilTZ)
    stencil_nd_batched_kernel(const StencilBatchedArgs<T> a) {
  const int64_t k = (int64_t)blockIdx.y * kStencilTZ + threadIdx.x;
  if (k >= a.z) return;
  const int row = blockIdx.x;                    // i * by + j
  const int i = row / a.by, j = row - i * a.by;
  const int64_t py = a.by + 2 * a.r, pz = a.z + 2 * a.r;
  const int64_t c = ((int64_t)(i + a.r) * py + (j + a.r)) * pz + (k + a.r);
  const int64_t o = (int64_t)row * a.z + k;
  float cf[NOFF];                                // the point's coefficients, for every RHS
#pragma unroll
  for (int t = 0; t < NOFF; ++t) cf[t] = rnd<A>(to_f(a.cf[t][o]));
  for (int b0 = 0; b0 < a.nb; b0 += kChunkB) {
    const int nc = a.nb - b0 < kChunkB ? a.nb - b0 : kChunkB;
    const T* __restrict__ vp = a.vp + b0 * a.vp_stride + c;
    float acc[kChunkB];
#pragma unroll
    for (int q = 0; q < kChunkB; ++q)            // unit main diagonal
      acc[q] = q < nc ? rnd<A>(to_f(vp[q * a.vp_stride])) : 0.0f;
#pragma unroll
    for (int t = 0; t < NOFF; ++t) {
#pragma unroll
      for (int q = 0; q < kChunkB; ++q)
        if (q < nc)
          acc[q] = add<A>(acc[q], mul<A>(cf[t], rnd<A>(to_f(vp[q * a.vp_stride + a.delta[t]]))));
    }
#pragma unroll
    for (int q = 0; q < kChunkB; ++q)
      if (q < nc) a.u[(b0 + q) * a.u_stride + o] = from_f<T>(acc[q]);
  }
}

template <typename T, typename A>
static int launch_batched(const void* vp, const void* cf_ptrs, const int* offsets, int n_off,
                          int r, long long nb, long long bx, long long by, long long z, void* u,
                          cudaStream_t stream) {
  StencilBatchedArgs<T> a;
  a.vp = static_cast<const T*>(vp);
  a.u = static_cast<T*>(u);
  const int64_t py = by + 2 * r, pz = z + 2 * r;
  const unsigned long long* cfp = static_cast<const unsigned long long*>(cf_ptrs);
  for (int t = 0; t < n_off; ++t) {
    a.cf[t] = reinterpret_cast<const T*>(cfp[t]);
    const int* off = offsets + 3 * t;
    a.delta[t] = ((int64_t)off[0] * py + off[1]) * pz + off[2];
  }
  a.r = r;
  a.by = (int)by;
  a.nb = (int)nb;
  a.z = z;
  a.vp_stride = (bx + 2 * r) * py * pz;
  a.u_stride = bx * by * z;
  dim3 grid((unsigned)(bx * by), (unsigned)((z + kStencilTZ - 1) / kStencilTZ));
  switch (n_off) {
    case 6: stencil_nd_batched_kernel<T, A, 6><<<grid, kStencilTZ, 0, stream>>>(a); break;
    case 12: stencil_nd_batched_kernel<T, A, 12><<<grid, kStencilTZ, 0, stream>>>(a); break;
    case 24: stencil_nd_batched_kernel<T, A, 24><<<grid, kStencilTZ, 0, stream>>>(a); break;
    case 26: stencil_nd_batched_kernel<T, A, 26><<<grid, kStencilTZ, 0, stream>>>(a); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace repro

extern "C" {

// u = A v on one r-padded block.  cf_ptrs: host array of n_off device
// pointers; offsets: host int32 array of n_off (dx, dy, dz) triples.
// Returns a cudaError_t code (0 on success).
int repro_stencil_nd(int storage, int accum, const void* vp, const void* cf_ptrs,
                     const void* offsets, int n_off, int radius, long long bx, long long by,
                     long long z, void* u, void* stream) {
  using namespace repro;
  if (n_off < 1 || n_off > kMaxOffsets || radius < 1 || bx < 1 || by < 1 || z < 1 ||
      bx * by > 0x7fffffffLL || (z + kStencilTZ - 1) / kStencilTZ > 65535)
    return (int)cudaErrorInvalidValue;
  const int* off = static_cast<const int*>(offsets);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (storage == kF32 && accum == kF32)
    return launch<float, float>(vp, cf_ptrs, off, n_off, radius, bx, by, z, u, s);
  if (storage == kF32 && accum == kBF16)
    return launch<float, bf16>(vp, cf_ptrs, off, n_off, radius, bx, by, z, u, s);
  if (storage == kBF16 && accum == kF32)
    return launch<bf16, float>(vp, cf_ptrs, off, n_off, radius, bx, by, z, u, s);
  if (storage == kBF16 && accum == kBF16)
    return launch<bf16, bf16>(vp, cf_ptrs, off, n_off, radius, bx, by, z, u, s);
  return (int)cudaErrorInvalidValue;
}

// u[b] = A vp[b] for B r-padded blocks back to back, in one launch; the
// other arguments as for repro_stencil_nd, with n_off one of the family's
// 6, 12, 24 or 26.
int repro_stencil_nd_batched(int storage, int accum, const void* vp, const void* cf_ptrs,
                             const void* offsets, int n_off, int radius, long long nb,
                             long long bx, long long by, long long z, void* u, void* stream) {
  using namespace repro;
  if (n_off < 1 || n_off > kMaxOffsets || radius < 1 || nb < 1 || nb > kMaxBatch || bx < 1 ||
      by < 1 || z < 1 || bx * by > 0x7fffffffLL || (z + kStencilTZ - 1) / kStencilTZ > 65535)
    return (int)cudaErrorInvalidValue;
  const int* off = static_cast<const int*>(offsets);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (storage == kF32 && accum == kF32)
    return launch_batched<float, float>(vp, cf_ptrs, off, n_off, radius, nb, bx, by, z, u, s);
  if (storage == kF32 && accum == kBF16)
    return launch_batched<float, bf16>(vp, cf_ptrs, off, n_off, radius, nb, bx, by, z, u, s);
  if (storage == kBF16 && accum == kF32)
    return launch_batched<bf16, float>(vp, cf_ptrs, off, n_off, radius, nb, bx, by, z, u, s);
  if (storage == kBF16 && accum == kBF16)
    return launch_batched<bf16, bf16>(vp, cf_ptrs, off, n_off, radius, nb, bx, by, z, u, s);
  return (int)cudaErrorInvalidValue;
}

const char* repro_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
