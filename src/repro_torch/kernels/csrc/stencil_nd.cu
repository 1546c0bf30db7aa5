// Stencil SpMV for the star/box family: u = v + sum_t c_t * window(v_pad, off_t),
// for one right-hand side or a batch of B sharing the coefficient fields.
//
// Replaces the TPU kernel src/repro/kernels/stencil_nd/kernel.py:stencil_nd_pallas,
// both its unbatched body _kernel and its batched body _kernel_batched: the
// unbatched launch is this kernel with B = 1.
//
// Bound: device-memory bytes.  Per output point and RHS the SpMV must read
// the n_off coefficients (shared by the RHS) and v once and write u once;
// star7 in bf16 moves 16 B per point against 12 flops, far below the card's
// operations-per-byte line.  A kernel with one thread per point fetches each
// v value once per tap (7 times for star7, 27 for box27) and the coefficients
// 2 B per load; this one reads each byte about once:
//
// * A block owns a (y, z) tile of 16 x 128 points in bf16 (16 x 64 in f32)
//   and marches it along x through a shared-memory ring of 2r+2 planes of
//   v, the next plane prefetched in registers; each thread computes one
//   16-B vector of z points (stencil_march.cuh, whose helpers and ring K6
//   in stencil7_dot.cu shares, describes the march, its staging and
//   alignment).
// * Batch: a block takes a chunk of NB right-hand sides (4 for radius 1, 2
//   for radius 2, 1 for radius 4, so the ring fits the shared-memory budget),
//   loads each tap's coefficients once and applies them to every RHS of the
//   chunk.
//
// Arithmetic: the unit main diagonal, then acc = acc + c_t * v[off_t] over
// the spec's canonical offsets (core/stencil.py), each op rounded to the
// accumulation dtype A, the result cast to storage T: the same per-point
// arithmetic as the plain PyTorch version, so every output equals it bit for
// bit, and each RHS of a batch equals the B = 1 launch on it (bf16 storage
// with bf16 accumulation runs on bf16 pairs, which give the same bits; see
// stencil_march.cuh).  The offsets are compile-time (the family's star r =
// 1, 2, 4 and box r = 1); the entry point checks that the caller's offsets
// are exactly those, in that order.
//
// Tiles, segments and the RHS chunk come from the caller
// (kernels/stencil_nd/kernel.py:launch_plan); the entry point checks them
// against the compiled tile.  The kernel reads the r-padded block that
// core/halo.py produces, so the multi-rank halo exchange feeds it unchanged,
// and it is right for blocks thinner than a tile in any axis (the overlap
// schedule's ring slabs, down to 1 x by x Z).
#include "stencil_march.cuh"

namespace repro {
namespace sten {

// the most RHS one block carries, by radius (the shared-memory ring's budget)
__host__ __device__ constexpr int max_chunk(int r) { return r == 1 ? 4 : r == 2 ? 2 : 1; }

struct Params {
  const void* vp;                 // (B, bx+2r, by+2r, Z+2r), contiguous
  void* u;                        // (B, bx, by, Z), contiguous
  const void* cf[26];             // n_off fields, each (bx, by, Z)
  int nb, bx, by, z;
  int seg_len, ntz;               // planes per segment; z tiles per tile row
  int wide;                       // fields and u 16-B aligned and Z % VZ == 0
  int64_t vp_stride, u_stride;    // per-RHS element strides
};

// Blocks per SM the register budget is set for: one RHS (64 registers; 4
// blocks keep twice the loads of 2 in flight, and on an H100 ran K1 at the
// paper mesh 1.3x faster) and a chunk of RHS (128 registers; its ring of 4
// RHS leaves room for 2 blocks anyway).
constexpr int kMinBlocks1 = 4, kMinBlocksN = 2;
constexpr int min_blocks(int nb) { return nb == 1 ? kMinBlocks1 : kMinBlocksN; }

template <typename T, typename A, int KIND, int R, int NB, bool PAIR>
__global__ void __launch_bounds__(kThreads, min_blocks(NB)) stencil_nd_kernel(const Params p) {
  using S = Spec<KIND, R>;
  using RawT = typename Raw<T>::type;
  constexpr int VZ = Tile<T>::VZ, TZ = Tile<T>::TZ, P = Tile<T>::P;
  constexpr int ROWS = kTY + 2 * R, W = TZ + 2 * R;  // staged rows and elements per row
  constexpr int SLOTS = 2 * R + 2;
  constexpr int SLOT = ROWS * P;                     // elements of one staged plane
  constexpr int QS = SLOTS * SLOT;                   // elements of one RHS's ring
  extern __shared__ __align__(16) unsigned char smem_raw[];
  RawT* sm = reinterpret_cast<RawT*>(smem_raw);     // [NB][SLOTS][ROWS][P]

  const int x0 = blockIdx.y * p.seg_len;
  if (x0 >= p.bx) return;
  const int x1 = min(p.bx, x0 + p.seg_len);
  const int tid = threadIdx.x, tz_t = tid % kTZT, ty_t = tid / kTZT;
  const int ty0 = (blockIdx.x / p.ntz) * kTY, tz0 = (blockIdx.x % p.ntz) * TZ;
  const int b0 = blockIdx.z * NB, nc = min(NB, p.nb - b0);
  const int py = p.by + 2 * R, pz = p.z + 2 * R;
  const int rows_ok = min(ROWS, py - ty0), cols_ok = min(W, pz - tz0);
  const RawT* vp = static_cast<const RawT*>(p.vp) + b0 * p.vp_stride;

  Stage<RawT, ROWS, W, P, NB, PAIR> stage;           // the plane being staged
  auto src_of = [&](int pp) { return vp + ((int64_t)pp * py + ty0) * pz + tz0; };

  Ring<R, SLOT, VZ, RawT, decltype(stage), decltype(src_of)> ring{
      stage, sm, src_of, p.vp_stride, pz, nc, QS, rows_ok, cols_ok, x1};
  ring.begin(x0);                                   // planes x0-r .. x0+r

  const int y = ty0 + ty_t, zt = tz0 + VZ * tz_t;
  const int nz = max(0, min(VZ, p.z - zt));
  const bool live = y < p.by && nz > 0, wide = p.wide && nz == VZ;
  const RawT* mine = sm + (ty_t + R) * P + VZ * (tz_t + 1);   // my points, slot 0, RHS 0
  T* const u = static_cast<T*>(p.u) + b0 * p.u_stride;

  for (int x = x0; x < x1; ++x) {
    ring.prefetch(x);
    if (live) {
      int slot[2 * R + 1];                          // element offset of interior plane x + dx
#pragma unroll
      for (int d = 0; d <= 2 * R; ++d) slot[d] = ring.slot(d);
      const int64_t o = ((int64_t)x * p.by + y) * p.z + zt;
      Acc<T, A> acc[NB];
#pragma unroll
      for (int q = 0; q < NB; ++q)                  // unit main diagonal
        if (q < nc) acc[q].init(window<T, 0>(mine + q * QS + slot[R]));
      static_for<0, S::kN>([&](auto tc) {
        constexpr int t = decltype(tc)::value;
        constexpr int dx = S::off(t, 0), dy = S::off(t, 1), dz = S::off(t, 2);
        const uint4 c = load_vec(static_cast<const T*>(p.cf[t]) + o, wide, nz);
#pragma unroll
        for (int q = 0; q < NB; ++q)
          if (q < nc) acc[q].mac(c, window<T, dz>(mine + q * QS + slot[R + dx] + dy * P));
      });
#pragma unroll
      for (int q = 0; q < NB; ++q)
        if (q < nc) store_vec(u + q * p.u_stride + o, acc[q].pack(), wide, nz);
    }
    ring.advance(x);
  }
}

template <typename T, typename A, int KIND, int R, int NB, bool PAIR>
static int launch(Params& p, int nc_max, int segments, cudaStream_t stream) {
  constexpr int QS = (2 * R + 2) * (kTY + 2 * R) * Tile<T>::P;
  const size_t smem = (size_t)nc_max * QS * sizeof(T);
  auto kern = stencil_nd_kernel<T, A, KIND, R, NB, PAIR>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int nty = (p.by + kTY - 1) / kTY;
  const dim3 grid((unsigned)(nty * p.ntz), (unsigned)segments,
                  (unsigned)((p.nb + NB - 1) / NB));
  kern<<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, typename A, int KIND, int R, bool PAIR>
static int dispatch_chunk(Params& p, int chunk, int segments, cudaStream_t s) {
  constexpr int M = max_chunk(R);
  const int nc_max = p.nb < chunk ? p.nb : chunk;
  if (chunk == 1) return launch<T, A, KIND, R, 1, PAIR>(p, nc_max, segments, s);
  if constexpr (M > 1) {
    if (chunk == M) return launch<T, A, KIND, R, M, PAIR>(p, nc_max, segments, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T, typename A, int KIND, int R>
static int dispatch_pair(Params& p, bool pair, int chunk, int segments, cudaStream_t s) {
  if constexpr (sizeof(T) == 2) {
    if (pair) return dispatch_chunk<T, A, KIND, R, true>(p, chunk, segments, s);
  }
  return dispatch_chunk<T, A, KIND, R, false>(p, chunk, segments, s);
}

template <typename T, typename A>
static int dispatch_spec(Params& p, int n_off, int r, bool pair, int chunk, int segments,
                         cudaStream_t s) {
  if (n_off == 6 && r == 1) return dispatch_pair<T, A, kStar, 1>(p, pair, chunk, segments, s);
  if (n_off == 12 && r == 2) return dispatch_pair<T, A, kStar, 2>(p, pair, chunk, segments, s);
  if (n_off == 24 && r == 4) return dispatch_pair<T, A, kStar, 4>(p, pair, chunk, segments, s);
  if (n_off == 26 && r == 1) return dispatch_pair<T, A, kBox, 1>(p, pair, chunk, segments, s);
  return (int)cudaErrorInvalidValue;
}

// the caller's offsets are exactly the family spec's, in canonical order
template <int KIND, int R>
static bool is_spec(const int* off) {
  for (int t = 0; t < Spec<KIND, R>::kN; ++t)
    for (int a = 0; a < 3; ++a)
      if (off[3 * t + a] != Spec<KIND, R>::off(t, a)) return false;
  return true;
}

static bool family_offsets(const int* off, int n_off, int r) {
  if (n_off == 6 && r == 1) return is_spec<kStar, 1>(off);
  if (n_off == 12 && r == 2) return is_spec<kStar, 2>(off);
  if (n_off == 24 && r == 4) return is_spec<kStar, 4>(off);
  if (n_off == 26 && r == 1) return is_spec<kBox, 1>(off);
  return false;
}

template <typename T, typename A>
static int run(const void* vp, const void* cf_ptrs, const int* off, int n_off, int r,
               long long nb, long long bx, long long by, long long z, void* u, int ty, int tz,
               int seg_len, int chunk, cudaStream_t s) {
  if (ty != kTY || tz != Tile<T>::TZ) return (int)cudaErrorInvalidValue;
  const long long ntz = (z + tz - 1) / tz, nty = (by + ty - 1) / ty;
  const long long segments = (bx + seg_len - 1) / seg_len;
  if (ntz * nty > 0x7fffffffLL || segments > 65535 || (nb + chunk - 1) / chunk > 65535)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.vp = vp;
  p.u = u;
  const unsigned long long* cfp = static_cast<const unsigned long long*>(cf_ptrs);
  bool wide = z % Tile<T>::VZ == 0 && aligned16(u);
  for (int t = 0; t < n_off; ++t) {
    p.cf[t] = reinterpret_cast<const void*>(cfp[t]);
    wide = wide && aligned16(p.cf[t]);
  }
  p.nb = (int)nb;
  p.bx = (int)bx;
  p.by = (int)by;
  p.z = (int)z;
  p.seg_len = seg_len;
  p.ntz = (int)ntz;
  p.wide = wide;
  p.vp_stride = (bx + 2 * r) * (by + 2 * r) * (z + 2 * r);
  p.u_stride = bx * by * z;
  // bf16 rows start 4-B aligned when the padded pitch Z + 2r is even
  const bool pair =
      sizeof(T) == 2 && (z + 2 * r) % 2 == 0 && (reinterpret_cast<uintptr_t>(vp) & 3) == 0;
  return dispatch_spec<T, A>(p, n_off, r, pair, chunk, (int)segments, s);
}

}  // namespace sten
}  // namespace repro

extern "C" {

// u[b] = A vp[b] for B r-padded blocks back to back, in one launch (B = 1:
// one block).  cf_ptrs: host array of n_off device pointers (the fields,
// shared by every RHS); offsets: host int32 array of n_off (dx, dy, dz)
// triples, which must be a family spec's canonical offsets (star7, star13,
// star25, box27).  The tile (ty x tz), the x segment length and the RHS
// chunk come from kernels/stencil_nd/kernel.py:launch_plan.  Returns a
// cudaError_t code (0 on success).
int repro_stencil_nd(int storage, int accum, const void* vp, const void* cf_ptrs,
                     const void* offsets, int n_off, int radius, long long nb, long long bx,
                     long long by, long long z, void* u, int ty, int tz, int seg_len, int chunk,
                     void* stream) {
  using namespace repro;
  using namespace repro::sten;
  const int* off = static_cast<const int*>(offsets);
  if (nb < 1 || nb > kMaxBatch || bx < 1 || by < 1 || z < 1 || bx > 0x7fffffffLL ||
      (by + 2 * radius) * (z + 2 * radius) > 0x7fffffffLL || seg_len < 1 || chunk < 1 ||
      !family_offsets(off, n_off, radius))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (storage == kF32 && accum == kF32)
    return run<float, float>(vp, cf_ptrs, off, n_off, radius, nb, bx, by, z, u, ty, tz,
                             seg_len, chunk, s);
  if (storage == kF32 && accum == kBF16)
    return run<float, bf16>(vp, cf_ptrs, off, n_off, radius, nb, bx, by, z, u, ty, tz,
                            seg_len, chunk, s);
  if (storage == kBF16 && accum == kF32)
    return run<bf16, float>(vp, cf_ptrs, off, n_off, radius, nb, bx, by, z, u, ty, tz,
                            seg_len, chunk, s);
  if (storage == kBF16 && accum == kBF16)
    return run<bf16, bf16>(vp, cf_ptrs, off, n_off, radius, nb, bx, by, z, u, ty, tz,
                           seg_len, chunk, s);
  return (int)cudaErrorInvalidValue;
}

const char* repro_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
