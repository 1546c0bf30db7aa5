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
// accumulator, before u_ref's cast): in bf16 storage the two differ.  w (r0,
// or q itself) is read in storage and upcast.
//
// Bound: device-memory bytes.  Per point it reads the padded iterate, six
// coefficients and w, and writes u: 9 words (18 B in bf16) against 14-16 flops.
// In the two-dot variant w is the iterate itself (w = q, vp = pad(q)) and is
// not read again: 8 words.  Design: K1's x-march (stencil_march.cuh).  A
// block takes a 16 x 128 (y, z) tile in bf16 (16 x 64 in f32) and one x
// segment, both from kernels/stencil_nd/kernel.py:launch_plan, and marches
// it through a ring of 4 planes of v in shared memory; each thread computes
// one 16-B vector of z points a plane, writes u as one 16-B store, reads w
// as one 16-B load beside the coefficients (the two-dot variant takes it as
// the centre window of the ring), and adds its points' dot terms to chunked
// f32 sums.
// Lanes past Z and rows past the block add nothing, so staged halo values
// never reach a dot.  At the segment's end the block sums its threads in a
// fixed tree and writes one partial per dot at (segment, tile); every block
// writes, whatever its segment.  One more block sums the partials in a fixed
// order: no atomics, so a run repeats bit for bit, and the dots' order
// depends only on the shape (through the plan).
//
// The iterate is the r = 1 zero-padded copy the wrapper makes (F.pad), as the
// TPU wrapper pads before its pallas_call.
#include "stencil_march.cuh"

namespace repro {
namespace sten {

struct DotParams {
  const void* vp;       // (bx+2, by+2, Z+2), contiguous
  const void* w;        // (bx, by, Z) for one dot; null for two: w is the interior of vp
  const void* cf[6];    // xp, xm, yp, ym, zp, zm, each (bx, by, Z)
  void* u;              // (bx, by, Z)
  float* part;          // one partial per block and dot, block-major
  int bx, by, z;
  int seg_len, ntz;     // planes per segment; z tiles per tile row
  int wide;             // w, the fields and u 16-B aligned and Z % VZ == 0
};

// Blocks per SM the register budget is set for: 3 (80 registers a thread).
// K1's budget of 4 (64 registers) spilled 52-80 B in 8 instances and ran
// 1.15-1.24x slower on an H100, 2 blocks (128 registers) 1.13-1.19x slower
// (scripts/kernel_variants.py stencil7_dot): the f32 accumulators and the
// dot sums need the room, and 3 blocks keep enough loads in flight.
constexpr int kMinBlocksDot = 3;

// ND dots (<w,u>; <w,u> and <u,u> with w the centre of the ring's plane,
// the iterate itself).  The march is K1's (stencil_nd.cu: stencil_nd_kernel,
// with the same Ring) at r = 1 for one RHS; bf16 is always staged in pairs,
// loaded 4 B at a time when the padded rows start 4-B aligned (ALIGNED4)
// and 2 B at a time otherwise.
template <typename T, typename A, int ND, bool ALIGNED4>
__global__ void __launch_bounds__(kThreads, kMinBlocksDot) stencil7_dot_kernel(const DotParams p) {
  using S = Spec<kStar, 1>;
  using RawT = typename Raw<T>::type;
  constexpr int VZ = Tile<T>::VZ, TZ = Tile<T>::TZ, P = Tile<T>::P;
  constexpr int ROWS = kTY + 2, W = TZ + 2;          // staged rows and elements per row
  constexpr int SLOT = ROWS * P;                     // elements of one staged plane
  constexpr int kRuns = kChunk / VZ;                 // planes per chunk of the dot sums
  extern __shared__ __align__(16) unsigned char smem_raw[];
  RawT* sm = reinterpret_cast<RawT*>(smem_raw);     // the ring: [4][ROWS][P]

  ChunkedSum<ND> dots;
  const int x0 = blockIdx.y * p.seg_len;
  if (x0 < p.bx) {   // a segment past bx (none in a plan) still writes zero partials
    const int x1 = min(p.bx, x0 + p.seg_len);
    const int tid = threadIdx.x, tz_t = tid % kTZT, ty_t = tid / kTZT;
    const int ty0 = (blockIdx.x / p.ntz) * kTY, tz0 = (blockIdx.x % p.ntz) * TZ;
    const int py = p.by + 2, pz = p.z + 2;
    const int rows_ok = min(ROWS, py - ty0), cols_ok = min(W, pz - tz0);
    const RawT* vp = static_cast<const RawT*>(p.vp);

    constexpr bool PAIR = sizeof(T) == 2;
    Stage<RawT, ROWS, W, P, 1, PAIR, PAIR && !ALIGNED4> stage;   // the plane being staged
    auto src_of = [&](int pp) { return vp + ((int64_t)pp * py + ty0) * pz + tz0; };

    Ring<1, SLOT, VZ, RawT, decltype(stage), decltype(src_of)> ring{
        stage, sm, src_of, 0, pz, 1, 0, rows_ok, cols_ok, x1};
    ring.begin(x0);                                 // planes x0-1 .. x0+1

    const int y = ty0 + ty_t, zt = tz0 + VZ * tz_t;
    const int nz = max(0, min(VZ, p.z - zt));
    const bool live = y < p.by && nz > 0, wide = p.wide && nz == VZ;
    const RawT* mine = sm + (ty_t + 1) * P + VZ * (tz_t + 1);   // my points, slot 0

    for (int x = x0; x < x1; ++x) {
      ring.prefetch(x);
      if (live) {   // rows past by and lanes past Z add nothing to the dots
        int slot[3];                                // element offset of interior plane x + dx
#pragma unroll
        for (int d = 0; d <= 2; ++d) slot[d] = ring.slot(d);
        const int64_t o = ((int64_t)x * p.by + y) * p.z + zt;
        Acc<T, A> acc;
        acc.init(window<T, 0>(mine + slot[1]));   // unit main diagonal
        static_for<0, S::kN>([&](auto tc) {
          constexpr int t = decltype(tc)::value;
          constexpr int dx = S::off(t, 0), dy = S::off(t, 1), dz = S::off(t, 2);
          acc.mac(load_vec(static_cast<const T*>(p.cf[t]) + o, wide, nz),
                  window<T, dz>(mine + slot[1 + dx] + dy * P));
        });
        store_vec(static_cast<T*>(p.u) + o, acc.pack(), wide, nz);
        uint4 wv;
        if constexpr (ND == 2) wv = window<T, 0>(mine + slot[1]);
        else wv = load_vec(static_cast<const T*>(p.w) + o, wide, nz);
        float term[VZ][ND];
#pragma unroll
        for (int k = 0; k < VZ; ++k) {
          const float uk = acc.value(k);
          term[k][0] = k < nz ? __fmul_rn(elem<T>(wv, k), uk) : 0.0f;
          if constexpr (ND == 2) term[k][1] = k < nz ? __fmul_rn(uk, uk) : 0.0f;
        }
        dots.add_run(term);
        if ((unsigned)(x - x0) % kRuns == kRuns - 1) dots.flush();   // every kChunk terms
      }
      ring.advance(x);
    }
  }
  float v[ND];
  dots.total(v);
  block_sum<ND>(v);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int d = 0; d < ND; ++d)
      p.part[((int64_t)blockIdx.y * gridDim.x + blockIdx.x) * ND + d] = v[d];
  }
}

template <typename T, typename A, int ND, bool ALIGNED4>
static int launch(const DotParams& p, int nty, int segments, long long nblk, void* out,
                  cudaStream_t stream) {
  constexpr size_t smem = (size_t)4 * (kTY + 2) * Tile<T>::P * sizeof(T);   // the ring
  static_assert(smem <= 48 * 1024, "the ring fits the default shared-memory limit");
  const dim3 grid((unsigned)(nty * p.ntz), (unsigned)segments);
  stencil7_dot_kernel<T, A, ND, ALIGNED4><<<grid, kThreads, smem, stream>>>(p);
  sum_partials<ND><<<1, kThreads, 0, stream>>>(p.part, (int)nblk, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

template <typename T, typename A, bool ALIGNED4>
static int dispatch_dots(const DotParams& p, int n_dots, int nty, int segments, long long nblk,
                         void* out, cudaStream_t s) {
  if (n_dots == 1) return launch<T, A, 1, ALIGNED4>(p, nty, segments, nblk, out, s);
  return launch<T, A, 2, ALIGNED4>(p, nty, segments, nblk, out, s);
}

template <typename T, typename A>
static int run(const void* vp, const void* w, const void* cf_ptrs, int n_dots, long long bx,
               long long by, long long z, void* u, int ty, int tz, int seg_len, long long nblk,
               void* partials, void* out, cudaStream_t s) {
  if (ty != kTY || tz != Tile<T>::TZ) return (int)cudaErrorInvalidValue;
  const long long ntz = (z + tz - 1) / tz, nty = (by + ty - 1) / ty;
  const long long segments = (bx + seg_len - 1) / seg_len;
  if (ntz * nty > 0x7fffffffLL || segments > 65535) return (int)cudaErrorInvalidValue;
  // the caller's scratch holds one partial per block of this grid, no more, no fewer
  if (nblk != nty * ntz * segments || nblk > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  DotParams p;
  p.vp = vp;
  p.w = w;
  p.u = u;
  p.part = static_cast<float*>(partials);
  const unsigned long long* cfp = static_cast<const unsigned long long*>(cf_ptrs);
  bool wide = z % Tile<T>::VZ == 0 && aligned16(u) && (w == nullptr || aligned16(w));
  for (int t = 0; t < 6; ++t) {
    p.cf[t] = reinterpret_cast<const void*>(cfp[t]);
    wide = wide && aligned16(p.cf[t]);
  }
  p.bx = (int)bx;
  p.by = (int)by;
  p.z = (int)z;
  p.seg_len = seg_len;
  p.ntz = (int)ntz;
  p.wide = wide;
  // bf16 rows start 4-B aligned when the padded pitch Z + 2 is even
  const bool aligned4 =
      sizeof(T) == 2 && (z + 2) % 2 == 0 && (reinterpret_cast<uintptr_t>(vp) & 3) == 0;
  if constexpr (sizeof(T) == 2) {
    if (aligned4)
      return dispatch_dots<T, A, true>(p, n_dots, (int)nty, (int)segments, nblk, out, s);
  }
  return dispatch_dots<T, A, false>(p, n_dots, (int)nty, (int)segments, nblk, out, s);
}

}  // namespace sten
}  // namespace repro

extern "C" {

// u = A v on one block, v zero-padded by 1 (vp), plus n_dots f32 dots into
// out: <w, u> and, with n_dots == 2, <u, u>.  With n_dots == 2, w must be
// NULL: w is then the interior of vp (v itself), taken from the ring.
// cf_ptrs: host array of the six coefficient fields' device pointers in
// STAR7 order.  The tile (ty x tz) and the x segment length come from
// kernels/stencil_nd/kernel.py:launch_plan; partials: f32 scratch of
// nblk * n_dots floats, nblk the plan's block count, which must be this
// launch's grid.  Returns a cudaError_t code (0 on success).
int repro_stencil7_dot(int storage, int accum, const void* vp, const void* w,
                       const void* cf_ptrs, int n_dots, long long bx, long long by, long long z,
                       void* u, int ty, int tz, int seg_len, long long nblk, void* partials,
                       void* out, void* stream) {
  using namespace repro;
  using namespace repro::sten;
  if ((n_dots != 1 && n_dots != 2) || (w == nullptr) != (n_dots == 2) || bx < 1 || by < 1 ||
      z < 1 || bx > 0x7fffffffLL || (by + 2) * (z + 2) > 0x7fffffffLL || seg_len < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (storage == kF32 && accum == kF32)
    return run<float, float>(vp, w, cf_ptrs, n_dots, bx, by, z, u, ty, tz, seg_len, nblk,
                             partials, out, s);
  if (storage == kF32 && accum == kBF16)
    return run<float, bf16>(vp, w, cf_ptrs, n_dots, bx, by, z, u, ty, tz, seg_len, nblk,
                            partials, out, s);
  if (storage == kBF16 && accum == kF32)
    return run<bf16, float>(vp, w, cf_ptrs, n_dots, bx, by, z, u, ty, tz, seg_len, nblk,
                            partials, out, s);
  if (storage == kBF16 && accum == kBF16)
    return run<bf16, bf16>(vp, w, cf_ptrs, n_dots, bx, by, z, u, ty, tz, seg_len, nblk,
                           partials, out, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
