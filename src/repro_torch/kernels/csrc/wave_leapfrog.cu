// K7: one leapfrog step of the constant-density acoustic wave equation,
//
//   u_next = (2 u - u_prev) + c * L(u)      (+ the source sample at one point)
//
// with L the 8th-order central-difference Laplacian in grid units, a 25-point
// star of radius 4: L(u) = wc u + sum_t a_|off_t| u[off_t], t over the star's
// 24 offsets in the canonical order of core/stencil.py (x, then y, then z; +d
// then -d for d = 1..4), wc = 3 a_0.  c = (v dt / h)^2 per point; u is zero
// outside the block (zero Dirichlet).  The source sample c_s w(n dt) is read
// from device memory by the one thread whose lanes hold the source point, so
// the step is one launch and the host never waits.
//
// Replaces no TPU kernel: the JAX package has no explicit time-stepper.  It
// is the step of the source's workload (Jacquelin, Araya-Polo and Meng,
// "Massively scalable stencil algorithm", SC22: Minimod's isotropic acoustic
// kernel), which core/wave.py:propagate_shot runs, one launch a step.
//
// Bound: device-memory bytes.  Per point the step must read u, u_prev and c
// and write u_next: 16 B against 52 flops, far below the card's
// operations-per-byte line.  Design:
//
// * K1's x-march (stencil_march.cuh) at radius 4 in f32 on the bare block: a
//   block owns a 16 x 64 (y, z) tile and one x segment, stages the planes of
//   u with their zero halo into a ring of 10 planes in shared memory (16-B
//   cp.async vectors when Z % 4 == 0 and u is 16-B aligned, else element by
//   element), and each thread computes one 16-B vector of z points a plane.
//   Tiles and segments come from kernels/stencil_nd/kernel.py:launch_plan
//   (its star25 f32 plan for one right-hand side), through
//   kernels/wave/kernel.py.
// * The tap weights are constant, launch arguments: no coefficient field is
//   read, and c is the one model field.
// * u_prev is read at the centre only, by the thread that writes u_next
//   there, so u_next overwrites u_prev in place and the caller swaps the two
//   buffers by reference: no copy, no third wavefield.
// * c is read and u_next written once, with streaming hints (ld/st .cs), so
//   L2 keeps the planes of u that neighbouring tiles read again for their
//   halos; u_prev is read once, by the thread that overwrites it.
//
// On an H100 at the cell's mesh (755 x 994 x 1000) a step takes 5.7 ms, 63%
// of its bound.  The march, not the taps, bounds it: the same kernel with
// no tap at all (u_next from the centre alone) ran 5.58 ms, a second plane
// of u in flight (2r+3 slots) 1% faster, and x segments of 32-378 planes
// no faster than the default plan's 252.
//
// Arithmetic, each op rounded to f32 (__fmul_rn, __fadd_rn; the library is
// built with --fmad=false): acc = wc * u; acc = acc + a_d * u[off_t] over the
// taps in order; u_next = (2 u - u_prev) + c * acc; at the source point
// u_next = u_next + sample.  The plain version (kernels/wave/ref.py)
// repeats it op for op, so the two agree bit for bit.
#include "stencil_march.cuh"

namespace repro {
namespace sten {

constexpr int kWaveR = 4;
// Blocks per SM the register budget is set for: the ring of 10 planes of
// 24 x 72 f32 takes 69,120 B of shared memory, so 3 blocks fill the SM
// anyway (at most 85 registers a thread).
constexpr int kMinBlocksWave = 3;

struct WaveParams {
  const float* u;          // u^n, (bx, by, Z), contiguous
  float* w;                // u^{n-1} in, u^{n+1} out, (bx, by, Z)
  const float* c;          // (v dt / h)^2, (bx, by, Z)
  const float* src;        // the source sample, on the device; null: no source
  long long src_index;     // the source point's element index in the block
  float wc;                // centre weight, 3 a_0
  float wa[kWaveR];        // a_1 .. a_4
  int bx, by, z;
  int seg_len, ntz;        // planes per segment; z tiles per tile row
  int wide;                // w and c 16-B aligned and Z % 4 == 0
};

__device__ __forceinline__ float lane(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// 4 floats at p, read once: one 16-B streaming load when wide, else the
// first n one by one (the rest 0)
__device__ __forceinline__ float4 load_once(const float* p, bool wide, int n) {
  if (wide) return __ldcs(reinterpret_cast<const float4*>(p));
  float o[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) o[j] = j < n ? __ldcs(p + j) : 0.0f;
  return make_float4(o[0], o[1], o[2], o[3]);
}

// u_prev's 4 floats at p: a plain 16-B load when wide (it ran 2% faster than a
// streaming one); else as load_once
__device__ __forceinline__ float4 load_prev(const float* p, bool wide, int n) {
  if (wide) return *reinterpret_cast<const float4*>(p);
  return load_once(p, false, n);
}

__device__ __forceinline__ void store_once(float* p, const float (&v)[4], bool wide, int n) {
  if (wide) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (j < n) __stcs(p + j, v[j]);
}

// VEC: the planes of u staged in 16-B vectors by cp.async (Z % 4 == 0, u
// 16-B aligned); else element by element through registers
template <bool VEC>
__global__ void __launch_bounds__(kThreads, kMinBlocksWave)
    wave_leapfrog_kernel(const WaveParams p) {
  using S = Spec<kStar, kWaveR>;
  constexpr int R = kWaveR;
  constexpr int VZ = Tile<float>::VZ, TZ = Tile<float>::TZ, P = Tile<float>::P;
  static_assert(VZ == 4, "one float4 a thread");
  // staged rows and elements per row (for f32 at r = 4 both forms stage the
  // whole shared row: TZ + 2r == P)
  constexpr int ROWS = kTY + 2 * R, W = VEC ? P : TZ + 2 * R;
  constexpr int SLOT = ROWS * P;                     // elements of one staged plane
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sm = reinterpret_cast<float*>(smem_raw);   // the ring: [2r+2][ROWS][P]

  const int x0 = blockIdx.y * p.seg_len;
  if (x0 >= p.bx) return;
  const int x1 = min(p.bx, x0 + p.seg_len);
  const int tid = threadIdx.x, tz_t = tid % kTZT, ty_t = tid / kTZT;
  const int ty0 = (blockIdx.x / p.ntz) * kTY, tz0 = (blockIdx.x % p.ntz) * TZ;
  // the window's origin in u; the block's rows and columns bound it (the bare
  // block of stencil_march.cuh: every element outside is staged as 0)
  const int row0 = ty0 - R, col0 = tz0 - (W - TZ) / 2;

  std::conditional_t<VEC, StageAsync<float, ROWS, P, 1>, Stage<float, ROWS, W, P, 1, false>>
      stage(p.by, p.z, row0, col0);
  auto src_of = [&](int pp) -> const float* {         // padded plane pp (interior pp - r)
    return (unsigned)(pp - R) < (unsigned)p.bx
               ? p.u + ((int64_t)(pp - R) * p.by + row0) * p.z + col0 : nullptr;
  };
  Ring<R, SLOT, float, decltype(stage), decltype(src_of)> ring{
      stage, sm, src_of, 0, p.z, 1, 0, x1};
  ring.begin(x0);                                   // planes x0-r .. x0+r

  const int y = ty0 + ty_t, zt = tz0 + VZ * tz_t;
  const int nz = max(0, min(VZ, p.z - zt));
  const bool live = y < p.by && nz > 0, wide = p.wide && nz == VZ;
  const float* mine = sm + (ty_t + R) * P + VZ * (tz_t + 1);   // my points, slot 0

  for (int x = x0; x < x1; ++x) {
    ring.prefetch(x);
    if (live) {
      int slot[2 * R + 1];                          // element offset of interior plane x + dx
#pragma unroll
      for (int d = 0; d <= 2 * R; ++d) slot[d] = ring.slot(d);
      const int64_t o = ((int64_t)x * p.by + y) * p.z + zt;
      const uint4 uc = window<float, 0>(mine + slot[R]);
      float acc[VZ];
#pragma unroll
      for (int k = 0; k < VZ; ++k) acc[k] = __fmul_rn(p.wc, elem<float>(uc, k));
      static_for<0, S::kN>([&](auto tc) {
        constexpr int t = decltype(tc)::value;
        constexpr int dx = S::off(t, 0), dy = S::off(t, 1), dz = S::off(t, 2);
        constexpr int d = (dx > 0 ? dx : -dx) + (dy > 0 ? dy : -dy) + (dz > 0 ? dz : -dz);
        const float a = p.wa[d - 1];
        const uint4 v = window<float, dz>(mine + slot[R + dx] + dy * P);
#pragma unroll
        for (int k = 0; k < VZ; ++k) acc[k] = __fadd_rn(acc[k], __fmul_rn(a, elem<float>(v, k)));
      });
      // c and u_prev after the taps: loaded before them, they stayed live across the
      // taps and the kernel spilled 128-164 B at its 80 registers (9.35 ms a step at
      // the cell's mesh on an H100, against 5.71 loaded here)
      const float4 cv = load_once(p.c + o, wide, nz);
      const float4 wv = load_prev(p.w + o, wide, nz);
      const int64_t at = p.src_index - o;          // the source's lane, if it is one of mine
      float out[VZ];
#pragma unroll
      for (int k = 0; k < VZ; ++k) {
        const float lf = __fadd_rn(__fmul_rn(2.0f, elem<float>(uc, k)), -lane(wv, k));
        out[k] = __fadd_rn(lf, __fmul_rn(lane(cv, k), acc[k]));
        if (p.src != nullptr && at == k && k < nz) out[k] = __fadd_rn(out[k], __ldg(p.src));
      }
      store_once(p.w + o, out, wide, nz);
    }
    ring.advance(x);
  }
}

template <bool VEC>
static int launch(const WaveParams& p, int nty, int segments, cudaStream_t stream) {
  constexpr size_t smem =
      (size_t)(2 * kWaveR + 2) * (kTY + 2 * kWaveR) * Tile<float>::P * sizeof(float);
  auto kern = wave_leapfrog_kernel<VEC>;
  const cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)(nty * p.ntz), (unsigned)segments);
  kern<<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace sten
}  // namespace repro

extern "C" {

// One leapfrog step on a (bx, by, Z) f32 block, in place: w holds u^{n-1}
// and receives u^{n+1}; u (u^n) and c are read.  u must not overlap w.
// weights: host array of 5 floats, wc = 3 a_0 and a_1 .. a_4.  src: device
// pointer to the source sample (one float), added at element src_index;
// src_index < 0 adds none.  The tile (ty x tz) and the x segment length come
// from kernels/stencil_nd/kernel.py:launch_plan (star25, f32, one RHS).
// Returns a cudaError_t code (0 on success).
int repro_wave_leapfrog(const void* u, void* w, const void* c, const void* src,
                        long long src_index, const void* weights, long long bx, long long by,
                        long long z, int ty, int tz, int seg_len, void* stream) {
  using namespace repro;
  using namespace repro::sten;
  if (bx < 1 || by < 1 || z < 1 || bx > 0x7fffffffLL || by * z > 0x7fffffffLL || seg_len < 1 ||
      ty != kTY || tz != Tile<float>::TZ || src_index >= bx * by * z)
    return (int)cudaErrorInvalidValue;
  const long long ntz = (z + tz - 1) / tz, nty = (by + ty - 1) / ty;
  const long long segments = (bx + seg_len - 1) / seg_len;
  if (ntz * nty > 0x7fffffffLL || segments > 65535) return (int)cudaErrorInvalidValue;
  const float* wt = static_cast<const float*>(weights);
  WaveParams p;
  p.u = static_cast<const float*>(u);
  p.w = static_cast<float*>(w);
  p.c = static_cast<const float*>(c);
  p.src = src_index >= 0 ? static_cast<const float*>(src) : nullptr;
  p.src_index = src_index;
  p.wc = wt[0];
  for (int d = 0; d < kWaveR; ++d) p.wa[d] = wt[1 + d];
  p.bx = (int)bx;
  p.by = (int)by;
  p.z = (int)z;
  p.seg_len = seg_len;
  p.ntz = (int)ntz;
  p.wide = z % 4 == 0 && aligned16(w) && aligned16(c);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (z % 4 == 0 && aligned16(u)) return launch<true>(p, (int)nty, (int)segments, s);
  return launch<false>(p, (int)nty, (int)segments, s);
}

}  // extern "C"
