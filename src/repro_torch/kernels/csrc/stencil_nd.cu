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
// * A block owns a (y, z) tile of TY x TZ points (16 x 128 in bf16, 16 x 64 in
//   f32) and marches along x, the outermost axis, over a segment of planes.
//   Z is the contiguous axis, so every load and store runs along it.
// * The v planes x-r .. x+r of the tile, with their y/z halo of r, sit in a
//   shared-memory ring of 2r+2 slots; every tap reads v from there.  While a
//   plane is computed, the plane r+1 ahead is loaded into registers and
//   stored into the free slot after, so one barrier per plane suffices and
//   each v element comes from device memory (or L2) about once per block.
// * Each thread computes VZ consecutive z points (one 16-B vector: 8 bf16 or
//   4 f32), reads their coefficients and writes u with 16-B accesses, and
//   reads v from shared memory as 16-B vectors, shifting in registers for
//   the z taps.  Where Z is not a multiple of VZ, or a field is not 16-B
//   aligned, the same lanes load and store element by element.
// * Alignment: the padded row pitch (Z+2r) x itemsize is 3076 B at the paper
//   mesh (1220 B at 608^3), not a multiple of 16, so neither TMA nor 16-B
//   loads can tile v in device memory.  v is therefore staged with 4-B loads
//   (bf16 pairs, when Z is even and so every padded row starts 4-B aligned;
//   f32 elements) or 2-B loads (bf16, Z odd) into shared-memory rows laid out
//   so each tile row's interior starts on a 16-B boundary; the coefficient
//   fields and u have a pitch of Z x itemsize, 16-B aligned when
//   Z % VZ == 0.
// * The x range splits into segments (each re-reading its 2r halo planes)
//   so that (y, z) tiles x segments give enough blocks for the 132 SMs.
// * Batch: a block takes a chunk of NB right-hand sides (4 for radius 1, 2
//   for radius 2, 1 for radius 4, so the ring fits the shared-memory budget),
//   loads each tap's coefficients once and applies them to every RHS of the
//   chunk.
//
// Arithmetic: the unit main diagonal, then acc = acc + c_t * v[off_t] over
// the spec's canonical offsets (core/stencil.py), each op rounded to the
// accumulation dtype A, the result cast to storage T: the same per-point
// arithmetic as the plain PyTorch version, so every output equals it bit for
// bit, and each RHS of a batch equals the B = 1 launch on it.  For bf16
// storage with bf16 accumulation the ops run on bf16 pairs (mul.bf16x2 and
// add.bf16x2, one rounding each); the product of two bf16 values is exact in
// f32 and a sum rounded to f32 then to bf16 equals one bf16 rounding (see
// common.cuh), so the paired ops give the scalar helpers' bits.  The offsets
// are compile-time (the family's star r = 1, 2, 4 and box r = 1); the entry
// point checks that the caller's offsets are exactly those, in that order.
//
// Tiles, segments and the RHS chunk come from the caller
// (kernels/stencil_nd/kernel.py:launch_plan); the entry point checks them
// against the compiled tile.  The kernel reads the r-padded block that
// core/halo.py produces, so the multi-rank halo exchange feeds it unchanged,
// and it is right for blocks thinner than a tile in any axis (the overlap
// schedule's ring slabs, down to 1 x by x Z).
#include <type_traits>

#include "common.cuh"

namespace repro {
namespace sten {

enum Kind : int { kStar = 0, kBox = 1 };

// Offset t of a family spec, component a (0 x, 1 y, 2 z), in the canonical
// order of core/stencil.py: star axis by axis, +d then -d for d = 1..r;
// box lexicographic over (dx, dy, dz) with the centre left out.
template <int KIND, int R>
struct Spec {
  static constexpr int kN = KIND == kStar ? 6 * R : 26;
  __host__ __device__ static constexpr int off(int t, int a) {
    if (KIND == kStar) {
      const int axis = t / (2 * R), d = (t % (2 * R)) / 2 + 1;
      return axis == a ? (t % 2 == 0 ? d : -d) : 0;
    }
    const int idx = t < 13 ? t : t + 1;
    return (a == 0 ? idx / 9 : a == 1 ? (idx / 3) % 3 : idx % 3) - 1;
  }
};

constexpr int kThreads = 256;
constexpr int kTZT = 16;          // threads along z
constexpr int kTY = 16;           // tile rows (threads along y)
static_assert(kTZT * kTY == kThreads, "one thread per (y, z-vector) of the tile");

template <typename T>
struct Tile {
  static constexpr int VZ = 16 / (int)sizeof(T);  // z points per thread: one 16-B vector
  static constexpr int TZ = VZ * kTZT;             // 128 bf16, 64 f32
  static constexpr int P = TZ + 2 * VZ;            // shared row pitch (elements), 16-B multiple
};

// raw storage bits of T
template <typename T> struct Raw;
template <> struct Raw<float> { using type = float; };
template <> struct Raw<bf16> { using type = unsigned short; };

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

template <int I, int N, typename F>
__device__ __forceinline__ void static_for(F&& f) {
  if constexpr (I < N) {
    f(std::integral_constant<int, I>{});
    static_for<I + 1, N>(f);
  }
}

__device__ __forceinline__ uint32_t word(const uint4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// element k of a 16-B vector of T, exactly, as f32
template <typename T>
__device__ __forceinline__ float elem(const uint4& v, int k) {
  if constexpr (sizeof(T) == 4) {
    return __uint_as_float(word(v, k));
  } else {
    const uint32_t w = word(v, k / 2);
    return __uint_as_float(k % 2 == 0 ? w << 16 : w & 0xffff0000u);
  }
}

// x (exactly a T value) as an operand in A: rounded only when A is narrower
template <typename T, typename A>
__device__ __forceinline__ float up(float x) {
  if constexpr (sizeof(A) < sizeof(T)) return rnd<A>(x);
  else return x;
}

// The VZ elements starting DZ elements from the aligned vector at p (|DZ| <=
// r <= VZ): one aligned load for DZ = 0, else two and a shift in registers.
template <typename T, int DZ>
__device__ __forceinline__ uint4 window(const typename Raw<T>::type* p) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  if constexpr (DZ == 0) {
    return a;
  } else {
    constexpr int VZ = Tile<T>::VZ;
    const uint4 b = *reinterpret_cast<const uint4*>(p + (DZ > 0 ? VZ : -VZ));
    const uint32_t w[8] = {DZ > 0 ? a.x : b.x, DZ > 0 ? a.y : b.y, DZ > 0 ? a.z : b.z,
                           DZ > 0 ? a.w : b.w, DZ > 0 ? b.x : a.x, DZ > 0 ? b.y : a.y,
                           DZ > 0 ? b.z : a.z, DZ > 0 ? b.w : a.w};
    constexpr int s = DZ > 0 ? DZ : VZ + DZ;       // first element in w
    uint32_t o[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if constexpr (sizeof(T) == 4) o[j] = w[s + j];
      else if constexpr (s % 2 == 0) o[j] = w[s / 2 + j];
      else o[j] = __byte_perm(w[(s - 1) / 2 + j], w[(s + 1) / 2 + j], 0x5432);
    }
    return make_uint4(o[0], o[1], o[2], o[3]);
  }
}

// VZ elements at p from device memory: one 16-B load when wide, else the
// first n one by one (the rest 0)
template <typename T>
__device__ __forceinline__ uint4 load_vec(const T* p, bool wide, int n) {
  if (wide) return __ldg(reinterpret_cast<const uint4*>(p));
  using R = typename Raw<T>::type;
  const R* q = reinterpret_cast<const R*>(p);
  uint32_t o[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if constexpr (sizeof(T) == 4) {
      o[j] = j < n ? __float_as_uint(__ldg(q + j)) : 0u;
    } else {
      const uint32_t lo = 2 * j < n ? __ldg(q + 2 * j) : 0u;
      const uint32_t hi = 2 * j + 1 < n ? __ldg(q + 2 * j + 1) : 0u;
      o[j] = lo | (hi << 16);
    }
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

template <typename T>
__device__ __forceinline__ void store_vec(T* p, const uint4& v, bool wide, int n) {
  if (wide) {
    *reinterpret_cast<uint4*>(p) = v;
    return;
  }
  using R = typename Raw<T>::type;
  R* q = reinterpret_cast<R*>(p);
#pragma unroll
  for (int k = 0; k < Tile<T>::VZ; ++k) {
    if (k < n) {
      if constexpr (sizeof(T) == 4) q[k] = __uint_as_float(word(v, k));
      else q[k] = (unsigned short)(word(v, k / 2) >> (16 * (k % 2)));
    }
  }
}

// A thread's VZ accumulators: f32 lanes rounded to A after every op.
template <typename T, typename A>
struct Acc {
  static constexpr int VZ = Tile<T>::VZ;
  float a[VZ];
  __device__ __forceinline__ void init(const uint4& v) {
#pragma unroll
    for (int k = 0; k < VZ; ++k) a[k] = up<T, A>(elem<T>(v, k));
  }
  __device__ __forceinline__ void mac(const uint4& c, const uint4& v) {
#pragma unroll
    for (int k = 0; k < VZ; ++k)
      a[k] = add<A>(a[k], mul<A>(up<T, A>(elem<T>(c, k)), up<T, A>(elem<T>(v, k))));
  }
  __device__ __forceinline__ uint4 pack() const {
    uint32_t o[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if constexpr (sizeof(T) == 4) {
        o[j] = __float_as_uint(a[j]);
      } else {
        o[j] = (uint32_t)__bfloat16_as_ushort(from_f<T>(a[2 * j]))
               | ((uint32_t)__bfloat16_as_ushort(from_f<T>(a[2 * j + 1])) << 16);
      }
    }
    return make_uint4(o[0], o[1], o[2], o[3]);
  }
};

// one bf16-pair op, rounded to nearest even (explicit .rn: never contracted)
__device__ __forceinline__ uint32_t mul_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t add_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// bf16 storage and accumulation: the same ops on bf16 pairs, one rounding each
template <>
struct Acc<bf16, bf16> {
  uint32_t w[4];
  __device__ __forceinline__ void init(const uint4& v) {
#pragma unroll
    for (int j = 0; j < 4; ++j) w[j] = word(v, j);
  }
  __device__ __forceinline__ void mac(const uint4& c, const uint4& v) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      w[j] = add_bf16x2(w[j], mul_bf16x2(word(c, j), word(v, j)));
  }
  __device__ __forceinline__ uint4 pack() const { return make_uint4(w[0], w[1], w[2], w[3]); }
};

// Staging a plane's ROWS x W window (W = TZ + 2r elements per row): thread
// tid takes loads e = tid + k * kThreads, k < KP, into registers (0 outside
// the padded block), then stores them into a ring slot.  PAIR: bf16 rows
// that start 4-B aligned (Z even) load element pairs, half the loads and
// registers; otherwise one element a load.
template <typename RawT, int ROWS, int W, int P, int NB, bool PAIR>
struct Stage {
  static constexpr int U = PAIR ? 2 : 1;             // elements per load
  static constexpr int WU = W / U;                    // loads per row
  static constexpr int KP = (ROWS * WU + kThreads - 1) / kThreads;
  using Word = std::conditional_t<PAIR, uint32_t, RawT>;
  static_assert(W % U == 0, "pairs tile the row");
  Word pf[NB][KP];

  // src: the plane's first staged element of RHS 0; vstride: elements between RHS
  __device__ __forceinline__ void load(const RawT* src, int64_t vstride, int pz, int nc,
                                       int rows_ok, int cols_ok) {
#pragma unroll
    for (int q = 0; q < NB; ++q) {
#pragma unroll
      for (int k = 0; k < KP; ++k) {
        const int e = threadIdx.x + k * kThreads, row = e / WU, col = U * (e % WU);
        const RawT* at = src + q * vstride + row * pz + col;
        pf[q][k] = q < nc && row < rows_ok && col < cols_ok
                       ? __ldg(reinterpret_cast<const Word*>(at)) : Word(0);
      }
    }
  }
  // dst: the slot's first staged element of RHS 0; qs: elements between RHS
  __device__ __forceinline__ void store(RawT* dst, int qs, int nc) const {
#pragma unroll
    for (int q = 0; q < NB; ++q) {
#pragma unroll
      for (int k = 0; k < KP; ++k) {
        const int e = threadIdx.x + k * kThreads, row = e / WU, col = U * (e % WU);
        RawT* at = dst + q * qs + row * P + col;
        if (q < nc && row < ROWS) {
          if constexpr (PAIR) {
            at[0] = (RawT)(pf[q][k] & 0xffffu);
            at[1] = (RawT)(pf[q][k] >> 16);
          } else {
            at[0] = pf[q][k];
          }
        }
      }
    }
  }
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

  // prologue: padded planes x0 .. x0+2r (interior x0-r .. x0+r) into slots 0 .. 2r
  for (int j = 0; j <= 2 * R; ++j) {
    stage.load(src_of(x0 + j), p.vp_stride, pz, nc, rows_ok, cols_ok);
    stage.store(sm + j * SLOT + (VZ - R), QS, nc);
  }
  __syncthreads();

  const int y = ty0 + ty_t, zt = tz0 + VZ * tz_t;
  const int nz = max(0, min(VZ, p.z - zt));
  const bool live = y < p.by && nz > 0, wide = p.wide && nz == VZ;
  const RawT* mine = sm + (ty_t + R) * P + VZ * (tz_t + 1);   // my points, slot 0, RHS 0
  T* const u = static_cast<T*>(p.u) + b0 * p.u_stride;

  int base = 0;                                     // slot of padded plane x (interior x - r)
  for (int x = x0; x < x1; ++x) {
    const bool more = x + 1 < x1;
    if (more) stage.load(src_of(x + 2 * R + 1), p.vp_stride, pz, nc, rows_ok, cols_ok);
    if (live) {
      int slot[2 * R + 1];                          // element offset of interior plane x + dx
#pragma unroll
      for (int d = 0; d <= 2 * R; ++d)
        slot[d] = (base + d < SLOTS ? base + d : base + d - SLOTS) * SLOT;
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
    if (more) {
      const int next = base + 2 * R + 1 < SLOTS ? base + 2 * R + 1 : base + 2 * R + 1 - SLOTS;
      stage.store(sm + next * SLOT + (VZ - R), QS, nc);
    }
    __syncthreads();
    base = base + 1 == SLOTS ? 0 : base + 1;
  }
}

static bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
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
