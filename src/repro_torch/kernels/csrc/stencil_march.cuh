// The x-march shared by the stencil kernels (stencil_nd.cu: the family SpMV
// K1/K1b; stencil7_dot.cu: the 7-point SpMV with a dot epilogue, K6).
//
// A block owns a (y, z) tile of kTY x TZ points (16 x 128 in bf16, 16 x 64 in
// f32) and marches along x, the outermost axis, over a segment of planes.
// Z is the contiguous axis, so every load and store runs along it.
//
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
//   so that (y, z) tiles x segments give enough blocks for the 132 SMs; the
//   caller's plan (kernels/stencil_nd/kernel.py:launch_plan) sets them.
//
// The ring's bookkeeping (the prologue, the prefetch, the slots and the
// rotation) is Ring below; each kernel writes the plane loop and the
// plane's body itself.
//
// Arithmetic helpers round every op to the accumulation dtype A (common.cuh);
// for bf16 storage with bf16 accumulation the ops run on bf16 pairs
// (mul.bf16x2 and add.bf16x2, one rounding each), which give the scalar
// helpers' bits: the product of two bf16 values is exact in f32, and a sum
// rounded to f32 then to bf16 equals one bf16 rounding.
#pragma once

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
  // accumulator k, unrounded to storage, as f32
  __device__ __forceinline__ float value(int k) const { return a[k]; }
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
  __device__ __forceinline__ float value(int k) const { return elem<bf16>(pack(), k); }
  __device__ __forceinline__ uint4 pack() const { return make_uint4(w[0], w[1], w[2], w[3]); }
};

// Staging a plane's ROWS x W window (W = TZ + 2r elements per row): thread
// tid takes loads e = tid + k * kThreads, k < KP, into registers (0 outside
// the padded block), then stores them into a ring slot.  PAIR: bf16 rows
// that start 4-B aligned (Z even) load element pairs, half the loads and
// registers; otherwise one element a load.  SPLIT (with PAIR): rows not 4-B
// aligned still hold element pairs in registers, each pair from two 2-B
// loads, for half the registers of one element a load.
template <typename RawT, int ROWS, int W, int P, int NB, bool PAIR, bool SPLIT = false>
struct Stage {
  static constexpr int U = PAIR ? 2 : 1;             // elements per load
  static constexpr int WU = W / U;                    // loads per row
  static constexpr int KP = (ROWS * WU + kThreads - 1) / kThreads;
  using Word = std::conditional_t<PAIR, uint32_t, RawT>;
  static_assert(W % U == 0, "pairs tile the row");
  static_assert(PAIR || !SPLIT, "split loads fill pairs");
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
        if constexpr (SPLIT) {
          pf[q][k] = q < nc && row < rows_ok && col < cols_ok
                         ? Word(__ldg(at)) | (col + 1 < cols_ok ? Word(__ldg(at + 1)) << 16 : 0u)
                         : Word(0);
        } else {
          pf[q][k] = q < nc && row < rows_ok && col < cols_ok
                         ? __ldg(reinterpret_cast<const Word*>(at)) : Word(0);
        }
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

// The x-march's ring of 2r+2 slots (one per padded plane) for one block:
//
//   Ring<...> ring{stage, sm, src_of, vstride, pz, nc, qs, rows_ok, cols_ok, x1};
//   ring.begin(x0);                  // padded planes x0 .. x0+2r into slots 0 .. 2r
//   for (int x = x0; x < x1; ++x) {
//     ring.prefetch(x);              // padded plane x+2r+1 into registers
//     if (live) ...                  // interior plane x+d-r sits at ring.slot(d)
//     ring.advance(x);               // into the free slot; barrier; rotate
//   }
//
// Force-inlined, this gives every K1 and K6 instance the registers, stack
// frame and time of the same loop written out in the kernel; the loop as
// one function taking the plane's body as a callback kept the registers but
// ran K1 1.2-1.5x and K6 1.3x slower on an H100 (scripts/kernel_variants.py,
// the march_in_kernel and march_callback variants).
template <int R, int SLOT, int VZ, typename RawT, typename St, typename Src>
struct Ring {
  static constexpr int SLOTS = 2 * R + 2;
  St& stage;               // the plane being staged
  RawT* sm;                // slot 0 of RHS 0
  const Src& src_of;       // padded plane -> its first staged element of RHS 0
  int64_t vstride;         // elements between RHS in device memory
  int pz, nc, qs;          // padded row pitch; RHS staged; elements between RHS in the ring
  int rows_ok, cols_ok;    // staged rows and elements inside the padded block
  int x1;                  // end of the x segment
  int base = 0;            // slot of padded plane x (interior x - r)

  __device__ __forceinline__ void begin(int x0) {
    for (int j = 0; j <= 2 * R; ++j) {
      stage.load(src_of(x0 + j), vstride, pz, nc, rows_ok, cols_ok);
      stage.store(sm + j * SLOT + (VZ - R), qs, nc);
    }
    __syncthreads();
  }
  __device__ __forceinline__ void prefetch(int x) {
    if (x + 1 < x1) stage.load(src_of(x + 2 * R + 1), vstride, pz, nc, rows_ok, cols_ok);
  }
  // element offset of interior plane x + d - r's slot
  __device__ __forceinline__ int slot(int d) const {
    return (base + d < SLOTS ? base + d : base + d - SLOTS) * SLOT;
  }
  __device__ __forceinline__ void advance(int x) {
    if (x + 1 < x1) {
      const int next = base + 2 * R + 1 < SLOTS ? base + 2 * R + 1 : base + 2 * R + 1 - SLOTS;
      stage.store(sm + next * SLOT + (VZ - R), qs, nc);
    }
    __syncthreads();
    base = base + 1 == SLOTS ? 0 : base + 1;
  }
};

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace sten
}  // namespace repro
