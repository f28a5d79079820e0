// Shared scoring for the fused top-k scan (K1, fused_topk.cu) and the
// sampled sub-max pre-pass (K3, sampled_submax.cu).
//
// Both kernels score rows against a query tile with the SAME device code,
// walking the dim in the same slices with the same instructions, so their
// scores agree bit for bit: the engine's sampled floor is sound only if
// K3's sub-maxima are true elements of K1's score space
// (vrod_tpu/engine.py:191-202).
//
// Every leg of the TPU kernels (vrod_tpu/ops/pallas_topk.py: _block_dot
// :168, _epilogue :143) is one element kind and one epilogue:
//   kind  rows          query         dot g                 tensor-core MMA
//   I8    int8          int8          exact int32           m16n8k32 s8
//   I4    packed int4   int8 (full D) exact int32: two      m16n8k32 s8
//                                     half-dim dots
//   BF16  bfloat16      bfloat16      f32 sums of exact     m16n8k16 bf16
//                                     products
//   TF32  float32       float32       both rounded to TF32  m16n8k8 tf32
//                                     (cvt.rna), f32 sums
// For the integer kinds |g| <= 127 * 127 * 1040 < 2^24, exact in float.
//   epilogue   score                      legs
//   kScale     g * aux + mask             int cosine/dot, float cosine
//   kScaleQs   (g * aux) * qs2 + mask     int8/int4 l2 (qs2 = 2 * query
//                                         scale, mask = -|x_hat|^2 live)
//   kL2        (2 * g - aux) + mask       float l2 (aux = |x|^2)
//   kDot       g + mask                   float dot
// mask is -inf on dead slots. Each op is rounded once: __fmul_rn and
// friends, which the compiler never contracts into an FMA.
//
// The fragments of the three MMA shapes sit in the same 32-bit words (PTX
// ISA fragment tables): registers a0..a3 hold words (g, t), (g + 8, t),
// (g, t + 4), (g + 8, t + 4) of a 32-byte k-step, b0/b1 words t and t + 4
// of a row, and c0..c3 the same (query, row) positions. So one staging
// serves every kind: a block scores a tile of kQT = 32 queries (two m16
// tiles) against kTR = 64 rows (eight n8 tiles, one per warp), walking the
// row bytes in slices of 256 staged through shared memory, and only the
// MMA, the accumulator type and the transform on the way into shared
// memory (int4 nibbles to int8, float32 to TF32) depend on the kind.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace vrod {

constexpr int kThreads = 256;               // threads per block, every kernel
constexpr int kQT = 32;                     // queries per tile
constexpr int kTR = 64;                     // rows per score tile
constexpr int kAcc = 8;                     // scores per thread per tile
constexpr int kSliceUnits = 16;             // 16-byte units of dim per slice
// Shared-memory row stride in 4-byte words: 68 = 4 (mod 32), so the eight
// rows and four words of one fragment load fall in 32 distinct banks.
constexpr int kSt = kSliceUnits * 4 + 4;

static_assert(kThreads / 32 * 8 == kTR, "one n8 tile of rows per warp");
static_assert(kQT == 32 && kAcc == 8, "two m16 tiles of queries");

// Host codes of the element kinds and epilogues (ops/cuda_topk.py).
enum Elem : int { kI8 = 0, kI4 = 1, kBF16 = 2, kF32 = 3 };
enum Epi : int { kScale = 0, kScaleQs = 1, kL2 = 2, kDot = 3 };

// One kernel call's inputs. The dim is walked in 16-byte units: unit u of
// an unpacked row is bytes [16u, 16u + 16) of both the row and the query,
// which have the same stride. A packed int4 row of x_stride bytes holds
// dim j in the low nibble of byte j and dim j + x_stride in the high one
// (distances.pack_int4), and its query rows hold 2 * x_stride bytes: units
// [0, half_units) take the low nibbles against query bytes [0, x_stride)
// and units [half_units, units) the high nibbles against query bytes
// [x_stride, 2 * x_stride).
struct Operands {
  const int8_t* x;       // (n, x_stride) bytes: the stored rows
  const int8_t* q;       // the query tile: (b, x_stride), int4 (b, 2 x_stride)
  const float* aux;      // (n,)
  const float* mask;     // (n,)
  const float* qs2;      // (b,), read by kScaleQs only
  int x_stride;          // bytes per stored row
  int half_units;        // int4: units of one nibble half; else 0
  int units;             // units of the dim
};

// The operands of one launch, built inside the kernel from its
// __restrict__ pointer parameters (so the compiler knows the inputs alias
// no output) and the stored row's byte count.
template <class Kind>
__device__ __forceinline__ Operands make_operands(
    const int8_t* x, const int8_t* q, const float* aux, const float* mask,
    const float* qs2, int row_bytes) {
  const int u = (row_bytes + 15) / 16;
  return Operands{x, q, aux, mask, qs2, row_bytes,
                  Kind::kPacked ? u : 0, Kind::kPacked ? 2 * u : u};
}

// Whether every unit can load as one 16-byte vector: whole units per row
// and 16-byte aligned bases. The kernels take it as a template parameter
// (kVec), so the vector instantiation carries no byte-wise path.
inline bool vector_units(const void* x, const void* q, int row_bytes) {
  return row_bytes % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0
         && reinterpret_cast<uintptr_t>(q) % 16 == 0;
}

// Order-isomorphic int32 key of a float: a < b  <=>  key(a) < key(b).
// The same map as distances.kth_largest_count; -0.0 folds onto +0.0.
__device__ __forceinline__ int float_key(float f) {
  if (f == 0.0f) f = 0.0f;
  const int b = __float_as_int(f);
  return b ^ ((b >> 31) & 0x7fffffff);
}

// Score of a dot g of row `row` and query `qq` (< b).
template <int kEpi>
__device__ __forceinline__ float score_epilogue(const Operands& op, float g,
                                                int row, int qq) {
  const float aux = op.aux[row];
  const float mask = op.mask[row];
  if constexpr (kEpi == kScaleQs) {
    return __fadd_rn(__fmul_rn(__fmul_rn(g, aux), op.qs2[qq]), mask);
  } else if constexpr (kEpi == kL2) {
    return __fadd_rn(__fsub_rn(__fmul_rn(2.0f, g), aux), mask);
  } else if constexpr (kEpi == kDot) {
    return __fadd_rn(g, mask);
  } else {
    return __fadd_rn(__fmul_rn(g, aux), mask);
  }
}

__device__ __forceinline__ float dot_value(int g) { return __int2float_rn(g); }
__device__ __forceinline__ float dot_value(float g) { return g; }

// Where score acc[i] of this thread lies in the tile: the accumulator
// layout of the m16n8 MMAs (lane = 4 * group + t holds rows 2t, 2t + 1 of
// its warp's n8 tile, for queries group and group + 8 of each m16 tile).
__device__ __forceinline__ int acc_row(int i) {
  return (threadIdx.x >> 5) * 8 + 2 * (threadIdx.x & 3) + (i & 1);
}

__device__ __forceinline__ int acc_query(int i) {
  return (i >> 2) * 16 + ((threadIdx.x & 31) >> 2) + (i & 2) * 4;
}

// 16 bytes of row gr of a (.., stride) byte matrix from byte col on, of
// which the first lim lie inside the row. Rows at or past row_end and
// bytes past lim read as zero, so they add nothing to a dot (zero bytes
// are 0 as int8, as an int4 nibble pair, as bf16 and as float32).
template <bool kVec>
__device__ __forceinline__ int4 load_unit(const int8_t* src, int gr,
                                          int row_end, int stride, int col,
                                          int lim) {
  if (gr >= row_end || lim <= 0) return make_int4(0, 0, 0, 0);
  const int8_t* p = src + (size_t)gr * stride + col;
  if constexpr (kVec) {
    return *reinterpret_cast<const int4*>(p);
  } else {
    unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      if (i < lim) w[i >> 2] |= (unsigned)(uint8_t)p[i] << ((i & 3) * 8);
    }
    return make_int4((int)w[0], (int)w[1], (int)w[2], (int)w[3]);
  }
}

// Unit u of a packed int4 row: its byte column in the row and in the
// query, the bytes of it inside the row, and whether it takes the high
// nibbles.
struct Unit {
  int xcol, qcol, lim;
  bool hi;
};

__device__ __forceinline__ Unit packed_unit(const Operands& op, int u) {
  Unit r;
  r.hi = u >= op.half_units;
  const int v = r.hi ? u - op.half_units : u;
  r.xcol = v * 16;
  r.qcol = (r.hi ? op.x_stride : 0) + v * 16;
  r.lim = op.x_stride - v * 16;
  return r;
}

// -- The element kinds: transform on the way into shared memory, MMA ------

__device__ __forceinline__ void mma_s8(int (&c)[4], int a0, int a1, int a2,
                                       int a3, int b0, int b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

struct I8 {
  using Acc = int;
  static constexpr bool kPacked = false;
  __device__ static int4 x_in(int4 v, bool) { return v; }
  __device__ static int4 q_in(int4 v) { return v; }
  __device__ static void mma(Acc (&c)[4], int a0, int a1, int a2, int a3,
                             int b0, int b1) {
    mma_s8(c, a0, a1, a2, a3, b0, b1);
  }
};

// Four packed bytes -> the four int8 values of their low (or high)
// nibbles, sign-extended: per byte, (n ^ 8) - 8 without borrows across
// bytes (__vsub4).
__device__ __forceinline__ int nibbles(int w, bool hi) {
  const unsigned n = ((unsigned)w >> (hi ? 4 : 0)) & 0x0f0f0f0fu;
  return (int)__vsub4(n ^ 0x08080808u, 0x08080808u);
}

struct I4 : I8 {
  static constexpr bool kPacked = true;
  __device__ static int4 x_in(int4 v, bool hi) {
    return make_int4(nibbles(v.x, hi), nibbles(v.y, hi), nibbles(v.z, hi),
                     nibbles(v.w, hi));
  }
};

struct BF16 {
  using Acc = float;
  static constexpr bool kPacked = false;
  __device__ static int4 x_in(int4 v, bool) { return v; }
  __device__ static int4 q_in(int4 v) { return v; }
  __device__ static void mma(Acc (&c)[4], int a0, int a1, int a2, int a3,
                             int b0, int b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  }
};

// float32 -> TF32 (10 mantissa bits), to nearest, ties away from zero.
__device__ __forceinline__ int tf32(int w) {
  int r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(__int_as_float(w)));
  return r;
}

struct TF32 {
  using Acc = float;
  static constexpr bool kPacked = false;
  __device__ static int4 x_in(int4 v, bool) { return q_in(v); }
  __device__ static int4 q_in(int4 v) {
    return make_int4(tf32(v.x), tf32(v.y), tf32(v.z), tf32(v.w));
  }
  __device__ static void mma(Acc (&c)[4], int a0, int a1, int a2, int a3,
                             int b0, int b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  }
};

// Calls L::run<Kind, kEpi, kVec>(a...) for the leg of host codes (elem,
// epi): the integer kinds take kScale (cosine, dot) and kScaleQs (l2), the
// float kinds kScale (cosine), kL2 and kDot.
template <class L, bool kVec, class... A>
int dispatch_kind(int elem, int epi, A... a) {
  switch (elem * 4 + epi) {
    case kI8 * 4 + kScale: return L::template run<I8, kScale, kVec>(a...);
    case kI8 * 4 + kScaleQs: return L::template run<I8, kScaleQs, kVec>(a...);
    case kI4 * 4 + kScale: return L::template run<I4, kScale, kVec>(a...);
    case kI4 * 4 + kScaleQs: return L::template run<I4, kScaleQs, kVec>(a...);
    case kBF16 * 4 + kScale: return L::template run<BF16, kScale, kVec>(a...);
    case kBF16 * 4 + kL2: return L::template run<BF16, kL2, kVec>(a...);
    case kBF16 * 4 + kDot: return L::template run<BF16, kDot, kVec>(a...);
    case kF32 * 4 + kScale: return L::template run<TF32, kScale, kVec>(a...);
    case kF32 * 4 + kL2: return L::template run<TF32, kL2, kVec>(a...);
    case kF32 * 4 + kDot: return L::template run<TF32, kDot, kVec>(a...);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <class L, class... A>
int dispatch_leg(int elem, int epi, bool vec, A... a) {
  return vec ? dispatch_kind<L, true>(elem, epi, a...)
             : dispatch_kind<L, false>(elem, epi, a...);
}

// -- Staging --------------------------------------------------------------

// This thread's share of one slice (kSliceUnits units of dim) of the query
// tile and of the row tile, held in registers between its load and its
// store to shared memory. Element e = threadIdx.x + p * kThreads is unit
// e % kSliceUnits of tile row e / kSliceUnits.
constexpr int kQUnits = kQT * kSliceUnits / kThreads;  // 2
constexpr int kXUnits = kTR * kSliceUnits / kThreads;  // 4

struct Slice {
  int4 q[kQUnits];
  int4 x[kXUnits];
};

// Issue every load of a slice before any is used, so their latencies
// overlap (the stores wait in store_slice). Unpacked kinds read unit u at
// byte 16u of the row and of the query; only packed int4 maps units to
// nibble halves.
template <class Kind, bool kVec>
__device__ __forceinline__ void load_slice(Slice& s, const Operands& op,
                                           int r0, int row_end, int b,
                                           int q0, int u0) {
#pragma unroll
  for (int p = 0; p < kQUnits; ++p) {
    const int e = threadIdx.x + p * kThreads;
    const int u = u0 + e % kSliceUnits;
    if constexpr (Kind::kPacked) {
      const Unit un = packed_unit(op, u);
      s.q[p] = load_unit<kVec>(op.q, q0 + e / kSliceUnits, b,
                               2 * op.x_stride, un.qcol, un.lim);
    } else {
      s.q[p] = load_unit<kVec>(op.q, q0 + e / kSliceUnits, b, op.x_stride,
                               u * 16, op.x_stride - u * 16);
    }
  }
#pragma unroll
  for (int p = 0; p < kXUnits; ++p) {
    const int e = threadIdx.x + p * kThreads;
    const int u = u0 + e % kSliceUnits;
    if constexpr (Kind::kPacked) {
      const Unit un = packed_unit(op, u);
      s.x[p] = load_unit<kVec>(op.x, r0 + e / kSliceUnits, row_end,
                               op.x_stride, un.xcol, un.lim);
    } else {
      s.x[p] = load_unit<kVec>(op.x, r0 + e / kSliceUnits, row_end,
                               op.x_stride, u * 16, op.x_stride - u * 16);
    }
  }
}

template <class Kind>
__device__ __forceinline__ void store_slice(const Slice& s,
                                            const Operands& op, int u0,
                                            int* qs, int* xs) {
#pragma unroll
  for (int p = 0; p < kQUnits; ++p) {
    const int e = threadIdx.x + p * kThreads;
    *reinterpret_cast<int4*>(qs + e / kSliceUnits * kSt
                             + e % kSliceUnits * 4) = Kind::q_in(s.q[p]);
  }
#pragma unroll
  for (int p = 0; p < kXUnits; ++p) {
    const int e = threadIdx.x + p * kThreads;
    const bool hi =
        Kind::kPacked && u0 + e % kSliceUnits >= op.half_units;
    *reinterpret_cast<int4*>(xs + e / kSliceUnits * kSt
                             + e % kSliceUnits * 4) = Kind::x_in(s.x[p], hi);
  }
}

// Dots of query tile [q0, q0 + kQT) with the rows [r_begin, r_end) (rows
// at or past row_end score as zero rows), one row tile of kTR rows at a
// time: for each tile, epi(r0, acc) gets acc[i], the dot of query
// q0 + acc_query(i) with row r0 + acc_row(i). The dim is walked in slices
// of kSliceUnits units staged through qs (kQT * kSt words) and xs (kTR *
// kSt words), 16-byte aligned shared buffers; the next slice's loads are in
// flight while the tensor cores work on the current one. Every thread of
// the block must call this (it synchronizes).
template <class Kind, bool kVec, class Epilogue>
__device__ __forceinline__ void scan_dots(const Operands& op, int row_end,
                                          int b, int r_begin, int r_end,
                                          int q0, int* qs, int* xs,
                                          Epilogue&& epi) {
  using Acc = typename Kind::Acc;
  const int units = op.units;
  const int slices = (units + kSliceUnits - 1) / kSliceUnits;
  const int steps = (r_end - r_begin + kTR - 1) / kTR * slices;
  const int lane = threadIdx.x & 31;
  const int* xf = xs + ((threadIdx.x >> 5) * 8 + (lane >> 2)) * kSt
                  + (lane & 3);
  const int* qf = qs + (lane >> 2) * kSt + (lane & 3);
  Acc c0[4] = {0, 0, 0, 0};  // queries 0-15 of the tile
  Acc c1[4] = {0, 0, 0, 0};  // queries 16-31
  Slice next;
  if (steps > 0) {
    load_slice<Kind, kVec>(next, op, r_begin, row_end, b, q0, 0);
  }
  for (int st = 0; st < steps; ++st) {
    const int r0 = r_begin + st / slices * kTR;
    const int u0 = st % slices * kSliceUnits;
    __syncthreads();  // the previous slice is consumed
    store_slice<Kind>(next, op, u0, qs, xs);
    __syncthreads();
    if (st + 1 < steps) {
      load_slice<Kind, kVec>(next, op, r_begin + (st + 1) / slices * kTR,
                       row_end, b, q0, (st + 1) % slices * kSliceUnits);
    }
    // Whole 32-byte k-steps: an odd last unit meets a zero one after it.
    const int ksteps = (min(kSliceUnits, units - u0) + 1) / 2;
    for (int s = 0; s < ksteps; ++s) {
      const int w = s * 8;
      const int b0 = xf[w];
      const int b1 = xf[w + 4];
      Kind::mma(c0, qf[w], qf[w + 8 * kSt], qf[w + 4], qf[w + 8 * kSt + 4],
                b0, b1);
      Kind::mma(c1, qf[w + 16 * kSt], qf[w + 24 * kSt], qf[w + 16 * kSt + 4],
                qf[w + 24 * kSt + 4], b0, b1);
    }
    if (u0 + kSliceUnits >= units) {  // the tile's last slice
      const Acc acc[kAcc] = {c0[0], c0[1], c0[2], c0[3],
                             c1[0], c1[1], c1[2], c1[3]};
      epi(r0, acc);
#pragma unroll
      for (int i = 0; i < 4; ++i) c0[i] = c1[i] = 0;
    }
  }
}

}  // namespace vrod
