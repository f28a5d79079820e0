// The scoring core shared by the fused top-k scan (K1, fused_topk.cu) and
// the sampled sub-max pre-pass (K3, sampled_submax.cu), for Hopper (sm_90a).
//
// Both kernels score rows against queries with the SAME device code: the
// same producer, the same ring, the same wgmma instructions in the same
// order, so their scores agree bit for bit. The engine's sampled floor is
// sound only if K3's sub-maxima are true elements of K1's score space
// (vrod_tpu/engine.py:191-202).
//
// The product. Rows are the wgmma M side, in 64-row warpgroup tiles; the
// queries are the N side, 256 of them per block (kGroup), so at batch 256
// every row tile is multiplied with the whole batch in one pass and each
// row byte leaves device memory once. A block has two consumer warpgroups
// and a producer warpgroup, of which one warp loads and the other three only
// hand their registers to the consumers (setmaxnreg). The producer warp
// walks the block's row tiles (128 rows, kTileRows) in k-blocks of 128
// bytes of dim; per k-block it loads the row tile's slice (16 KB) and the
// query group's slice (32 KB) into one stage of a ring in shared memory, by
// TMA with the 128-byte swizzle, and signals the stage's full barrier
// (mbarrier, transaction bytes). Each consumer
// warpgroup takes its 64 rows of the stage into registers (ldmatrix: the
// swizzle makes the eight rows of each 8x16-byte matrix hit distinct banks),
// applies its kind's transform, and issues wgmma m64n256 with A from
// registers and B (the queries) from shared memory, then releases the stage
// (empty barrier) once its wgmmas have completed. The queries stream with
// the rows, so any dim fits the same 48 KB stage. A from registers is what
// lets one core serve every kind:
//   kind  rows          query          transform in registers  wgmma
//   I8    int8          int8           none                    m64n256k32 s8
//   I4    packed int4   int8 (full D)  nibbles -> s8 (lo or hi  m64n256k32 s8
//                                      half of each k-block)
//   BF16  bfloat16      bfloat16       none                    m64n256k16 bf16
//   TF32  float32       float32, TF32  cvt.rna to TF32         m64n256k8 tf32
//                       (the wrapper)
// The tensor cores read the low 13 mantissa bits of a TF32 operand as zero
// (truncation); rounding both operands to nearest first keeps the scorer
// the plain version's (cuda_topk.tf32_round). Each wgmma k-step is 32 bytes
// of dim for every kind, so a k-block is four k-steps. Packed int4 walks
// its row k-blocks twice: low nibbles against query bytes [0, D/2) and high
// nibbles against [D/2, D) (distances.pack_int4), each from its own query
// tensor map. Bytes past the row (and rows or queries past the end) load as
// zeros (TMA's out-of-bounds fill), which add nothing to a dot: 0 as int8,
// an int4 nibble pair, bf16 and float32.
//
// Shapes TMA cannot take (row bytes not a multiple of 16, or unaligned
// bases: int8 dim 30, packed int4 D/2 = 15) take the same kernel with the
// producer warp copying each stage with plain loads into the same swizzled
// layout (kTma = false): a shape dispatch, chosen on the host.
//
// Each score then gets its epilogue, every op rounded once (__fmul_rn and
// friends, which the compiler never contracts into an FMA):
//   epilogue   score                      legs
//   kScale     g * aux + mask             int cosine/dot, float cosine
//   kScaleQs   (g * aux) * qs2 + mask     int8/int4 l2 (qs2 = 2 * query
//                                         scale, mask = -|x_hat|^2 live)
//   kL2        (2 * g - aux) + mask       float l2 (aux = |x|^2)
//   kDot       g + mask                   float dot
// mask is -inf on dead slots. For the integer kinds |g| <= 127 * 127 * 1040
// < 2^24, exact in float.

#pragma once

#include <dlfcn.h>

#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

namespace vrod {

constexpr int kTileRows = 128;                 // rows per tile (2 x m64)
constexpr int kGroup = 256;                    // queries per block (wgmma N)
constexpr int kKBlock = 128;                   // dim bytes per stage
constexpr int kKSteps = kKBlock / 32;          // wgmma k-steps per stage
constexpr int kConsumers = 256;                // two consumer warpgroups
constexpr int kThreads = kConsumers + 128;     // and a producer warpgroup
// Registers per thread after setmaxnreg: the producer warpgroup gives its
// registers to the consumers, whose 128 accumulators need them (at the
// launch's even split of 168 ptxas serializes the wgmmas).
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
static_assert(kConsumers * kConsumerRegs + 128 * kProducerRegs <= 65536,
              "register file");
constexpr int kAcc = kGroup / 2;               // accumulators per thread
constexpr int kRowBox = kTileRows * kKBlock;   // 16 KB
constexpr int kQueryBox = kGroup * kKBlock;    // 32 KB
constexpr int kStageBytes = kRowBox + kQueryBox;

// Host codes of the element kinds and epilogues (ops/cuda_topk.py).
enum Elem : int { kI8 = 0, kI4 = 1, kBF16 = 2, kF32 = 3 };
enum Epi : int { kScale = 0, kScaleQs = 1, kL2 = 2, kDot = 3 };

// One launch's geometry: the stored row's bytes, and the k-blocks a tile
// walks (packed int4: each row k-block twice, low then high nibbles).
struct Geometry {
  int row_bytes;  // bytes per stored row
  int kbs;        // k-blocks per row
  int nv;         // stages per tile
};

template <class Kind>
__host__ __device__ inline Geometry make_geometry(int row_bytes) {
  const int kbs = (row_bytes + kKBlock - 1) / kKBlock;
  return Geometry{row_bytes, kbs, Kind::kPacked ? 2 * kbs : kbs};
}

// The three tensor maps of a launch: rows, queries (packed int4: the low
// half), and the packed int4 queries' high half.
struct Maps {
  CUtensorMap x, q, q_hi;
};

// Order-isomorphic int32 key of a float: a < b  <=>  key(a) < key(b).
// The same map as distances.kth_largest_count; -0.0 folds onto +0.0.
__device__ __forceinline__ int float_key(float f) {
  if (f == 0.0f) f = 0.0f;
  const int b = __float_as_int(f);
  return b ^ ((b >> 31) & 0x7fffffff);
}

template <int kEpi>
__device__ __forceinline__ float score_epilogue(float g, float aux,
                                                float mask, float qs2) {
  if constexpr (kEpi == kScaleQs) {
    return __fadd_rn(__fmul_rn(__fmul_rn(g, aux), qs2), mask);
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

// -- PTX: shared addresses, mbarriers, TMA, ldmatrix, wgmma --------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ bool mbar_try(uint64_t* bar, int parity) {
  uint32_t ok;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  return ok != 0;
}

// Wait for the completion of the barrier's phase of this parity.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  while (!mbar_try(bar, parity)) {
  }
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0),
         "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(kConsumers) : "memory");
}

// wgmma operand descriptor of a K-major tile in the 128-byte swizzle
// layout: rows of 128 bytes, eight-row atoms 1024 bytes apart (SBO); the
// leading offset is unused for this layout. Stage buffers are 1024-byte
// aligned, and a k-step inside the 128-byte row is a plain address offset.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr) {
  return (uint64_t)((saddr >> 4) & 0x3FFF) | ((uint64_t)1 << 16)
         | ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// Byte offset of (row r, byte c) of a 128-byte-row tile in the layout the
// TMA 128-byte swizzle writes: 16-byte chunk c / 16 of row r lands at chunk
// (c / 16) ^ (r % 8).
__device__ __forceinline__ int swizzled(int r, int c) {
  return r * kKBlock + ((((c >> 4) ^ r) & 7) << 4) + (c & 15);
}

#define VROD_ACC_REGS                                                  \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "  \
  "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "  \
  "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "  \
  "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "  \
  "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "  \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "  \
  "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "  \
  "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, " \
  "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, " \
  "%127}, {%128, %129, %130, %131}, %132, p"
#define VROD_SETP "{\n .reg .pred p;\n setp.ne.b32 p, %133, 0;\n"
#define VROD_D8(c, d, i)                                                \
  c(d[i]), c(d[i + 1]), c(d[i + 2]), c(d[i + 3]), c(d[i + 4]),          \
      c(d[i + 5]), c(d[i + 6]), c(d[i + 7])
#define VROD_D32(c, d, i)                                               \
  VROD_D8(c, d, i), VROD_D8(c, d, i + 8), VROD_D8(c, d, i + 16),        \
      VROD_D8(c, d, i + 24)
#define VROD_D128(c, d)                                                 \
  VROD_D32(c, d, 0), VROD_D32(c, d, 32), VROD_D32(c, d, 64),            \
      VROD_D32(c, d, 96)
#define VROD_R(v) "+r"(v)
#define VROD_F(v) "+f"(v)
#define VROD_IN(a, desc, scale)                                         \
  "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale)

// -- The element kinds: register transform of A, and the wgmma -----------

__device__ __forceinline__ void wgmma_s8(int (&d)[kAcc],
                                         const uint32_t (&a)[4],
                                         uint64_t desc, int scale) {
  asm volatile(VROD_SETP
               " wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
               VROD_ACC_REGS ";\n}\n"
               : VROD_D128(VROD_R, d) : VROD_IN(a, desc, scale));
}

struct I8 {
  using Acc = int;
  static constexpr bool kPacked = false;
  __device__ static void a_in(uint32_t (&)[4], bool) {}
  __device__ static void mma(Acc (&d)[kAcc], const uint32_t (&a)[4],
                             uint64_t desc, int scale) {
    wgmma_s8(d, a, desc, scale);
  }
};

// Four packed bytes -> the four int8 values of their low (or high)
// nibbles, sign-extended: per byte, (n ^ 8) - 8 without borrows across
// bytes (__vsub4).
__device__ __forceinline__ uint32_t nibbles(uint32_t w, bool hi) {
  const unsigned n = (w >> (hi ? 4 : 0)) & 0x0f0f0f0fu;
  return __vsub4(n ^ 0x08080808u, 0x08080808u);
}

struct I4 : I8 {
  static constexpr bool kPacked = true;
  __device__ static void a_in(uint32_t (&a)[4], bool hi) {
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = nibbles(a[i], hi);
  }
};

struct BF16 {
  using Acc = float;
  static constexpr bool kPacked = false;
  __device__ static void a_in(uint32_t (&)[4], bool) {}
  __device__ static void mma(Acc (&d)[kAcc], const uint32_t (&a)[4],
                             uint64_t desc, int scale) {
    asm volatile(VROD_SETP
                 " wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
                 VROD_ACC_REGS ", 1, 1, 0;\n}\n"
                 : VROD_D128(VROD_F, d) : VROD_IN(a, desc, scale));
  }
};

// float32 -> TF32 (10 mantissa bits), to nearest, ties away from zero.
__device__ __forceinline__ uint32_t tf32(uint32_t w) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(__uint_as_float(w)));
  return r;
}

struct TF32 {
  using Acc = float;
  static constexpr bool kPacked = false;
  __device__ static void a_in(uint32_t (&a)[4], bool) {
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = tf32(a[i]);
  }
  __device__ static void mma(Acc (&d)[kAcc], const uint32_t (&a)[4],
                             uint64_t desc, int scale) {
    asm volatile(VROD_SETP
                 " wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32 "
                 VROD_ACC_REGS ", 1, 1;\n}\n"
                 : VROD_D128(VROD_F, d) : VROD_IN(a, desc, scale));
  }
};

// Calls L::run<Kind, kEpi, kTma>(a...) for the leg of host codes (elem,
// epi): the integer kinds take kScale (cosine, dot) and kScaleQs (l2), the
// float kinds kScale (cosine), kL2 and kDot.
template <class L, bool kTma, class... A>
int dispatch_kind(int elem, int epi, A... a) {
  switch (elem * 4 + epi) {
    case kI8 * 4 + kScale: return L::template run<I8, kScale, kTma>(a...);
    case kI8 * 4 + kScaleQs: return L::template run<I8, kScaleQs, kTma>(a...);
    case kI4 * 4 + kScale: return L::template run<I4, kScale, kTma>(a...);
    case kI4 * 4 + kScaleQs: return L::template run<I4, kScaleQs, kTma>(a...);
    case kBF16 * 4 + kScale: return L::template run<BF16, kScale, kTma>(a...);
    case kBF16 * 4 + kL2: return L::template run<BF16, kL2, kTma>(a...);
    case kBF16 * 4 + kDot: return L::template run<BF16, kDot, kTma>(a...);
    case kF32 * 4 + kScale: return L::template run<TF32, kScale, kTma>(a...);
    case kF32 * 4 + kL2: return L::template run<TF32, kL2, kTma>(a...);
    case kF32 * 4 + kDot: return L::template run<TF32, kDot, kTma>(a...);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <class L, class... A>
int dispatch_leg(int elem, int epi, bool tma, A... a) {
  return tma ? dispatch_kind<L, true>(elem, epi, a...)
             : dispatch_kind<L, false>(elem, epi, a...);
}

// -- The ring -------------------------------------------------------------

// Shared state of the ring: ring_n stages of kStageBytes (row box, then
// query box), 1024-byte aligned, with a full and an empty barrier each.
struct Ring {
  uint8_t* base;
  uint64_t* full;
  uint64_t* empty;
  int n;
};

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  const uint32_t s = smem_u32(p);
  return p + ((1024 - (s & 1023)) & 1023);
}

// Thread 0: full barriers take the producer's one arrival (plus the TMA
// bytes), empty barriers one arrival per consumer warp. The caller
// synchronizes the block before the roles split.
__device__ __forceinline__ void ring_init(const Ring& r) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < r.n; ++s) {
      mbar_init(&r.full[s], 1);
      mbar_init(&r.empty[s], kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
}

// The loads of one launch. Row tile t covers rows [t * kTileRows, + 128)
// of x; the query group starts at query q0.
struct Loads {
  const int8_t* x;    // (n, row_bytes)
  const int8_t* q;    // (b, row_bytes); packed int4 (b, 2 * row_bytes)
  int n, b;
};

// The producer warp's copy of one stage without TMA: the row tile's and
// the query group's k-block kb (packed int4: the high query half when hi)
// into the swizzled layout TMA would write, zeros outside the data.
template <class Kind>
__device__ void copy_stage(const Loads& ld, const Geometry& geo, int t,
                           int q0, int kb, bool hi, uint8_t* rows,
                           uint8_t* qs) {
  const int lane = threadIdx.x & 31;
  const int rb = geo.row_bytes;
  for (int e = lane; e < kTileRows * kKBlock; e += 32) {
    const int r = e / kKBlock, c = e % kKBlock;
    const long gr = (long)t * kTileRows + r;
    const int col = kb * kKBlock + c;
    rows[swizzled(r, c)] =
        gr < ld.n && col < rb ? ld.x[gr * rb + col] : (int8_t)0;
  }
  const int qstride = Kind::kPacked ? 2 * rb : rb;
  const int qcol0 = Kind::kPacked && hi ? rb : 0;
  for (int e = lane; e < kGroup * kKBlock; e += 32) {
    const int r = e / kKBlock, c = e % kKBlock;
    const int qq = q0 + r;
    const int col = kb * kKBlock + c;
    qs[swizzled(r, c)] = qq < ld.b && col < rb
                             ? ld.q[(long)qq * qstride + qcol0 + col]
                             : (int8_t)0;
  }
  // The consumers read the queries through the async proxy (wgmma).
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The roles' register budgets (setmaxnreg: every warp of the warpgroup).
__device__ __forceinline__ void producer_regs() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(kProducerRegs));
}

__device__ __forceinline__ void consumer_regs() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(kConsumerRegs));
}

// The producer warp: fills the ring with the stages of row tiles t0, t0 +
// step, ... < t1, in the order the consumers take them.
template <class Kind, bool kTma>
__device__ void produce(const Maps& maps, const Loads& ld,
                        const Geometry& geo, const Ring& ring, int q0,
                        int t0, int t1, int step) {
  const int lane = threadIdx.x & 31;
  int stage = 0, phase = 0;
  for (int t = t0; t < t1; t += step) {
    for (int v = 0; v < geo.nv; ++v) {
      const bool hi = Kind::kPacked && v >= geo.kbs;
      const int kb = hi ? v - geo.kbs : v;
      mbar_wait(&ring.empty[stage], phase ^ 1);
      uint8_t* rows = ring.base + stage * kStageBytes;
      uint8_t* qs = rows + kRowBox;
      if constexpr (kTma) {
        if (lane == 0) {
          mbar_expect(&ring.full[stage], kStageBytes);
          tma_load(rows, &maps.x, kb * kKBlock, t * kTileRows,
                   &ring.full[stage]);
          tma_load(qs, hi ? &maps.q_hi : &maps.q, kb * kKBlock, q0,
                   &ring.full[stage]);
        }
      } else {
        copy_stage<Kind>(ld, geo, t, q0, kb, hi, rows, qs);
        __syncwarp();
        if (lane == 0) mbar_arrive(&ring.full[stage]);
      }
      if (++stage == ring.n) {
        stage = 0;
        phase ^= 1;
      }
    }
  }
}

// A consumer warpgroup's dots of one row tile: acc[i] ends as the dot of
// tile row tile_row(i) with query group column query_col(i). Walks the
// tile's stages in the producer's order, advancing (stage, phase).
template <class Kind>
__device__ __forceinline__ void consume_tile(typename Kind::Acc (&acc)[kAcc],
                                             const Geometry& geo,
                                             const Ring& ring, int& stage,
                                             int& phase) {
  const int lane = threadIdx.x & 31;
  // ldmatrix.x4: lanes 8j..8j+7 address matrix j, the rows 0-7 (j even)
  // or 8-15 (j odd) of this warp's 16 and the k-step's low (j < 2) or high
  // 16 bytes. Register j then holds the A fragment's word j.
  const int r = (threadIdx.x >> 5) * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int chunk_hi = lane >> 4;
  for (int v = 0; v < geo.nv; ++v) {
    const bool hi = Kind::kPacked && v >= geo.kbs;
    mbar_wait(&ring.full[stage], phase);
    const uint8_t* rows = ring.base + stage * kStageBytes;
    const uint32_t rows_a = smem_u32(rows) + r * kKBlock;
    const uint32_t qs_a = smem_u32(rows + kRowBox);
    uint32_t a[kKSteps][4];
#pragma unroll
    for (int s = 0; s < kKSteps; ++s) {
      ldmatrix_x4(a[s], rows_a + ((((2 * s + chunk_hi) ^ lane) & 7) << 4));
      Kind::a_in(a[s], hi);
    }
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int s = 0; s < kKSteps; ++s) {
      // tools/kernel_probe.py builds the ring alone without the MMAs; such
      // a build returns wrong results by design.
#ifndef VROD_PROBE_NO_MMA
      Kind::mma(acc, a[s], sw128_desc(qs_a + s * 32), v > 0 || s > 0);
#endif
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    __syncwarp();
    if (lane == 0) mbar_arrive(&ring.empty[stage]);
    if (++stage == ring.n) {
      stage = 0;
      phase ^= 1;
    }
  }
}

// Where acc[i] of this consumer thread lies: the wgmma accumulator layout
// (warp w of the two warpgroups owns tile rows 16w..16w+15; lane 4g + t
// holds rows g and g + 8 of them, query columns 8j + 2t and 8j + 2t + 1).
__device__ __forceinline__ int tile_row(int i) {
  return (threadIdx.x >> 5) * 16 + ((threadIdx.x & 31) >> 2) + ((i >> 1) & 1) * 8;
}

__device__ __forceinline__ int query_col(int i) {
  return (i >> 2) * 8 + (threadIdx.x & 3) * 2 + (i & 1);
}

// -- Host: tensor maps ----------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, found in the loaded libcuda (no
// link-time dependency on the driver library).
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* h = dlopen("libcuda.so.1", RTLD_LAZY | RTLD_NOLOAD);
    if (h == nullptr) h = dlopen("libcuda.so.1", RTLD_LAZY);
    return h ? reinterpret_cast<EncodeTiled>(
                   dlsym(h, "cuTensorMapEncodeTiled"))
             : nullptr;
  }();
  return fn;
}

// A byte matrix (outer, inner) with row stride `stride`, loaded in boxes of
// box_outer rows x 128 bytes with the 128-byte swizzle; out of bounds reads
// as zero.
inline int encode_map(CUtensorMap* m, const void* base, int inner,
                      long outer, long stride, int box_outer) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorSharedObjectSymbolNotFound;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)stride};
  const cuuint32_t box[2] = {(cuuint32_t)kKBlock, (cuuint32_t)box_outer};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(m, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
                        const_cast<void*>(base), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// The maps of a launch on rows x (n, row_bytes) and queries q (b,
// row_bytes; packed int4 (b, 2 * row_bytes), split into its halves).
inline int make_maps(Maps* m, bool packed, const void* x, const void* q,
                     int n, int b, int row_bytes) {
  int e = encode_map(&m->x, x, row_bytes, n, row_bytes, kTileRows);
  if (e != 0) return e;
  const long qstride = packed ? 2L * row_bytes : row_bytes;
  e = encode_map(&m->q, q, row_bytes, b, qstride, kGroup);
  if (e != 0 || !packed) {
    m->q_hi = m->q;
    return e;
  }
  return encode_map(&m->q_hi, static_cast<const int8_t*>(q) + row_bytes,
                    row_bytes, b, qstride, kGroup);
}

}  // namespace vrod
