// The scoring core shared by the fused top-k scan (K1, fused_topk.cu), the
// sampled sub-max pre-pass (K3, sampled_submax.cu) and the one-launch
// sampled floor (X6/X8, fused_theta.cu), for Hopper (sm_90a).
//
// The kernels score rows against queries with the SAME device code: the
// same producer, the same ring, the same wgmma instructions in the same
// order, so their scores agree bit for bit. The engine's sampled floor is
// sound only if K3's sub-maxima are true elements of K1's score space
// (vrod_tpu/engine.py:191-202), and fused_theta's margin 0 only if its
// sample's scores are its scan's.
//
// The product. Rows are the wgmma M side, in 64-row warpgroup tiles; the
// queries are the N side, a group of kN of them per block (K1's long scans and
// X6/X8: 64, topk.cuh's kWidth; the blocks of a part read each row tile from L2
// once per group). A block has two consumer warpgroups and a producer
// warpgroup, of which one warp loads (the copying build: all four) and the
// others only hand their registers to the consumers (setmaxnreg). The producer
// warp walks the block's row tiles (128 rows, kTileRows) in k-blocks of 128
// bytes of dim; per k-block it loads the row tile's slice (16 KB) and the query
// group's slice (kN x 128 bytes) into one stage of a ring in shared memory, by
// TMA with the 128-byte swizzle, and signals the stage's full barrier
// (mbarrier, transaction bytes). Each consumer warpgroup takes its 64 rows of
// the stage into registers (ldmatrix: the swizzle makes the eight rows of each
// 8x16-byte matrix hit distinct banks), applies its kind's transform, and
// issues wgmma m64nN with A from registers and B (the queries) from shared
// memory, then releases the stage (empty barrier) once its wgmmas have
// completed. The queries stream with the rows, so any dim fits the same stage.
// A from registers is what lets one core serve every kind:
//   kind  rows          query          transform in registers  wgmma
//   I8    int8          int8           none                    m64nNk32 s8
//   I4    packed int4   int8 (full D)  nibbles -> s8 (lo or hi  m64nNk32 s8
//                                      half of each k-block)
//   BF16  bfloat16      bfloat16       none                    m64nNk16 bf16
//   TF32  float32       float32, TF32  cvt.rna to TF32         m64nNk8 tf32
//                       (the wrapper)
//   F32X3 float32       its TF32 big   split into TF32 big     m64nNk8 tf32,
//                       and small      and small parts         three products
//                       parts (the
//                       wrapper)
// The tensor cores read the low 13 mantissa bits of a TF32 operand as zero
// (truncation); rounding both operands to nearest first keeps the scorer
// the plain version's (cuda_topk.tf32_round). F32X3 is float32 at the
// precisions "high" and "exact" (the TPU kernel's HIGHEST): each operand v
// splits into big = tf32(v) and small = tf32(v - big), and the dot sums
// the exact products big.big + small.big + big.small in float32 (the
// dropped small.small and small's rounding are below 2^-21 of |x_i q_i|).
// Its query comes in two halves, the big parts then the small parts, each
// through its own query tensor map, and per k-block it issues, k-step by
// k-step, big.Qbig, then small.Qbig, then big.Qsmall (Walk: at groups of up
// to 128 queries one stage holds the row box and both halves, so each A
// fragment is loaded and split once for its three products; at 256 two
// stages a k-block in turn, the same wgmmas in the same order). Each wgmma
// k-step is 32 bytes of dim for every kind, so a k-block is four k-steps.
// Packed int4 walks its row k-blocks twice: low nibbles against query
// bytes [0, D/2) and high nibbles against [D/2, D) (distances.pack_int4),
// each from its own query tensor map. Bytes past the row (and rows or
// queries past the end) load as zeros (TMA's out-of-bounds fill), which add
// nothing to a dot: 0 as int8, an int4 nibble pair, bf16 and float32.
//
// Every kernel of the port takes F32X3 where it takes float32 rows: K1, K3,
// X6/X8 and the extraction experiments X1-X4.
//
// The query group is 64 wide for K1's long scans and X6/X8 (topk.cuh's
// kWidth); the sampled sub-max pre-pass (K3) takes groups of 64 or 128,
// K1's small scans groups of 16 and X1's floor 256 (kGroup): the same
// instructions at another N, over the same k-steps in the same order
// (chip_smoke.py holds K3's maxima to both K1 paths' scores bit for bit on
// every leg). Every function of the core takes the width kN as a template
// parameter, 256 by default.
//
// The mask of a row comes from the row's live bit and bias (RowMask: -inf
// on a dead slot, else the bias, int8/int4 + l2's -|x_hat|^2, else 0),
// read by the kernels themselves, so no call builds an (n,) mask first;
// the extraction and floor experiments keep their float mask (FloatMask).
//
// Shapes TMA cannot take (row bytes not a multiple of 16, or unaligned
// bases: int8 dim 30 or 100, bfloat16 dim 100, float32 dim 25, packed int4
// D/2 = 15) take the same kernel with the whole producer warpgroup copying
// each stage into the same swizzled layout (kTma = false): a shape
// dispatch, chosen on the host, which also picks the copy's granule (a
// runtime argument, Maps::granule), the widest of 8 and 4 bytes that
// divides the row bytes and the rows' and the query's bases: each granule
// one cp.async straight to its swizzled place (no granule of 16 bytes or
// less crosses a 16-byte chunk of the swizzle), the stage's full barrier
// armed by the 128 copying threads' cp.async.mbarrier.arrive, so that the
// producer runs ahead by the whole ring as TMA does. Granules of 2 and 1
// bytes (int8 dim 30, packed int4 D/2 = 15) copy by plain loads, eight in
// flight a thread. The consumers fence the async proxy after each wait
// (the copies write through the generic proxy, wgmma reads the queries
// through the async one).
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

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <type_traits>
#include <utility>
#include <cuda.h>
#include <cuda_runtime.h>

namespace vrod {

constexpr int kTileRows = 128;                 // rows per tile (2 x m64)
constexpr int kGroup = 256;                    // queries per block: X1 floor, default kN
constexpr int kKBlock = 128;                   // dim bytes per stage
constexpr int kKSteps = kKBlock / 32;          // wgmma k-steps per stage
constexpr int kConsumers = 256;                // two consumer warpgroups
constexpr int kThreads = kConsumers + 128;     // and a producer warpgroup
// Registers per thread after setmaxnreg: the producer warpgroup gives its
// registers to the consumers, whose accumulators need them (at the
// launch's even split of 168 ptxas serializes the wgmmas of 128).
// setmaxnreg.inc takes only what other warps of the block released: the
// split keeps the launch's 168 a thread in all (kThreads x 168). K1's
// kernels and X6/X8 (topk.cuh's gated core, whose consumers need fewer
// than 232) take kGateProducerRegs / kGateConsumerRegs; every other
// kernel, the copying builds included (the copy keeps its loads in flight
// by cp.async, not in registers), kProducerRegs / kConsumerRegs.
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kGateProducerRegs = 56;
constexpr int kGateConsumerRegs = 224;
static_assert(kConsumers * kConsumerRegs + 128 * kProducerRegs ==
                  kThreads * 168 &&
              kConsumers * kGateConsumerRegs + 128 * kGateProducerRegs ==
                  kThreads * 168,
              "register file: the launch's share");
constexpr int kAcc = kGroup / 2;               // accumulators per thread
constexpr int kRowBox = kTileRows * kKBlock;   // 16 KB
constexpr int kQueryBox = kGroup * kKBlock;    // 32 KB
constexpr int kStageBytes = kRowBox + kQueryBox;
// A stage of a kN-query group of a kind, the bytes its loads bring: the
// row box, then kN query rows (F32X3 at kN <= 128: kN rows of the query's
// big parts, then kN of its small parts; Walk).
template <class Kind>
__host__ __device__ constexpr int loaded_bytes(int kN) {
  return kRowBox + (Kind::kSplit && kN <= 128 ? 2 : 1) * kN * kKBlock;
}
template <class Kind>
__host__ __device__ constexpr int stage_bytes(int kN) {
#ifdef VROD_PROBE_PRESPLIT
  return loaded_bytes<Kind>(kN) + (Kind::kSplit && kN <= 128 ? kRowBox : 0);
#else
  return loaded_bytes<Kind>(kN);
#endif
}
// tools/kernel_probe.py --f32x3 (VROD_PROBE_PRESPLIT): the rows' small
// parts, which the producer warpgroup writes past the query boxes.
template <int kN>
__host__ __device__ constexpr int presplit_offset() {
  return kRowBox + 2 * kN * kKBlock;
}
constexpr int kMaxCluster = 8;                 // portable cluster size

// Host codes of the element kinds and epilogues (ops/cuda_topk.py).
enum Elem : int { kI8 = 0, kI4 = 1, kBF16 = 2, kF32 = 3, kF32X3 = 4 };
enum Epi : int { kScale = 0, kScaleQs = 1, kL2 = 2, kDot = 3 };

// One launch's geometry: the stored row's bytes, and the k-blocks a tile
// walks (Walk: packed int4 each row k-block twice, low then high nibbles;
// F32X3 at kN 256 two stages a k-block).
struct Geometry {
  int row_bytes;  // bytes per stored row
  int kbs;        // k-blocks per row
  int nv;         // stages per tile
};

// How a kind walks a row tile's k-blocks at group width kN: one stage a
// k-block, but packed int4 walks them all twice (low nibbles, then high:
// stage v >= kbs takes the query's second half), and F32X3 (its query in
// two halves, big then small parts) either in one walk whose stages hold
// both halves (kBoth: groups of up to 128 queries, 32 KB stages at n64) or,
// at kN 256, where such a stage would be 80 KB, in pairs of stages (kb,
// big) then (kb, small) (kPairs, 48 KB stages). Both F32X3 walks issue the
// same wgmmas in the same order, so every width's scores agree bit for
// bit.
template <class Kind, int kN>
struct Walk {
  static constexpr bool kBoth = Kind::kSplit && kN <= 128;
  static constexpr bool kPairs = Kind::kSplit && !kBoth;
  // tools/kernel_probe.py --f32x3 (VROD_PROBE_ONE_WALK): the pairs' first
  // stages alone (wrong results by design; the one walk has no second).
#ifdef VROD_PROBE_ONE_WALK
  static constexpr bool kTwice = Kind::kPacked;
#else
  static constexpr bool kTwice = Kind::kPacked || kPairs;
#endif
  __host__ __device__ static int stages(int kbs) {
    return kTwice ? 2 * kbs : kbs;
  }
  // Stage v's k-block, and whether it takes the query's second half.
  __device__ static int kb(const Geometry& g, int v) {
    if constexpr (Kind::kPacked) {
      return v >= g.kbs ? v - g.kbs : v;
    } else if constexpr (kTwice) {
      return v >> 1;
    } else {
      return v;
    }
  }
  __device__ static bool hi(const Geometry& g, int v) {
    if constexpr (Kind::kPacked) {
      return v >= g.kbs;
    } else if constexpr (kTwice) {
      return (v & 1) != 0;
    } else {
      return false;
    }
  }
};

template <class Kind, int kN>
__host__ __device__ inline Geometry make_geometry(int row_bytes) {
  const int kbs = (row_bytes + kKBlock - 1) / kKBlock;
  return Geometry{row_bytes, kbs, Walk<Kind, kN>::stages(kbs)};
}

// How a launch loads its stages: the three tensor maps of the TMA build
// (rows, queries (packed int4: the low half), and the packed int4 queries'
// high half), and the copying build's granule, the bytes each of its
// copies moves (8, 4, 2 or 1; 16 is the TMA build's shape).
struct Maps {
  CUtensorMap x, q, q_hi;
  int granule;
};

// The additive mask of row r as K1 and K3 read it: -inf on a dead slot,
// else the row's bias (nullptr: 0). The plain versions' mask tensor holds
// the same values (ops/cuda_topk.py: _Call.mask). A consumer fetches a
// tile's rows (and their aux) before its dots and takes value() after
// them: the loads are asm volatile, so they stay ahead of the ring's waits
// and the wgmmas and their latency hides under the dots (left to the
// compiler, the loads sank to their use and cost K1 ~4% at the headline).
__device__ __forceinline__ uint32_t ldg_u8(const uint8_t* p) {
  uint32_t v;
  asm volatile("ld.global.nc.u8 %0, [%1];\n" : "=r"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ float ldg_f32(const float* p) {
  float v;
  asm volatile("ld.global.nc.f32 %0, [%1];\n" : "=f"(v) : "l"(p));
  return v;
}

struct RowMask {
  const uint8_t* valid;  // (n,) bool
  const float* bias;     // (n,) or nullptr
  struct Raw {
    uint32_t live;
    float bias;
  };
  __device__ __forceinline__ Raw fetch(long r) const {
    return Raw{ldg_u8(valid + r), bias != nullptr ? ldg_f32(bias + r) : 0.0f};
  }
  __device__ __forceinline__ static float value(const Raw& m) {
    return m.live == 0 ? -INFINITY : m.bias;
  }
};

// A mask given as one float per row (the floor and extraction experiments).
struct FloatMask {
  const float* mask;
  using Raw = float;
  __device__ __forceinline__ float fetch(long r) const {
    return ldg_f32(mask + r);
  }
  __device__ __forceinline__ static float value(float m) { return m; }
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

// -- Clusters: rank, barrier, and a peer block's shared memory ----------

__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return (int)r;
}

// Every thread of every block of the cluster: the shared memory writes
// before it are visible to the whole cluster after it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The address of `p` (this block's shared memory) in block `rank` of the
// cluster.
__device__ __forceinline__ uint32_t peer_addr(const void* p, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r) : "r"(smem_u32(p)), "r"(rank));
  return r;
}

__device__ __forceinline__ float ld_peer_f32(uint32_t a) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(a)
               : "memory");
  return v;
}

__device__ __forceinline__ int ld_peer_s32(uint32_t a) {
  int v;
  asm volatile("ld.shared::cluster.s32 %0, [%1];\n" : "=r"(v) : "r"(a)
               : "memory");
  return v;
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(kConsumers) : "memory");
}

// The ping-pong of the two consumer warpgroups over the tensor cores (K1's
// scan from a floor, fused_topk_floor.cu): warpgroup wg (consumer threads
// 128 wg .. 128 wg + 127) waits on named barrier kBarTurn + wg for its
// turn, which the other warpgroup hands over by arriving there. The ids
// are apart from consumer_sync's 1 and topk.cuh's vote barriers (2, 4).
constexpr int kBarTurn = 5;

__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(kBarTurn + wg), "n"(kConsumers)
               : "memory");
}

__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, %1;\n"
               :: "r"(kBarTurn + (wg ^ 1)), "n"(kConsumers) : "memory");
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
#define VROD_ACC_REGS_64                                               \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "  \
  "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "  \
  "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "  \
  "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "                \
  "{%64, %65, %66, %67}, %68, p"
#define VROD_SETP_64 "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
#define VROD_ACC_REGS_32                                               \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "  \
  "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p"
#define VROD_SETP_32 "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
#define VROD_ACC_REGS_8                                                \
  "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p"
#define VROD_SETP_8 "{\n .reg .pred p;\n setp.ne.b32 p, %13, 0;\n"
#define VROD_D64(c, d) VROD_D32(c, d, 0), VROD_D32(c, d, 32)
#define VROD_D32N(c, d) VROD_D32(c, d, 0)
#define VROD_D8N(c, d) VROD_D8(c, d, 0)
// One wgmma of a kind at the group width kN (256, 128, 64 or 16): SHAPE is
// the instruction's k and types, TAIL its immediates after the predicate.
#define VROD_WGMMA(SHAPE, TAIL, C)                                          \
  if constexpr (kN == 256) {                                                \
    asm volatile(VROD_SETP " wgmma.mma_async.sync.aligned.m64n256" SHAPE   \
                 " " VROD_ACC_REGS TAIL ";\n}\n"                           \
                 : VROD_D128(C, d) : VROD_IN(a, desc, scale));              \
  } else if constexpr (kN == 128) {                                         \
    asm volatile(VROD_SETP_64 " wgmma.mma_async.sync.aligned.m64n128"      \
                 SHAPE " " VROD_ACC_REGS_64 TAIL ";\n}\n"                  \
                 : VROD_D64(C, d) : VROD_IN(a, desc, scale));               \
  } else if constexpr (kN == 64) {                                          \
    asm volatile(VROD_SETP_32 " wgmma.mma_async.sync.aligned.m64n64"       \
                 SHAPE " " VROD_ACC_REGS_32 TAIL ";\n}\n"                  \
                 : VROD_D32N(C, d) : VROD_IN(a, desc, scale));              \
  } else {                                                                  \
    static_assert(kN == 16, "group widths 256, 128, 64, 16");               \
    asm volatile(VROD_SETP_8 " wgmma.mma_async.sync.aligned.m64n16"        \
                 SHAPE " " VROD_ACC_REGS_8 TAIL ";\n}\n"                   \
                 : VROD_D8N(C, d) : VROD_IN(a, desc, scale));               \
  }
#define VROD_R(v) "+r"(v)
#define VROD_F(v) "+f"(v)
#define VROD_IN(a, desc, scale)                                         \
  "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale)

// -- The element kinds: register transform of A, and the wgmma -----------

struct I8 {
  using Acc = int;
  static constexpr bool kPacked = false;
  static constexpr bool kSplit = false;
  static constexpr bool kHalves = false;  // the query in two halves
  __device__ static void a_in(uint32_t (&)[4], bool) {}
  template <int kN>
  __device__ static void mma(Acc (&d)[kN / 2], const uint32_t (&a)[4],
                             uint64_t desc, int scale) {
    VROD_WGMMA("k32.s32.s8.s8", "", VROD_R)
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
  static constexpr bool kHalves = true;
  __device__ static void a_in(uint32_t (&a)[4], bool hi) {
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = nibbles(a[i], hi);
  }
};

struct BF16 {
  using Acc = float;
  static constexpr bool kPacked = false;
  static constexpr bool kSplit = false;
  static constexpr bool kHalves = false;
  __device__ static void a_in(uint32_t (&)[4], bool) {}
  template <int kN>
  __device__ static void mma(Acc (&d)[kN / 2], const uint32_t (&a)[4],
                             uint64_t desc, int scale) {
    VROD_WGMMA("k16.f32.bf16.bf16", ", 1, 1, 0", VROD_F)
  }
};

// float32 -> TF32 (10 mantissa bits), to nearest, ties away from zero.
__device__ __forceinline__ uint32_t tf32(uint32_t w) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(__uint_as_float(w)));
  return r;
}

// The same rounding on the bits (add half of the dropped ulp to the
// magnitude, then drop the low 13 bits): cuda_topk.tf32_round's formula,
// equal to cvt.rna.tf32.f32 on every finite value, in two integer
// instructions.
__device__ __forceinline__ uint32_t tf32_bits(uint32_t w) {
#ifdef VROD_PROBE_CVT_SPLIT
  // tools/kernel_probe.py --f32x3: the split by cvt.rna.tf32.f32.
  return tf32(w);
#else
  return (w + 0x1000u) & 0xffffe000u;
#endif
}

struct TF32 {
  using Acc = float;
  static constexpr bool kPacked = false;
  static constexpr bool kSplit = false;
  static constexpr bool kHalves = false;
  __device__ static void a_in(uint32_t (&a)[4], bool) {
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = tf32(a[i]);
  }
  template <int kN>
  __device__ static void mma(Acc (&d)[kN / 2], const uint32_t (&a)[4],
                             uint64_t desc, int scale) {
    VROD_WGMMA("k8.f32.tf32.tf32", ", 1, 1", VROD_F)
  }
};

// float32 in three TF32 products: the wrapper gives the query as (b, 2 *
// dim), its big parts then its small parts (kHalves: two query maps; Walk
// says how a tile takes them); issue_stage splits the rows' registers.
struct F32X3 : TF32 {
  static constexpr bool kSplit = true;
  static constexpr bool kHalves = true;
  __device__ static void a_in(uint32_t (&)[4], bool) {}
  // The big parts alone (a stage of the query's small half: their small
  // parts meet nothing there).
  __device__ static void big(uint32_t (&a)[4]) {
#ifndef VROD_PROBE_NO_SPLIT
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = tf32_bits(a[i]);
#endif
  }
  // a -> its big part, small -> its small part (v - big is exact).
  __device__ static void split(uint32_t (&a)[4], uint32_t (&small)[4]) {
#ifdef VROD_PROBE_NO_SPLIT
    // tools/kernel_probe.py --f32x3: the products without the split (wrong
    // results by design).
#pragma unroll
    for (int i = 0; i < 4; ++i) small[i] = a[i];
    return;
#endif
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t big = tf32_bits(a[i]);
      small[i] = tf32_bits(__float_as_uint(
          __fsub_rn(__uint_as_float(a[i]), __uint_as_float(big))));
      a[i] = big;
    }
  }
};

// Calls L::run<F32X3, kEpi, kTma>(a...) for the f32x3 leg of epilogue code
// epi (kScale, kL2, kDot).
template <class L, bool kTma, class... A>
int dispatch_f32x3(int epi, A... a) {
  switch (epi) {
    case kScale: return L::template run<F32X3, kScale, kTma>(a...);
    case kL2: return L::template run<F32X3, kL2, kTma>(a...);
    case kDot: return L::template run<F32X3, kDot, kTma>(a...);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The f32x3 legs alone, for a source that builds them apart from its
// other legs (fused_theta_f32x3.cu), so that nvcc compiles both halves at
// once.
template <class L, class... A>
int dispatch_split(int epi, bool tma, A... a) {
  return tma ? dispatch_f32x3<L, true>(epi, a...)
             : dispatch_f32x3<L, false>(epi, a...);
}

// Calls L::run<Kind, kEpi, kTma>(a...) for the leg of host codes (elem,
// epi): the integer kinds take kScale (cosine, dot) and kScaleQs (l2), the
// float kinds kScale (cosine), kL2 and kDot. F32X3 is built only where
// kSplitF32 (K1 and K3; X6/X8 build it apart, by dispatch_split).
template <class L, bool kTma, bool kSplitF32, class... A>
int dispatch_kind(int elem, int epi, A... a) {
  if constexpr (kSplitF32) {
    if (elem == kF32X3) return dispatch_f32x3<L, kTma>(epi, a...);
  }
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

template <class L, bool kSplitF32 = false, class... A>
int dispatch_leg(int elem, int epi, bool tma, A... a) {
  return tma ? dispatch_kind<L, true, kSplitF32>(elem, epi, a...)
             : dispatch_kind<L, false, kSplitF32>(elem, epi, a...);
}

// -- The ring -------------------------------------------------------------

// Shared state of the ring: ring_n stages of kStageBytes (row box, then
// query box), 1024-byte aligned, with a full and an empty barrier each;
// copy: the copying build's ring (kTma false), filled by the producer
// warpgroup's copies.
struct Ring {
  uint8_t* base;
  uint64_t* full;
  uint64_t* empty;
  int n;
  bool copy;
#ifdef VROD_PROBE_PRESPLIT
  // K1's gated core, TMA build: a stage's rows split by the producer
  // (kPresplitters arrivals); consumers wait here, not on full.
  uint64_t* ready;
#endif
};

#ifdef VROD_PROBE_PRESPLIT
constexpr int kPresplitters = 96;  // producer warps 1-3

// The barrier a consumer waits on for a stage.
__device__ __forceinline__ uint64_t* stage_ready(const Ring& r, int s) {
  return r.ready != nullptr ? &r.ready[s] : &r.full[s];
}
#endif

constexpr int kCopyThreads = 128;  // the producer warpgroup, copying

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  const uint32_t s = smem_u32(p);
  return p + ((1024 - (s & 1023)) & 1023);
}

// Thread 0: full barriers take the producer's one arrival (plus the TMA
// bytes), or in the copying build one arrival of each copying thread;
// empty barriers one arrival per consumer warp. The caller synchronizes
// the block before the roles split.
__device__ __forceinline__ void ring_init(const Ring& r) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < r.n; ++s) {
      mbar_init(&r.full[s], r.copy ? kCopyThreads : 1);
      mbar_init(&r.empty[s], kConsumers / 32);
#ifdef VROD_PROBE_PRESPLIT
      if (r.ready != nullptr) mbar_init(&r.ready[s], kPresplitters);
#endif
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

// Whether this thread of the producer warpgroup fills the ring: one warp
// issues the TMA loads, the whole warpgroup copies.
template <bool kTma>
__device__ __forceinline__ bool ring_loader() {
#ifdef VROD_PROBE_PRESPLIT
  return true;  // produce_stages sends the idle warps home
#else
  return !kTma || threadIdx.x < kConsumers + 32;
#endif
}

// One asynchronous copy of kBytes (4 or 8) from global to shared memory;
// src_bytes 0 writes zeros and reads nothing.
template <int kBytes>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
               :: "r"(dst), "l"(src), "n"(kBytes), "r"(src_bytes)
               : "memory");
}

// The full barrier's arrival of this thread once its cp.async's so far
// have landed (noinc: the barrier counts the copying threads).
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// A plain store of a byte or of two bytes to shared memory.
__device__ __forceinline__ void st_shared(uint32_t a, uint8_t v) {
  asm volatile("st.shared.u8 [%0], %1;\n"
               :: "r"(a), "h"((unsigned short)v) : "memory");
}

__device__ __forceinline__ void st_shared(uint32_t a, uint16_t v) {
  asm volatile("st.shared.u16 [%0], %1;\n" :: "r"(a), "h"(v) : "memory");
}

// A box of `rows` rows x 128 bytes into the swizzled layout TMA would
// write at shared address dst, by copying thread p of kCopyThreads:
// columns [0, w) of the first `live` rows (>= 1) from src (row r at src +
// r * stride), zeros elsewhere, in granules of kG bytes. Thread p takes
// column (p * kG) % 128 of every kG-th row from row p * kG / 128. kG 8 or
// 4: cp.async (a zero fill names src and reads nothing); 2 or 1: plain
// loads, eight in flight, then their stores.
template <int kG>
__device__ __forceinline__ void copy_box(uint32_t dst, const int8_t* src,
                                         int stride, int live, int w,
                                         int rows, int p) {
  const int c = p * kG % kKBlock;
  const int r0 = p * kG / kKBlock;
  const bool col = c < w;
  if constexpr (kG >= 4) {
#pragma unroll 2
    for (int r = r0; r < rows; r += kG) {
      const bool in = col && r < live;
      cp_async<kG>(dst + swizzled(r, c), src + (in ? r * stride + c : 0),
                   in ? kG : 0);
    }
  } else {
    using T = std::conditional_t<kG == 2, uint16_t, uint8_t>;
    constexpr int kU = 8;
    for (int r = r0; r < rows; r += kU * kG) {
      T v[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int ru = r + u * kG;
        v[u] = col && ru < live
                   ? __ldg(reinterpret_cast<const T*>(src + ru * stride + c))
                   : T(0);
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        st_shared(dst + swizzled(r + u * kG, c), v[u]);
      }
    }
  }
}

// The producer warpgroup's copy of one stage without TMA, to shared
// address `rows` (the row box, then the query box): the row tile's and the
// query group's k-block kb (a query in halves: the second half when hi;
// Walk's kBoth: both halves, one box each) by granules of kG bytes, zeros
// past the row (the last k-block's columns from row_bytes), past n and
// past b; then this thread's arrival on the stage's full barrier.
template <class Kind, int kN, int kG>
__device__ __forceinline__ void copy_stage(const Loads& ld,
                                           const Geometry& geo, int t,
                                           int q0, int kb, bool hi,
                                           uint32_t rows, uint64_t* full) {
  // Every box is whole rounds of the plain loads' eight rows a thread.
  static_assert(kN % 16 == 0, "copy rounds");
  const int p = threadIdx.x - kConsumers;
  const int rb = geo.row_bytes;
  const int w = min(kKBlock, rb - kb * kKBlock);
  const int r0 = t * kTileRows;  // < n
  copy_box<kG>(rows, ld.x + (long)r0 * rb + kb * kKBlock, rb,
               min(kTileRows, ld.n - r0), w, kTileRows, p);
  const int qstride = Kind::kHalves ? 2 * rb : rb;
  const int qcol0 = Kind::kHalves && hi ? rb : 0;
  copy_box<kG>(rows + kRowBox,
               ld.q + (long)q0 * qstride + qcol0 + kb * kKBlock, qstride,
               min(kN, ld.b - q0), w, kN, p);
  if constexpr (Walk<Kind, kN>::kBoth) {
    copy_box<kG>(rows + kRowBox + kN * kKBlock,
                 ld.q + (long)q0 * qstride + rb + kb * kKBlock, qstride,
                 min(kN, ld.b - q0), w, kN, p);
  }
  if constexpr (kG >= 4) {
    cp_async_arrive(full);
  } else {
    mbar_arrive(full);
  }
}

// The roles' register budgets (setmaxnreg: every warp of the warpgroup).
template <int kRegs = kProducerRegs>
__device__ __forceinline__ void producer_regs() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(kRegs));
}

template <int kRegs = kConsumerRegs>
__device__ __forceinline__ void consumer_regs() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(kRegs));
}

#ifdef VROD_PROBE_PRESPLIT
// The split of stage s's rows by producer warps 1-3 once its loads landed:
// the big parts in place, the small parts at presplit_offset, in the same
// swizzled layout; then their arrival on its ready barrier.
template <class Kind, int kN>
__device__ __forceinline__ void presplit_stage(const Ring& ring, int s,
                                               int phase) {
  mbar_wait(&ring.full[s], phase);
  const uint32_t big = smem_u32(ring.base + s * stage_bytes<Kind>(kN));
  const uint32_t small = big + presplit_offset<kN>();
  for (int c = threadIdx.x - kConsumers - 32; c < kRowBox / 16;
       c += kPresplitters) {
    uint32_t a[4], sm[4];
    asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
                 : "r"(big + 16 * c) : "memory");
    Kind::split(a, sm);
    asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n"
                 :: "r"(big + 16 * c), "r"(a[0]), "r"(a[1]), "r"(a[2]),
                    "r"(a[3]) : "memory");
    asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n"
                 :: "r"(small + 16 * c), "r"(sm[0]), "r"(sm[1]), "r"(sm[2]),
                    "r"(sm[3]) : "memory");
  }
  // The stage's next load (async proxy) comes after these writes.
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  mbar_arrive(&ring.ready[s]);
}
#endif

// The producer: fills the ring with the stages of row tiles t0, t0 +
// step, ... < t1, in the order the consumers take them, from ring position
// (stage, phase), which it advances (a kernel with two passes over the
// rows continues the ring where the first pass left it). Called by the
// ring's loaders (ring_loader): the TMA build's warp, whose lane 0 issues
// the loads, or the copying build's warpgroup, which copies by granules
// of kG bytes and waits on no copy before the next stage.
template <class Kind, bool kTma, int kN, int kG>
__device__ __forceinline__ void produce_stages(
    const Maps& maps, const Loads& ld, const Geometry& geo, const Ring& ring,
    int q0, int t0, int t1, int step, int& stage, int& phase) {
  using W = Walk<Kind, kN>;
#ifdef VROD_PROBE_PRESPLIT
  if constexpr (kTma && W::kBoth) {
    if (ring.ready != nullptr) {
      // Warp 0 loads stage v while warps 1-3 split stage v - 1.
      const bool loader = threadIdx.x < kConsumers + 32;
      int prev = -1, prev_phase = 0;
      for (int t = t0; t < t1; t += step) {
        for (int v = 0; v < geo.nv; ++v) {
          if (loader) {
            mbar_wait(&ring.empty[stage], phase ^ 1);
            if (threadIdx.x == kConsumers) {
              uint8_t* rows = ring.base + stage * stage_bytes<Kind>(kN);
              const int kb = W::kb(geo, v);
              mbar_expect(&ring.full[stage], loaded_bytes<Kind>(kN));
              tma_load(rows, &maps.x, kb * kKBlock, t * kTileRows,
                       &ring.full[stage]);
              tma_load(rows + kRowBox, &maps.q, kb * kKBlock, q0,
                       &ring.full[stage]);
              tma_load(rows + kRowBox + kN * kKBlock, &maps.q_hi,
                       kb * kKBlock, q0, &ring.full[stage]);
            }
          } else if (prev >= 0) {
            presplit_stage<Kind, kN>(ring, prev, prev_phase);
          }
          prev = stage;
          prev_phase = phase;
          if (++stage == ring.n) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
      if (!loader && prev >= 0) {
        presplit_stage<Kind, kN>(ring, prev, prev_phase);
      }
      return;
    }
  }
  if (kTma && threadIdx.x >= kConsumers + 32) return;
#endif
  for (int t = t0; t < t1; t += step) {
    for (int v = 0; v < geo.nv; ++v) {
      const bool hi = W::hi(geo, v);
      const int kb = W::kb(geo, v);
      mbar_wait(&ring.empty[stage], phase ^ 1);
      uint8_t* rows = ring.base + stage * stage_bytes<Kind>(kN);
      uint8_t* qs = rows + kRowBox;
      if constexpr (kTma) {
        if ((threadIdx.x & 31) == 0) {
          mbar_expect(&ring.full[stage], loaded_bytes<Kind>(kN));
          tma_load(rows, &maps.x, kb * kKBlock, t * kTileRows,
                   &ring.full[stage]);
          tma_load(qs, hi ? &maps.q_hi : &maps.q, kb * kKBlock, q0,
                   &ring.full[stage]);
          if constexpr (W::kBoth) {
            tma_load(qs + kN * kKBlock, &maps.q_hi, kb * kKBlock, q0,
                     &ring.full[stage]);
          }
        }
      } else {
        copy_stage<Kind, kN, kG>(ld, geo, t, q0, kb, hi, smem_u32(rows),
                                 &ring.full[stage]);
      }
      if (++stage == ring.n) {
        stage = 0;
        phase ^= 1;
      }
    }
  }
  // No copying thread leaves with its copies in flight.
  if constexpr (!kTma && kG >= 4) {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  }
}

// produce_stages by the launch's load: TMA, or the copying build's
// granule (maps.granule), chosen once for the whole walk.
template <class Kind, bool kTma, int kN = kGroup>
__device__ __forceinline__ void produce_tiles(
    const Maps& maps, const Loads& ld, const Geometry& geo, const Ring& ring,
    int q0, int t0, int t1, int step, int& stage, int& phase) {
  if constexpr (kTma) {
    produce_stages<Kind, true, kN, 16>(maps, ld, geo, ring, q0, t0, t1, step,
                                       stage, phase);
  } else {
    switch (maps.granule) {
      case 8:
        produce_stages<Kind, false, kN, 8>(maps, ld, geo, ring, q0, t0, t1,
                                           step, stage, phase);
        break;
      case 4:
        produce_stages<Kind, false, kN, 4>(maps, ld, geo, ring, q0, t0, t1,
                                           step, stage, phase);
        break;
      case 2:
        produce_stages<Kind, false, kN, 2>(maps, ld, geo, ring, q0, t0, t1,
                                           step, stage, phase);
        break;
      default:
        produce_stages<Kind, false, kN, 1>(maps, ld, geo, ring, q0, t0, t1,
                                           step, stage, phase);
    }
  }
}

template <class Kind, bool kTma, int kN = kGroup>
__device__ void produce(const Maps& maps, const Loads& ld,
                        const Geometry& geo, const Ring& ring, int q0,
                        int t0, int t1, int step) {
  int stage = 0, phase = 0;
  produce_tiles<Kind, kTma, kN>(maps, ld, geo, ring, q0, t0, t1, step,
                                stage, phase);
}

// Hand a consumed stage back to the producer (one arrival a warp).
__device__ __forceinline__ void release_stage(const Ring& ring, int stage) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(&ring.empty[stage]);
}

// A consumer warp's pass over one row tile's stages without the dots (a
// tile no score of which can count): the producer's stream keeps its shape.
__device__ __forceinline__ void pass_tile(const Geometry& geo,
                                          const Ring& ring, int& stage,
                                          int& phase) {
  for (int v = 0; v < geo.nv; ++v) {
#ifdef VROD_PROBE_PRESPLIT
    mbar_wait(stage_ready(ring, stage), phase);
#else
    mbar_wait(&ring.full[stage], phase);
#endif
    release_stage(ring, stage);
    if (++stage == ring.n) {
      stage = 0;
      phase ^= 1;
    }
  }
}

// The rows' A registers of one stage: a (and F32X3's small parts).
template <class Kind>
struct StageA {
  uint32_t a[kKSteps][4];
  // F32X3: the rows' small parts, multiplied with the query's big part
  // after their big parts.
  uint32_t small[Kind::kSplit ? kKSteps : 1][4];
};

// A consumer warpgroup's wgmmas of stage v of a row tile (Walk: its
// k-block, and the query half it takes), at ring position `stage`: waits
// for the stage, loads this warp's 16 rows into A's registers, applies the
// kind's transform, issues the wgmmas (accumulating from zero at v = 0)
// and commits them as one group. F32X3 issues, k-step by k-step,
// big.Qbig, small.Qbig (a stage of the big half) and big.Qsmall (a stage
// of the small half, or the second box of a stage that holds both).
template <class Kind, int kA>
__device__ __forceinline__ void issue_stage(typename Kind::Acc (&acc)[kA],
                                            StageA<Kind>& st,
                                            const Geometry& geo,
                                            const Ring& ring, int stage,
                                            int phase, int v) {
  constexpr int kN = 2 * kA;
  const int lane = threadIdx.x & 31;
  // ldmatrix.x4: lanes 8j..8j+7 address matrix j, the rows 0-7 (j even)
  // or 8-15 (j odd) of this warp's 16 and the k-step's low (j < 2) or high
  // 16 bytes. Register j then holds the A fragment's word j.
  const int r = (threadIdx.x >> 5) * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int chunk_hi = lane >> 4;
  using W = Walk<Kind, kN>;
  const bool hi = W::hi(geo, v);
#ifdef VROD_PROBE_PRESPLIT
  mbar_wait(stage_ready(ring, stage), phase);
#else
  mbar_wait(&ring.full[stage], phase);
#endif
  // The copying producer's writes went through the generic proxy; wgmma
  // reads the queries through the async proxy.
  if (ring.copy) {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  const uint8_t* rows = ring.base + stage * stage_bytes<Kind>(kN);
  const uint32_t rows_a = smem_u32(rows) + r * kKBlock;
  const uint32_t qs_a = smem_u32(rows + kRowBox);
#pragma unroll
  for (int s = 0; s < kKSteps; ++s) {
    ldmatrix_x4(st.a[s], rows_a + ((((2 * s + chunk_hi) ^ lane) & 7) << 4));
    if constexpr (Kind::kSplit) {
      if (hi) {
        Kind::big(st.a[s]);
      } else {
#ifdef VROD_PROBE_PRESPLIT
        if (ring.ready != nullptr) {
          ldmatrix_x4(st.small[s], rows_a + presplit_offset<kN>() +
                                       ((((2 * s + chunk_hi) ^ lane) & 7)
                                        << 4));
          continue;
        }
#endif
        Kind::split(st.a[s], st.small[s]);
      }
    } else {
      Kind::a_in(st.a[s], hi);
    }
  }
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int s = 0; s < kKSteps; ++s) {
    // tools/kernel_probe.py builds the ring alone without the MMAs; such
    // a build returns wrong results by design.
#ifndef VROD_PROBE_NO_MMA
    Kind::template mma<kN>(acc, st.a[s], sw128_desc(qs_a + s * 32),
                           v > 0 || s > 0);
#endif
  }
  if constexpr (Kind::kSplit) {
    if (!hi) {
#pragma unroll
      for (int s = 0; s < kKSteps; ++s) {
#ifndef VROD_PROBE_NO_MMA
        Kind::template mma<kN>(acc, st.small[s], sw128_desc(qs_a + s * 32),
                               1);
#endif
      }
    }
  }
  if constexpr (W::kBoth) {
    const uint32_t qsmall_a = qs_a + kN * kKBlock;
#pragma unroll
    for (int s = 0; s < kKSteps; ++s) {
#ifndef VROD_PROBE_NO_MMA
      Kind::template mma<kN>(acc, st.a[s], sw128_desc(qsmall_a + s * 32), 1);
#endif
    }
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}


__device__ __forceinline__ void next_stage(const Ring& ring, int& stage,
                                           int& phase) {
  if (++stage == ring.n) {
    stage = 0;
    phase ^= 1;
  }
}

// A consumer warpgroup's dots of stages [v0, v1) of one row tile (its
// k-blocks, packed int4: low then high nibbles): acc[i] accumulates the dot
// of tile row tile_row(i) with query group column query_col(i), from zero
// at stage 0. Walks the stages in the producer's order, advancing (stage,
// phase); each stage's wgmmas complete before it goes back. The ping-pongs
// of extract.cuh and fused_topk_floor.cu signal the other warpgroup
// between two such calls. A walk in pairs of stages (Walk::kPairs: F32X3
// at n256) steps a pair at a time from an even v0 to an even v1, so the
// compiler knows each stage's half of the query and no wgmma sits in a
// branch (which ptxas serializes).
template <class Kind, int kA>
__device__ __forceinline__ void consume_stages(
    typename Kind::Acc (&acc)[kA], const Geometry& geo, const Ring& ring,
    int& stage, int& phase, int v0, int v1) {
  StageA<Kind> st;
  const auto step = [&](int v) {
    issue_stage<Kind>(acc, st, geo, ring, stage, phase, v);
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    release_stage(ring, stage);
    next_stage(ring, stage, phase);
  };
  constexpr bool kPairs = Walk<Kind, 2 * kA>::kPairs;
  for (int v = v0; v < v1; v += kPairs ? 2 : 1) {
    step(v);
    if constexpr (kPairs) step(v + 1);
  }
}

// A consumer warpgroup's dots of one whole row tile.
template <class Kind, int kA>
__device__ __forceinline__ void consume_tile(typename Kind::Acc (&acc)[kA],
                                             const Geometry& geo,
                                             const Ring& ring, int& stage,
                                             int& phase) {
  consume_stages<Kind>(acc, geo, ring, stage, phase, 0, geo.nv);
}

// The same dots with each stage's loads and wgmmas issued while the
// previous stage's wgmmas run: A's registers alternate between two sets,
// and a stage goes back once the next one's group is committed and its
// own has completed (wait_group 1). The wgmmas, and so every
// accumulator's order of sums, are consume_tile's. For narrow groups
// (K3's 64 queries), whose short wgmmas would otherwise leave the tensor
// cores idle while each stage's registers load.
template <class Kind, int kA>
__device__ __forceinline__ void consume_tile_overlap(
    typename Kind::Acc (&acc)[kA], const Geometry& geo, const Ring& ring,
    int& stage, int& phase) {
  StageA<Kind> st[2];
  int held = -1;
  const auto step = [&](StageA<Kind>& s, int v) {
    issue_stage<Kind>(acc, s, geo, ring, stage, phase, v);
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    if (held >= 0) release_stage(ring, held);
    held = stage;
    next_stage(ring, stage, phase);
  };
  int v = 0;
  for (; v + 1 < geo.nv; v += 2) {
    step(st[0], v);
    step(st[1], v + 1);
  }
  if (v < geo.nv) step(st[0], v);
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  release_stage(ring, held);
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
// row_bytes; with `halves` (b, 2 * row_bytes), split into its halves:
// packed int4, F32X3), the queries in boxes of a group of q_box.
inline int make_maps(Maps* m, bool halves, const void* x, const void* q,
                     int n, int b, int row_bytes, int q_box = kGroup) {
  int e = encode_map(&m->x, x, row_bytes, n, row_bytes, kTileRows);
  if (e != 0) return e;
  const long qstride = halves ? 2L * row_bytes : row_bytes;
  e = encode_map(&m->q, q, row_bytes, b, qstride, q_box);
  if (e != 0 || !halves) {
    m->q_hi = m->q;
    return e;
  }
  return encode_map(&m->q_hi, static_cast<const int8_t*>(q) + row_bytes,
                    row_bytes, b, qstride, q_box);
}

// The maps of a K1 or K3 launch from the wrapper's cached encodings
// (ops/cuda_topk.py: tensor_map; vrod_encode_map writes them): three
// 128-byte maps in host memory, q_hi null unless packed or split.
inline Maps maps_from(const void* x, const void* q, const void* q_hi) {
  Maps m;
  std::memcpy(&m.x, x, sizeof(CUtensorMap));
  std::memcpy(&m.q, q, sizeof(CUtensorMap));
  std::memcpy(&m.q_hi, q_hi != nullptr ? q_hi : q, sizeof(CUtensorMap));
  return m;
}

// The Maps of a copying launch: its granule, which must divide the row
// bytes and the rows' and the query's bases (the query's stride and its
// high half's offset are multiples of the row bytes); any other fails the
// launch.
inline int copy_maps(Maps* m, const void* x, const void* q, int row_bytes,
                     int granule) {
  *m = Maps{};
  m->granule = granule;
  const bool known = granule == 1 || granule == 2 || granule == 4 ||
                     granule == 8;
  return known && row_bytes % granule == 0 &&
                 reinterpret_cast<uintptr_t>(x) % granule == 0 &&
                 reinterpret_cast<uintptr_t>(q) % granule == 0
             ? 0
             : (int)cudaErrorInvalidValue;
}

// Raise a kernel's dynamic shared memory limit to `smem` on the current
// device, once per kernel and device (the attribute is the context's).
constexpr int kMaxDevices = 64;
template <auto kKern>
int ensure_smem(int smem) {
  static std::atomic<int> set[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < kMaxDevices && set[dev].load(std::memory_order_relaxed) >= smem) {
    return 0;
  }
  e = cudaFuncSetAttribute(kKern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem);
  if (e == cudaSuccess && dev < kMaxDevices) set[dev].store(smem);
  return (int)e;
}

// A launch in clusters of `cluster` blocks along x (cluster 1: blocks
// alone); a cluster the card cannot place fails the launch, with no
// fallback.
template <class... P, class... A>
int launch_clusters(void (*kern)(P...), dim3 grid, int cluster, int smem,
                    cudaStream_t s, A&&... args) {
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, kern, std::forward<A>(args)...);
}


}  // namespace vrod
