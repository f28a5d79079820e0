// K3: sampled sub-max pre-pass, every leg of the TPU kernel (int8, packed
// int4, bfloat16 and float32 rows; metrics cosine, dot and l2).
//
// Replaces the Pallas kernel vrod_tpu/ops/pallas_topk.py: sampled_submax ->
// _submax_kernel. Scores a prefix sample of the rows with K1's own scoring
// core (score.cuh: the same ring, the same wgmma instructions in the same
// order, so the two agree bit for bit) and emits, for every row block of
// blk rows, 128 strided group maxima: lane t of block j is the max over
// rows j*blk + t, j*blk + t + 128, ... Output (B, 128 * n / blk) f32, the
// layout of the TPU kernel.
//
// What bounds it on an H100: at the int8 headline the sample is 25 MB of
// rows (32,768 x 768: 7.5 us at 3.35 TB/s) and 12.9 G integer operations
// for B = 256 (6.5 us on the tensor cores; the float legs' larger samples
// scale both), so with so little work what bounds it is parallelism, each
// block's start-up and what leaves the chip besides the output.
//
// The design. The TPU grid is (query tiles, row blocks): only two row
// blocks at the int8 headline. Here the queries split into groups of kN =
// 64 or 128 (wgmma n64/n128: the scoring core's narrow widths; the plan,
// ops/cuda_topk.py: submax_plan, takes 128 where that grid is as large as
// 64's, since a wider group reads each row tile for twice the queries)
// and each (row block, query group) pair is one cluster of spb blocks,
// each block a segment of whole 128-row tiles of the row block, so the
// grid fills the card. A block streams its tiles through a ring of 192 KB,
// and its wgmmas of one stage run while the next stage's rows load into
// registers (score.cuh: consume_tile_overlap). A tile's row t feeds lane t (blocks
// and segments start on whole tiles), so the thread that holds a (query,
// row) accumulator alone owns that (query, lane) maximum: the maxima live
// in that thread's registers across the segment's tiles (kN / 2 a thread
// beside as many accumulators), which leaves all of shared memory to the
// ring. At the end each block puts its maxima in its shared memory
// and block r of the cluster takes the max over the cluster's blocks of
// its share of the (query, lane) pairs through distributed shared memory
// and writes them out: one launch, and nothing but the output leaves the
// chip (max is exact, so the order does not matter).

#include "score.cuh"

namespace vrod {
namespace {

constexpr int kLanes = 128;
static_assert(kLanes == kTileRows, "tile row t feeds lane t");

// The ring of a kN-query block: 8 stages of 24 KB (n64) or 6 of 32 KB
// (n128), at F32X3 6 of 32 KB or 4 of 48 KB (both query halves a stage);
// the block's maxima (kN x 128 floats) reuse it after the scan.
// ops/cuda_topk.py's SUBMAX_GROUPS and SUBMAX_RING_BYTES follow these.
template <class Kind, int kN>
struct Width {
  static constexpr int kRing = 192 * 1024 / stage_bytes<Kind>(kN);
  static constexpr int kSmem = 1024 + kRing * stage_bytes<Kind>(kN);
  static_assert(kN * kLanes * 4 <= kRing * stage_bytes<Kind>(kN),
                "maxima");
  static_assert(kSmem <= 227 * 1024, "a block's shared memory");
};

// Where (query column ql, lane l) lives in a block's maxima: query rows of
// 128 floats, lanes XOR-swizzled by bits 1-2 of the query so the eight
// lanes and four query columns of one accumulator index hit 32 distinct
// banks.
__device__ __forceinline__ int best_at(int ql, int l) {
  return ql * kLanes + (l ^ (((ql >> 1) & 3) << 3));
}

template <class Kind, int kEpi, bool kTma, int kN>
__global__ void __launch_bounds__(kThreads, 1) submax_kernel(
    const __grid_constant__ Maps maps, const int8_t* __restrict__ x,
    const int8_t* __restrict__ q, const float* __restrict__ aux,
    const __grid_constant__ RowMask mask,
    const float* __restrict__ q_scale, int row_bytes,
    int n, int b, int blk, int spb, float* __restrict__ out) {
  extern __shared__ uint8_t smem_raw[];
  constexpr int kRing = Width<Kind, kN>::kRing;
  __shared__ uint64_t full[kRing], empty[kRing];
  __shared__ float qsv[kN];
  const Ring ring{align1024(smem_raw), full, empty, kRing, !kTma};
  float* best = reinterpret_cast<float*>(ring.base);  // after the scan
  const Geometry geo = make_geometry<Kind, kN>(row_bytes);
  const int sg = cluster_rank();
  const int j = blockIdx.x / spb;
  const int q0 = blockIdx.y * kN;
  const int seg_tiles = blk / spb / kTileRows;
  const int t0 = (j * blk) / kTileRows + sg * seg_tiles;
  ring_init(ring);
  for (int i = threadIdx.x; i < kN; i += kThreads) {
    qsv[i] = kEpi == kScaleQs && q0 + i < b
                 ? __fmul_rn(2.0f, q_scale[q0 + i]) : 0.0f;
  }
  __syncthreads();
  if (threadIdx.x >= kConsumers) {
    producer_regs();
    if (ring_loader<kTma>()) {
      produce<Kind, kTma, kN>(maps, Loads{x, q, n, b}, geo, ring, q0, t0,
                              t0 + seg_tiles, 1);
    }
  } else {
    consumer_regs();
    using Acc = typename Kind::Acc;
    Acc acc[kN / 2];
    float mx[kN / 2];
#pragma unroll
    for (int i = 0; i < kN / 2; ++i) mx[i] = -INFINITY;
    const int lane0 = tile_row(0);
    int stage = 0, phase = 0;
    for (int t = t0; t < t0 + seg_tiles; ++t) {
      float aux_r[2];
      RowMask::Raw raw[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long r = (long)t * kTileRows + lane0 + 8 * h;
        aux_r[h] = ldg_f32(aux + r);
        raw[h] = mask.fetch(r);
      }
      consume_tile_overlap<Kind>(acc, geo, ring, stage, phase);
      const float mask_r[2] = {RowMask::value(raw[0]),
                               RowMask::value(raw[1])};
#pragma unroll
      for (int i = 0; i < kN / 2; ++i) {
        const int h = (i >> 1) & 1;
        mx[i] = fmaxf(mx[i], score_epilogue<kEpi>(dot_value(acc[i]),
                                                  aux_r[h], mask_r[h],
                                                  qsv[query_col(i)]));
      }
    }
    // The ring is free once both warpgroups have taken their last stage.
    consumer_sync();
#pragma unroll
    for (int i = 0; i < kN / 2; ++i) {
      best[best_at(query_col(i), lane0 + 8 * ((i >> 1) & 1))] = mx[i];
    }
  }
  cluster_sync();  // every block's maxima are in its shared memory
  if (threadIdx.x < kConsumers) {
    // Block sg's share: queries [sg * kN / spb, (sg + 1) * kN / spb).
    const int per = kN / spb;
    const size_t width = (size_t)kLanes * (n / blk);
    for (int e = threadIdx.x; e < per * kLanes; e += kConsumers) {
      const int ql = sg * per + e / kLanes, l = e % kLanes;
      const float* at = &best[best_at(ql, l)];
      float m = *at;
      for (int p = 0; p < spb; ++p) {
        if (p != sg) m = fmaxf(m, ld_peer_f32(peer_addr(at, p)));
      }
      if (q0 + ql < b) {
        out[(size_t)(q0 + ql) * width + (size_t)j * kLanes + l] = m;
      }
    }
  }
  cluster_sync();  // no block leaves while another reads its maxima
}

}  // namespace
}  // namespace vrod

using namespace vrod;

struct LaunchSubmax {
  template <class Kind, int kEpi, bool kTma, int kN>
  static int launch(const void* x, const void* aux, RowMask mask,
                    const void* q, const void* q_scale, int row_bytes, int n,
                    int b, int blk, int spb, int groups, void* out,
                    int granule, const void* const* m3, cudaStream_t s) {
    if (spb < 1 || spb > kMaxCluster || kN % spb != 0) {
      return (int)cudaErrorInvalidValue;
    }
    Maps maps{};
    int e = 0;
    if constexpr (kTma) {
      maps = maps_from(m3[0], m3[1], m3[2]);
    } else {
      e = copy_maps(&maps, x, q, row_bytes, granule);
      if (e != 0) return e;
    }
    constexpr int kSmem = Width<Kind, kN>::kSmem;
    e = ensure_smem<submax_kernel<Kind, kEpi, kTma, kN>>(kSmem);
    if (e != 0) return e;
    return launch_clusters(
        submax_kernel<Kind, kEpi, kTma, kN>, dim3((n / blk) * spb, groups),
        spb, kSmem, s, maps, static_cast<const int8_t*>(x),
        static_cast<const int8_t*>(q), static_cast<const float*>(aux), mask,
        static_cast<const float*>(q_scale), row_bytes, n, b, blk, spb,
        static_cast<float*>(out));
  }
  template <class Kind, int kEpi, bool kTma>
  static int run(int width, const void* x, const void* aux, RowMask mask,
                 const void* q, const void* q_scale, int row_bytes, int n,
                 int b, int blk, int spb, int groups, void* out,
                 int granule, const void* const* m3, cudaStream_t s) {
    if constexpr (Kind::kSplit) {
      // F32X3 takes groups of 64 alone (cuda_topk.submax_plan): at 128
      // the stages of both query halves leave the consumers too few
      // registers.
      if (width != 64) return (int)cudaErrorInvalidValue;
      return LaunchSubmax::launch<Kind, kEpi, kTma, 64>(
          x, aux, mask, q, q_scale, row_bytes, n, b, blk, spb, groups, out,
          granule, m3, s);
    } else {
      auto* go = width == 128
                     ? &LaunchSubmax::launch<Kind, kEpi, kTma, 128>
                     : &LaunchSubmax::launch<Kind, kEpi, kTma, 64>;
      if (width != 64 && width != 128) return (int)cudaErrorInvalidValue;
      return go(x, aux, mask, q, q_scale, row_bytes, n, b, blk, spb, groups,
                out, granule, m3, s);
    }
  }
};

// elem/epi: score.cuh's Elem and Epi codes; granule as for vrod_fused_topk,
// with the maps encoded by the wrapper (x, q, q_hi; null without TMA).
// valid (n,) bool and bias (n,) or null: the rows' mask (RowMask).
// row_bytes: bytes per stored row (int4: dim / 2). q_scale (b,) is read by
// kScaleQs only. width, spb, groups: the plan (ops/cuda_topk.py:
// submax_plan), width the queries a block takes (64 or 128; f32x3: 64).
extern "C" int vrod_sampled_submax(int elem, int epi, int granule,
                                   const void* x,
                                   const void* aux, const void* valid,
                                   const void* bias, const void* q,
                                   const void* q_scale, int n, int row_bytes,
                                   int b, int blk, int width, int spb,
                                   int groups, void* out, const void* x_map,
                                   const void* q_map, const void* q_hi_map,
                                   void* stream) {
  const void* m3[3] = {x_map, q_map, q_hi_map};
  return dispatch_leg<LaunchSubmax, true>(
      elem, epi, granule == 16, width, x, aux,
      RowMask{static_cast<const uint8_t*>(valid),
              static_cast<const float*>(bias)},
      q, q_scale, row_bytes, n, b, blk, spb, groups, out, granule,
      static_cast<const void* const*>(m3), static_cast<cudaStream_t>(stream));
}
