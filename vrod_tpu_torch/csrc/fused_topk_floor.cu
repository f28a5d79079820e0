// K1's long scan from a floor: every call with theta0 (the engine's main
// path, where K3's sampled floor opens) and X9 with a floor, on every leg
// of fused_topk.cu. ops/cuda_topk.py (scan_route) sends a long scan here
// when theta0 is given and to fused_topk.cu's gated core when it is not.
//
// Replaces, with fused_topk.cu, the Pallas kernel
// vrod_tpu/ops/pallas_topk.py: fused_topk -> _fused_call_db -> _kernel_db
// (and X9's experiments/kexp22.py: fused_intgate -> _kernel_db_intgate).
//
// Why a kernel of its own: with a floor few scores pass, and the scan's
// width decides its time. Here a block takes a query group of 256 (kGroup:
// wgmma m64n256), so at batch 256 every row tile is multiplied with the
// whole batch in one pass and each row byte crosses L2 once; the n64 core
// reads each row tile four times and measured ~50% slower at the main path
// (PERF.md, the floor A/B). Without a floor the lists fill and are cut
// often, and the n64 core, whose k-ths sit in registers and whose lists
// stay on chip, is the faster (fused_topk.cu).
//
// The design (score.cuh): the rows and the group's queries stream by TMA
// into a ring that one producer warp keeps full; each consumer thread holds
// 128 accumulators (64 query columns), and after each tile's wgmmas tests
// every score, in its register, against max(theta0, its query's list k-th)
// read from shared memory; the few that pass are appended to an unordered
// candidate list in global scratch of cap = k + 5 tiles. Every 4 tiles the
// two consumer warpgroups meet, and a list longer than cap - 4 tiles (the
// most the next four can add) is cut back to exactly k by warp_select, its
// k-th joining the query's gate. Rows come in ascending slot order, so a
// later score equal to the gate loses its tie anyway. The merge is
// topk.cuh's fused_topk_merge. X9 (kIntGate): each query's G (topk.cuh:
// int_gate) in shared memory beside its gate; four dots of a query pair
// all <= G skip their epilogues.

#include "topk.cuh"

namespace vrod {
namespace {

// The ring: K1's depth, at most 4 stages of 48 KB.
constexpr int kFloorRing = kRing < 4 ? kRing : 4;
constexpr int kFloorCutTiles = 4;  // ops/cuda_topk.py: FLOOR_CUT_TILES

// The int gate's state in a block: G per query of the group beside the
// gate, and the aux range it was derived from.
struct IntGate {
  int* g;
  float amin, amax;
};

// The consumer warps cut every list of the group longer than `limit` (>=
// k) to its k best and raise its query's gate to the new k-th value (and,
// with the int gate, that query's G).
template <bool kIntGate>
__device__ void cut_lists(float* cand_v, int* cand_i, int* len, float* gate,
                          const IntGate& ig, unsigned* hist, size_t list0,
                          int q0, int b, int k, int cap, int limit) {
  for (int ql = threadIdx.x >> 5; ql < kGroup && q0 + ql < b;
       ql += kConsumers / 32) {
    const int n = len[ql];
    if (n <= limit) continue;  // warp-uniform
    const size_t list = list0 + (size_t)ql * cap;
    const int kth = warp_select(cand_v + list, cand_i + list, n, k,
                                hist + (threadIdx.x >> 5) * 256);
    if ((threadIdx.x & 31) == 0) {
      len[ql] = k;
      const float g = fmaxf(gate[ql], key_float(kth));
      gate[ql] = g;
      if constexpr (kIntGate) ig.g[ql] = int_gate(g, ig.amin, ig.amax);
    }
  }
}

// The test of one tile's scores, in the registers that hold their dots:
// per query pair of this thread (columns ql = 8j + 2t and ql + 1) and its
// two rows, four scores against the pair's gates, one branch a pair; only
// scores above their gate are appended to their query's list. With the
// int gate the int32 dots are first held against their pairs' G: when none
// is above, no score can pass and the epilogues are not computed. Nothing
// here writes a gate, so the __restrict__ views let their loads run ahead
// of the appends.
template <class Kind, int kEpi, bool kIntGate>
__device__ __forceinline__ void gate_tile(
    const typename Kind::Acc (&acc)[kAcc], const float (&aux_r)[2],
    const float (&mask_r)[2], int row0, int offset, float* v_list0,
    int* i_list0, int cap, const float* __restrict__ gate,
    const int* __restrict__ gint, const float* __restrict__ qsv, int* len) {
#pragma unroll
  for (int j = 0; j < kAcc / 4; ++j) {
    const int ql = query_col(4 * j);
    if constexpr (kIntGate) {
      const int2 gi = *reinterpret_cast<const int2*>(gint + ql);
      if (!((acc[4 * j] > gi.x) | (acc[4 * j + 1] > gi.y) |
            (acc[4 * j + 2] > gi.x) | (acc[4 * j + 3] > gi.y))) {
        continue;
      }
    }
    const float2 g2 = *reinterpret_cast<const float2*>(gate + ql);
    const float2 q2 = kEpi == kScaleQs
                          ? *reinterpret_cast<const float2*>(qsv + ql)
                          : make_float2(0.0f, 0.0f);
    float s[4];
    bool p[4];
    bool any = false;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[e] = score_epilogue<kEpi>(dot_value(acc[4 * j + e]), aux_r[e >> 1],
                                  mask_r[e >> 1], e & 1 ? q2.y : q2.x);
      p[e] = s[e] > (e & 1 ? g2.y : g2.x);
      any |= p[e];
    }
    if (any) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (p[e]) {
          const int qe = ql + (e & 1);
          const size_t at = (size_t)qe * cap + atomicAdd(len + qe, 1);
          v_list0[at] = s[e];
          i_list0[at] = row0 + 8 * (e >> 1) + offset;
        }
      }
    }
  }
}

// The consumer warpgroups' walk over a part's row tiles: per tile the dots
// and the test; every kFloorCutTiles tiles (and at the end) the list cuts,
// the only points where the two warpgroups wait for each other. A list
// holds cap = k + (kFloorCutTiles + 1) tiles of candidates: at a cut, lists
// longer than cap - kFloorCutTiles tiles are cut back to k, so the next
// tiles (at most 128 candidates each) always fit. Query ql's list starts
// at cand_v + list0 + ql * cap, and its length goes to cand_n[part * b + q0
// + ql].
template <class Kind, int kEpi, bool kIntGate, class Mask>
__device__ __forceinline__ void consume_all(
    const Geometry& geo, const Ring& ring, const float* __restrict__ aux,
    const Mask& mask, int n, int b, int k, int offset, int part, int parts,
    int tiles, int q0, int cap, size_t list0, float* gate,
    const IntGate& ig, const float* qsv, int* len, unsigned* hist,
    float* __restrict__ cand_v, int* __restrict__ cand_i,
    int* __restrict__ cand_n) {
  using Acc = typename Kind::Acc;
  Acc acc[kAcc];
  int stage = 0, phase = 0, since_cut = 0;
  for (int t = part; t < tiles; t += parts) {
    // The rows' aux and mask, loaded before the dots so they have arrived
    // by the test.
    const int row0 = t * kTileRows + tile_row(0);
    float aux_r[2], mask_r[2];
    typename Mask::Raw raw[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gr = row0 + 8 * h;
      aux_r[h] = gr < n ? ldg_f32(aux + gr) : 0.0f;
      raw[h] = mask.fetch(gr < n ? gr : 0);
    }
    consume_tile<Kind>(acc, geo, ring, stage, phase);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mask_r[h] = row0 + 8 * h < n ? Mask::value(raw[h]) : -INFINITY;
    }
    // tools/kernel_probe.py builds the scan without the test (and without
    // the cuts' barriers) to see where the time goes; such builds return
    // wrong results by design.
#ifndef VROD_PROBE_NO_GATE
    gate_tile<Kind, kEpi, kIntGate>(acc, aux_r, mask_r, row0, offset,
                                    cand_v + list0, cand_i + list0, cap,
                                    gate, ig.g, qsv, len);
#endif
#if !(defined(VROD_PROBE_NO_GATE) && defined(VROD_PROBE_NO_CUT_BARRIERS))
    if (++since_cut == kFloorCutTiles) {
      since_cut = 0;
      consumer_sync();  // the tiles' candidates and lengths are in
      cut_lists<kIntGate>(cand_v, cand_i, len, gate, ig, hist, list0, q0, b,
                          k, cap, cap - kFloorCutTiles * kTileRows);
      consumer_sync();  // gates and lengths are read again
    }
#endif
  }
  consumer_sync();
  cut_lists<kIntGate>(cand_v, cand_i, len, gate, ig, hist, list0, q0, b, k,
                      cap, k);
  consumer_sync();
  for (int i = threadIdx.x; i < kGroup && q0 + i < b; i += kConsumers) {
    cand_n[(size_t)part * b + q0 + i] = len[i];
  }
}

// Block (part, group) of a grid of groups x parts: query group [256 g, 256
// g + 256) against row tiles part, part + parts, ...
template <class Kind, int kEpi, bool kTma, bool kIntGate>
__global__ void __launch_bounds__(kThreads, 1) fused_topk_floor(
    const __grid_constant__ Maps maps, const int8_t* __restrict__ x,
    const int8_t* __restrict__ q, const float* __restrict__ aux,
    const __grid_constant__ RowMask mask,
    const float* __restrict__ q_scale, int row_bytes,
    const float* __restrict__ theta0, int n, int b, int k, int offset,
    int groups, int parts, int cap, float* __restrict__ cand_v,
    int* __restrict__ cand_i, int* __restrict__ cand_n) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t full[kFloorRing], empty[kFloorRing];
  // max(theta0, the list's k-th), and the group's 2 * q_scale (kScaleQs);
  // read as float2 pairs.
  __shared__ __align__(16) float gate[kGroup];
  __shared__ __align__(16) float qsv[kGroup];
  __shared__ int len[kGroup];
  __shared__ unsigned hist[kConsumers / 32 * 256];  // a select's, per warp
  // The int gate's G per query (read as int2 pairs) and aux range.
  __shared__ __align__(16) int gint[kIntGate ? kGroup : 2];
  __shared__ float arange[2];
  const Ring ring{align1024(smem_raw), full, empty, kFloorRing, !kTma};
  const Geometry geo = make_geometry<Kind, kGroup>(row_bytes);
  const int part = blockIdx.x / groups;
  const int q0 = blockIdx.x % groups * kGroup;
  const int tiles = (n + kTileRows - 1) / kTileRows;
  ring_init(ring);
  if constexpr (kIntGate) aux_range(aux, n, part, parts, tiles, arange);
  const IntGate ig{gint, kIntGate ? arange[0] : 0.0f,
                   kIntGate ? arange[1] : 0.0f};
  for (int i = threadIdx.x; i < kGroup; i += kThreads) {
    const int qq = q0 + i;
    gate[i] = qq >= b ? INFINITY : theta0[qq];
    qsv[i] = kEpi == kScaleQs && qq < b ? __fmul_rn(2.0f, q_scale[qq]) : 0.0f;
    len[i] = 0;
    if constexpr (kIntGate) gint[i] = int_gate(gate[i], ig.amin, ig.amax);
  }
  __syncthreads();
  if (threadIdx.x >= kConsumers) {
    producer_regs();
    if (ring_loader<kTma>()) {
      produce<Kind, kTma>(maps, Loads{x, q, n, b}, geo, ring, q0, part,
                          tiles, parts);
    }
  } else {
    consumer_regs();
    consume_all<Kind, kEpi, kIntGate>(
        geo, ring, aux, mask, n, b, k, offset, part, parts, tiles, q0, cap,
        ((size_t)part * b + q0) * cap, gate, ig, qsv, len, hist, cand_v,
        cand_i, cand_n);
  }
}

template <bool kIntGate>
struct LaunchFloor {
  template <class Kind, int kEpi, bool kTma>
  static int run(const void* x, const void* aux, RowMask mask, const void* q,
                 const void* q_scale, int row_bytes, const void* theta0,
                 int n, int b, int k, int offset, int groups, int parts,
                 int cap, void* scratch, void* out_v, void* out_i,
                 int granule, const void* const* m3, cudaStream_t s) {
    if (theta0 == nullptr || cap != k + (kFloorCutTiles + 1) * kTileRows) {
      return (int)cudaErrorInvalidValue;
    }
    Maps maps;
    int e = launch_maps<Kind, kTma>(&maps, m3, x, q, n, b, row_bytes, kGroup,
                                    granule);
    if (e != 0) return e;
    const int smem = 1024 + kFloorRing * kStageBytes;
    e = ensure_smem<fused_topk_floor<Kind, kEpi, kTma, kIntGate>>(smem);
    if (e != 0) return e;
    const Scratch sc(scratch, parts, b, k, cap);
    fused_topk_floor<Kind, kEpi, kTma, kIntGate>
        <<<groups * parts, kThreads, smem, s>>>(
            maps, static_cast<const int8_t*>(x),
            static_cast<const int8_t*>(q), static_cast<const float*>(aux),
            mask, static_cast<const float*>(q_scale), row_bytes,
            static_cast<const float*>(theta0), n, b, k, offset, groups,
            parts, cap, sc.cand_v, sc.cand_i, sc.cand_n);
    e = (int)cudaGetLastError();
    if (e != 0) return e;
    return launch_merge(sc.cand_v, sc.cand_i, sc.cand_n, parts, cap, b, k,
                        sc.merge_v, sc.merge_i, out_v, out_i, s);
  }
};

}  // namespace
}  // namespace vrod

using namespace vrod;

// Arguments as vrod_fused_topk's without on_chip and ring; theta0 (b,) is
// required. groups, parts, cap: ops/cuda_topk.py's floor_plan (query
// groups of 256, lists of k + 5 tiles in scratch); maps: the queries in
// boxes of 256.
extern "C" int vrod_fused_topk_floor(
    int elem, int epi, int granule, const void* x, const void* aux,
    const void* valid, const void* bias, const void* q, const void* q_scale,
    const void* theta0, int n, int row_bytes, int b, int k, int offset,
    int groups, int parts, int cap, void* scratch, void* out_v, void* out_i,
    const void* x_map, const void* q_map, const void* q_hi_map,
    void* stream) {
  const RowMask mask{static_cast<const uint8_t*>(valid),
                     static_cast<const float*>(bias)};
  const void* m3[3] = {x_map, q_map, q_hi_map};
  const void* const* maps = x_map != nullptr ? m3 : nullptr;
  return dispatch_leg<LaunchFloor<false>, true>(
      elem, epi, granule == 16, x, aux, mask, q, q_scale, row_bytes, theta0,
      n, b, k, offset, groups, parts, cap, scratch, out_v, out_i, granule,
      maps, static_cast<cudaStream_t>(stream));
}

// X9 from a floor: vrod_fused_intgate's arguments without on_chip and
// ring, the plan as vrod_fused_topk_floor's.
extern "C" int vrod_fused_intgate_floor(
    int granule, const void* x, const void* aux, const void* valid,
    const void* q, const void* theta0, int n, int row_bytes, int b, int k,
    int offset, int groups, int parts, int cap, void* scratch, void* out_v,
    void* out_i, void* stream) {
  auto* run = granule == 16 ? &LaunchFloor<true>::run<I8, kScale, true>
                            : &LaunchFloor<true>::run<I8, kScale, false>;
  return run(x, aux, RowMask{static_cast<const uint8_t*>(valid), nullptr},
             q, nullptr, row_bytes, theta0, n, b, k, offset, groups, parts,
             cap, scratch, out_v, out_i, granule, nullptr,
             static_cast<cudaStream_t>(stream));
}
