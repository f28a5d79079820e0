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
// (the copying build: the producer warpgroup's copies) into a ring of 4
// stages of 48 KB; each consumer thread holds 128 accumulators (64 query
// columns of its warp's 16 rows of a 128-row tile). In the TMA builds both
// consumer warpgroups (tile rows 0-63 and 64-127) issue every stage's
// wgmmas together and test together (lockstep); in the copying builds
// they take the tensor cores in turns (ping-pong; floor_pingpong says
// why): warpgroup 0 issues its wgmmas on up to kFloorTurn stages of
// a tile and hands the turn over by a named barrier (score.cuh: turn_wait,
// turn_pass), warpgroup 1 issues its own on the same stages, and so on; so
// after its last turn of a tile a warpgroup tests its scores while the
// other runs that tile's last turn, and warpgroup 0 issues the next tile's
// first turn while warpgroup 1 tests. A stage goes back to the producer
// once both warpgroups' wgmmas on it have completed (its empty barrier
// counts both). A turn is at most kFloorRing - 1 stages: warpgroup 0's
// next turn needs only the stages that warpgroup 1's last turn released,
// so the ring holds one turn and the stage loading ahead of it.
//
// The test: every score, in its register, against max(theta0, its query's
// list k-th) read from shared memory; a query pair with a passing score is
// recorded, and after the tile's test one loop of the warp appends the
// records (topk.cuh: append_pending, one shared atomic a column and round)
// to the queries' unordered candidate lists in global scratch of cap = k +
// 5 tiles. Every
// kFloorCutTiles tiles the warpgroups meet to cut, and a list longer than
// cap - kFloorCutTiles tiles (the most the next four can add) is cut back
// to exactly k (sort_cut, a warp bitonic sort; the radix select past k
// kSortLongK), its k-th joining the query's gate. A cut sees only rows
// below every row still to be tested: both warpgroups meet after testing
// the tile and before issuing the next. Rows come in ascending slot order,
// so a later score equal to the gate loses its tie anyway. The merge is
// topk.cuh's fused_topk_merge. X9 (kIntGate): each query's G (topk.cuh:
// int_gate) in shared memory beside its gate; a query pair whose four dots
// are all at most their G skips its epilogues.

#include "topk.cuh"

namespace vrod {
namespace {

// The ring: K1's depth, at most 4 stages of 48 KB.
constexpr int kFloorRing = kRing < 4 ? kRing : 4;
constexpr int kFloorCutTiles = 4;  // ops/cuda_topk.py: FLOOR_CUT_TILES
// A warpgroup's turn on the tensor cores: stages of a tile, the most
// that leave the ring a stage loading ahead (turns of 1 and 2 stages
// measured slower, PERF.md).
constexpr int kFloorTurn = kFloorRing - 1;

// A turn of a kind's walk: kFloorTurn stages, but F32X3's pairs of stages
// (score.cuh: Walk; (kb, big) then (kb, small)) one whole pair, so every
// turn starts at an even stage: the compiler then knows each stage's half
// of the query, and no wgmma sits in a branch (which ptxas serializes).
template <class Kind>
__host__ __device__ constexpr int floor_turn() {
  return Walk<Kind, kGroup>::kPairs ? 2 : kFloorTurn;
}
// The radix select's histograms (a warp's 256 counters), past the ring in
// dynamic shared memory, for a launch whose k is past kSortLongK.
constexpr int kFloorHist = kConsumers / 32 * 256 * 4;

// Dynamic shared memory of a launch at top-k (ops/cuda_topk.py:
// floor_smem): the 1024-byte alignment, the ring, the histograms.
__host__ __device__ constexpr int floor_dynamic_smem(int k) {
#ifdef VROD_PROBE_RADIX_CUT
  k = kSortLongK + 1;  // every cut the radix select's (floor_cut)
#endif
  return 1024 + kFloorRing * kStageBytes + (k > kSortLongK ? kFloorHist : 0);
}

// The warpgroups' schedule of a build, chosen at compile time by what
// measured faster on an H100 (PERF.md): the ping-pong for the
// copying builds (rows TMA cannot load; at glove-100's 100-byte rows a
// tile is one stage, so a turn is a whole tile), and for the TMA builds
// lockstep, both warpgroups on every stage together
// and testing together (there the turns' stalls cost more than the
// appends they hide). tools/kernel_probe.py --floor builds either for
// every build (VROD_PROBE_LOCKSTEP, VROD_PROBE_PINGPONG).
template <bool kTma>
__host__ __device__ constexpr bool floor_pingpong() {
#if defined(VROD_PROBE_LOCKSTEP)
  return false;
#elif defined(VROD_PROBE_PINGPONG)
  return true;
#else
  return !kTma;
#endif
}

// The int gate's state in a block: G per query of the group beside the
// gate, and the aux range it was derived from.
struct IntGate {
  int* g;
  float amin, amax;
};

// A list cut to its k best (k < n), written sorted to [0, k); returns its
// k-th value. hist: the warp's histogram (k > kSortLongK only).
// tools/kernel_probe.py --floor's radix_cut build (VROD_PROBE_RADIX_CUT)
// cuts every list by the radix select, to time the two cuts.
__device__ __forceinline__ float floor_cut(float* v, int* ix, int n, int k,
                                           unsigned* hist) {
#ifndef VROD_PROBE_RADIX_CUT
  if (n <= 256 || k <= kSortLongK) return sort_cut_long(v, ix, n, k);
#endif
  return key_float(warp_select(v, ix, n, k, hist));
}

// The consumer warps cut every list of the group longer than `limit` (>=
// k) to its k best and raise its query's gate to the new k-th value (and,
// with the int gate, that query's G); consumer barriers before (the tiles'
// candidates and lengths are in) and after (gates and lengths are read
// again).
template <bool kIntGate>
__device__ void cut_lists(float* cand_v, int* cand_i, int* len, float* gate,
                          const IntGate& ig, unsigned* hist, size_t list0,
                          int q0, int b, int k, int cap, int limit) {
#ifdef VROD_PROBE_COUNT
  if (threadIdx.x == 0) atomicAdd(probe_counts + 2, 1);
#endif
  consumer_sync();  // the tiles' candidates and lengths are in
  for (int ql = threadIdx.x >> 5; ql < kGroup && q0 + ql < b;
       ql += kConsumers / 32) {
    const int n = len[ql];
    if (n <= limit) continue;  // warp-uniform
    const size_t list = list0 + (size_t)ql * cap;
    const float kth = floor_cut(cand_v + list, cand_i + list, n, k,
                                hist + (threadIdx.x >> 5) * 256);
    if ((threadIdx.x & 31) == 0) {
#ifdef VROD_PROBE_COUNT
      atomicAdd(probe_counts + 1, 1);
#endif
      len[ql] = k;
      const float g = fmaxf(gate[ql], kth);
      gate[ql] = g;
      if constexpr (kIntGate) ig.g[ql] = int_gate(g, ig.amin, ig.amax);
    }
  }
  consumer_sync();
}

// The test of one tile's scores, in the registers that hold their dots:
// per query pair of this thread (columns ql = 8j + 2t and ql + 1) and its
// two rows, four scores against the pair's gates (max(theta0, the list's
// k-th), read from shared memory as float2 pairs), branch-free; a pair
// with a passing score is recorded (a few stores to this thread's records
// in local memory), and after the tile's test the warp appends every
// record at once (topk.cuh: append_pending). With the int gate the int32
// dots are first held against their pairs' G: when none is above, no
// score can pass and the epilogues are not computed. Nothing here writes
// a gate, so the __restrict__ views let their loads run ahead.
template <class Kind, int kEpi, bool kIntGate>
__device__ __forceinline__ void gate_tile(
    const typename Kind::Acc (&acc)[kAcc], const float (&aux_r)[2],
    const float (&mask_r)[2], int slot0, float* v_list0, int* i_list0,
    int cap, const float* __restrict__ gate, const int* __restrict__ gint,
    const float* __restrict__ qsv, int* len) {
  Pending rec[kAcc / 4];
  int n = 0;
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
    Pending p;
    unsigned b4 = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      p.s[e] = score_epilogue<kEpi>(dot_value(acc[4 * j + e]),
                                    aux_r[e >> 1], mask_r[e >> 1],
                                    e & 1 ? q2.y : q2.x);
      b4 |= (unsigned)(p.s[e] > (e & 1 ? g2.y : g2.x)) << e;
    }
    if (b4 != 0) {
      p.jb = j | (int)(b4 << 8);
      rec[n++] = p;
    }
  }
#ifdef VROD_PROBE_TEST_ONLY
  // tools/kernel_probe.py --floor: the test without the appends (and so
  // without cuts); the empty asm keeps every pair's test.
  asm volatile("" :: "r"(n));
  return;
#endif
  append_pending(rec, n, slot0, len, v_list0, i_list0, cap);
}

// The consumer warpgroups' walk over a part's row tiles t = part, part +
// parts, ... < tiles: per tile the dots in turns (the ping-pong) and the
// test; every kFloorCutTiles tiles, and after the last, the list cuts, the
// only points where the two warpgroups meet (both have tested the tile,
// neither has issued the next). The turns hand over unconditionally:
// warpgroup 1 hands warpgroup 0 its first turn before its walk, and
// warpgroup 0 takes warpgroup 1's last hand-over after its own. A list
// holds cap = k + (kFloorCutTiles + 1) tiles of candidates: at a cut,
// lists longer than cap - kFloorCutTiles tiles are cut back to k (and
// after the last tile every list longer than k), so the tiles up to the
// next cut (at most 128 candidates each) always fit. Query ql's list
// starts at cand_v + list0 + ql * cap, and its length goes to
// cand_n[part * b + q0 + ql].
template <class Kind, int kEpi, bool kTma, bool kIntGate, class Mask>
__device__ __forceinline__ void consume_all(
    const Geometry& geo, const Ring& ring, const float* __restrict__ aux,
    const Mask& mask, int n, int b, int k, int offset, int part, int parts,
    int tiles, int q0, int cap, size_t list0, float* gate,
    const IntGate& ig, const float* qsv, int* len, unsigned* hist,
    float* __restrict__ cand_v, int* __restrict__ cand_i,
    int* __restrict__ cand_n) {
  using Acc = typename Kind::Acc;
  constexpr bool kPingPong = floor_pingpong<kTma>();
  const int wg = threadIdx.x >> 7;
  Acc acc[kAcc];
  int stage = 0, phase = 0, since_cut = 0;
  if (kPingPong && wg == 1) turn_pass(wg);
  for (int t = part;; t += parts) {
    const bool last = t + parts >= tiles;
    if (t < tiles) {
      // The rows' aux and mask, loaded before the dots so they have
      // arrived by the test.
      const int row0 = t * kTileRows + tile_row(0);
      float aux_r[2], mask_r[2];
      typename Mask::Raw raw[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int gr = row0 + 8 * h;
        aux_r[h] = gr < n ? ldg_f32(aux + gr) : 0.0f;
        raw[h] = mask.fetch(gr < n ? gr : 0);
      }
#ifdef VROD_PROBE_COUNT
      if (threadIdx.x == 0) atomicAdd(probe_counts + 3, 1);
#endif
      if constexpr (kPingPong) {
        constexpr int kTurn = floor_turn<Kind>();
        for (int v0 = 0; v0 < geo.nv; v0 += kTurn) {
          turn_wait(wg);
          consume_stages<Kind>(acc, geo, ring, stage, phase, v0,
                               min(geo.nv, v0 + kTurn));
          turn_pass(wg);
        }
      } else {
        consume_tile<Kind>(acc, geo, ring, stage, phase);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mask_r[h] = row0 + 8 * h < n ? Mask::value(raw[h]) : -INFINITY;
      }
      // tools/kernel_probe.py builds the scan without the test (and
      // without the cuts) to see where the time goes; such builds return
      // wrong results by design.
#ifndef VROD_PROBE_NO_GATE
      gate_tile<Kind, kEpi, kIntGate>(acc, aux_r, mask_r, row0 + offset,
                                      cand_v + list0, cand_i + list0, cap,
                                      gate, ig.g, qsv, len);
#endif
    }
#if defined(VROD_PROBE_NO_GATE) && defined(VROD_PROBE_NO_CUT_BARRIERS)
    if (last) break;
#else
    if (++since_cut == kFloorCutTiles || last) {
      since_cut = 0;
      cut_lists<kIntGate>(cand_v, cand_i, len, gate, ig, hist, list0, q0, b,
                          k, cap, last ? k : cap - kFloorCutTiles * kTileRows);
      if (last) break;
    }
#endif
  }
  if (kPingPong && wg == 0) turn_wait(wg);
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
  __shared__ __align__(16) float qsv[kEpi == kScaleQs ? kGroup : 2];
  __shared__ int len[kGroup];
  // The int gate's G per query (read as int2 pairs) and aux range.
  __shared__ __align__(16) int gint[kIntGate ? kGroup : 2];
  __shared__ float arange[2];
  const Ring ring{align1024(smem_raw), full, empty, kFloorRing, !kTma};
  unsigned* hist =
      reinterpret_cast<unsigned*>(ring.base + kFloorRing * kStageBytes);
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
    if constexpr (kEpi == kScaleQs) {
      qsv[i] = qq < b ? __fmul_rn(2.0f, q_scale[qq]) : 0.0f;
    }
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
    consume_all<Kind, kEpi, kTma, kIntGate>(
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
    const int smem = floor_dynamic_smem(k);
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

// A block's whole shared memory at top-k: the static part (the largest of
// the builds': X9's, with its G and aux range, or the l2 legs', with the
// queries' scales) and the dynamic part (bytes; -1 if the card cannot
// say).
extern "C" int vrod_topk_floor_smem(int k) {
  cudaFuncAttributes a{}, b{};
  if (cudaFuncGetAttributes(&a, fused_topk_floor<I8, kScale, true, true>)
          != cudaSuccess ||
      cudaFuncGetAttributes(&b, fused_topk_floor<I8, kScaleQs, true, false>)
          != cudaSuccess) {
    return -1;
  }
  return (int)(a.sharedSizeBytes > b.sharedSizeBytes ? a.sharedSizeBytes
                                                     : b.sharedSizeBytes)
         + floor_dynamic_smem(k);
}

#ifdef VROD_PROBE_COUNT
// Probe builds: copy this scan's event counters (topk.cuh: probe_counts;
// here [0] scores appended, [1] lists cut, [2] cut points, [3] tiles
// walked, [4] shared atomics of the appends) to host memory `out` (8
// ints) and zero them.
extern "C" int vrod_probe_counts_floor(int* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, probe_counts, 8 * sizeof(int));
  if (e != cudaSuccess) return (int)e;
  static const int zero[8] = {};
  return (int)cudaMemcpyToSymbol(probe_counts, zero, 8 * sizeof(int));
}
#endif

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
