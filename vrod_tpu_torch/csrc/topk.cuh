// K1's scan machinery, shared by the fused top-k scan (fused_topk.cu: K1
// and its int32 gate bound, X9) and the one-launch sampled floor
// (fused_theta.cu: X6/X8): the exact radix select, the list cuts, the gate
// of each score in its register, the consumers' walk over a part's row
// tiles, and the merge of the part lists. See fused_topk.cu for the design.

#pragma once

#include <climits>
#include <cmath>

#include "score.cuh"

namespace vrod {
namespace {

// Stages of the TMA ring. 4 measured fastest on the main path's shapes: 3
// was ~1.5% slower and 2 ~11% (PERF.md, the ring-depth A/B of
// tools/kernel_ab.py --ring, which builds the library with -DVROD_K1_RING=N).
#ifndef VROD_K1_RING
#define VROD_K1_RING 4
#endif
constexpr int kRing = VROD_K1_RING;
static_assert(kRing >= 2 && 1024 + kRing * kStageBytes <= 227 * 1024,
              "K1's ring: 2 stages or more, within a block's shared memory");

constexpr int kMergeThreads = 64;  // two queries a block: b / 2 blocks
constexpr int kMergeWarps = kMergeThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ unsigned lanemask_lt() {
  return (1u << (threadIdx.x & 31)) - 1u;
}

// The float of an order key (float_key's inverse; also the inverse of
// order_key, which keeps -0.0 apart).
__device__ __forceinline__ float key_float(int key) {
  return __int_as_float(key ^ ((key >> 31) & 0x7fffffff));
}

// The unsigned order key of a float: unsigned order is value order.
__device__ __forceinline__ unsigned ukey(float f) {
  return (unsigned)float_key(f) ^ 0x80000000u;
}

// From a warp's histogram of one 8-bit digit, the digit at which a count
// taken in scan order (from digit 255 down when desc, else from 0 up)
// first reaches `need`, and in `before` the count of the digits scanned
// ahead of it. Lane l holds the scan positions 8l..8l+7.
__device__ int hist_pick(const unsigned* hist, int need, bool desc,
                         int& before) {
  const int lane = threadIdx.x & 31;
  int c[8], sum = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int pos = 8 * lane + i;
    c[i] = (int)hist[desc ? 255 - pos : pos];
    sum += c[i];
  }
  int incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += t;
  }
  const int excl = incl - sum;
  const int src = __ffs(__ballot_sync(kFull, excl < need && need <= incl))
                  - 1;
  int pos = -1, run = 0, upto = excl;  // valid in lane src
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if (pos < 0 && upto + c[i] >= need) {
      pos = i;
      run = upto;
    }
    upto += c[i];
  }
  pos = __shfl_sync(kFull, 8 * lane + pos, src);
  before = __shfl_sync(kFull, run, src);
  return desc ? 255 - pos : pos;
}

// The key of the need-th (1-based) of the elements e in [0, n) that in(e)
// admits, ordered by their 32-bit keys key(e), largest first when desc,
// else smallest first: a radix select in four passes of one 8-bit digit.
// `need` ends as that element's rank among the elements whose key equals
// the result, and `equal` as their count.
template <class Key, class In>
__device__ unsigned radix_select(unsigned* hist, int n, int& need, bool desc,
                                 int& equal, Key key, In in) {
  const int lane = threadIdx.x & 31;
  unsigned prefix = 0, pmask = 0;
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int i = lane; i < 256; i += 32) hist[i] = 0;
    __syncwarp();
    for (int e = lane; e < n; e += 32) {
      const unsigned u = key(e);
      if ((u & pmask) == prefix && in(e)) {
        atomicAdd(&hist[(u >> shift) & 255], 1u);
      }
    }
    __syncwarp();
    int before;
    const int d = hist_pick(hist, need, desc, before);
    need -= before;
    prefix |= (unsigned)d << shift;
    pmask |= 255u << shift;
    equal = (int)hist[d];
    __syncwarp();
  }
  return prefix;
}

// Keep the k best of (v, ix)[0, n), n >= k, by (value desc, index asc),
// compacted in place into [0, k) in no particular order. Indices must be
// distinct and non-negative. Returns the key of the k-th best value. Called
// by a whole warp with warp-uniform arguments; hist is the warp's 256
// counters in shared memory. The k-th value is found by an 8-bit radix
// select over order-isomorphic keys (the method of
// distances.kth_largest_count, a byte at a time), and the ties to keep at
// it, m of them, by a radix select of the m-th smallest index among them.
__device__ int warp_select(float* v, int* ix, int n, int k, unsigned* hist) {
  __syncwarp();
  int m = k, ties = 0;
  const unsigned kth = radix_select(
      hist, n, m, true, ties, [&](int e) { return ukey(v[e]); },
      [](int) { return true; });
  // m ties at kth to keep, the lowest indices first: all when they fit.
  unsigned lim = 0x7fffffffu;
  if (m < ties) {
    int unused;
    lim = radix_select(
        hist, n, m, false, unused, [&](int e) { return (unsigned)ix[e]; },
        [&](int e) { return ukey(v[e]) == kth; });
  }
  int w = 0;
  for (int base = 0; base < n; base += 32) {
    const int e = base + (threadIdx.x & 31);
    float val = 0.0f;
    int id = 0;
    bool keep = false;
    if (e < n) {
      val = v[e];
      id = ix[e];
      const unsigned u = ukey(val);
      keep = u > kth || (u == kth && (unsigned)id <= lim);
    }
    const unsigned msk = __ballot_sync(kFull, keep);
    __syncwarp();  // every lane has read its element before any write
    if (keep) {
      const int p = w + __popc(msk & lanemask_lt());
      v[p] = val;
      ix[p] = id;
    }
    w += __popc(msk);
    __syncwarp();
  }
  return (int)(kth ^ 0x80000000u);
}

// -- X9: the gate bound from the int32 accumulator -----------------------
//
// For int8 rows under cosine or dot a score is fl(fl(g) * aux) + mask with
// mask 0 or -inf. Over rows whose aux lies in [amin, amax] (aux >= 0,
// finite), ub(g) = g >= 0 ? fl(fl(g) * amax) : fl(fl(g) * amin) bounds
// every such score from above (the real products are ordered so, and
// rounding to nearest is monotone), and ub is non-decreasing in g. So with
// G the largest g such that ub(g) <= gate, a score whose dot is g <= G
// cannot beat the gate, and one integer compare decides it.

__device__ __forceinline__ float int_ub(long g, float amin, float amax) {
  const float gf = __int2float_rn((int)g);
  return __fmul_rn(gf, g >= 0 ? amax : amin);
}

// G for gate t: INT_MIN when no dot is that low (the gate passes every
// score to the exact test), INT_MAX when every dot is (|g| < 2^30, i.e.
// 127 * 127 * dim < 2^30). An aux range that breaks the bound's premises
// (negative, not finite, empty) gives INT_MIN. The estimate t / aux only
// picks the start: both edges are checked with ub itself.
__device__ int int_gate(float t, float amin, float amax) {
  if (!(amin >= 0.0f && amin <= amax && amax < INFINITY) || t != t ||
      t == -INFINITY) {
    return INT_MIN;
  }
  if (t == INFINITY) return INT_MAX;
  constexpr long kLim = 1L << 30;
  const double a = t >= 0.0f ? amax : amin;
  double est = a > 0.0 ? (double)t / a : (t >= 0.0f ? kLim : -kLim);
  est = fmin(fmax(est, (double)-kLim), (double)kLim);
  long g = (long)floor(est);
  while (g < kLim && int_ub(g + 1, amin, amax) <= t) ++g;
  while (g > -kLim && int_ub(g, amin, amax) > t) --g;
  if (g <= -kLim) return INT_MIN;
  return g >= kLim ? INT_MAX : (int)g;
}

// The int gate's state in a block: G per query of the group beside the
// gate, and the aux range it was derived from.
struct IntGate {
  int* g;
  float amin, amax;
};

// The consumer warps cut every list of the group longer than `limit` (>=
// k) to its k best and raise its query's gate to the new k-th value (and,
// with the int gate, that query's G).
template <bool kIntGate, int kN = kGroup>
__device__ void cut_lists(float* cand_v, int* cand_i, int* len, float* gate,
                          const IntGate& ig, unsigned* hist, size_t list0,
                          int q0, int b, int k, int cap, int limit) {
  for (int ql = threadIdx.x >> 5; ql < kN && q0 + ql < b;
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

// The gate of one tile's scores, in the registers that hold their dots:
// per query pair of this thread (columns ql = 8j + 2t and ql + 1) and its
// two rows, four scores against the pair's gates; one branch for kE such
// pairs (4 kE scores, the appends inside predicated per score: K1 takes kE
// = 1, X4 of extract.cuh 2 and 4); only scores above their gate are
// appended to their query's list. With the int gate (X9) the int32 dots
// are first held against their pairs' G: when none is above, no score can
// pass and the epilogues are not computed. Nothing here writes a gate, so
// the __restrict__ views let their loads run ahead of the appends.
template <class Kind, int kEpi, bool kIntGate, int kE = 1, int kA = kAcc>
__device__ __forceinline__ void gate_tile(
    const typename Kind::Acc (&acc)[kA], const float (&aux_r)[2],
    const float (&mask_r)[2], int row0, int offset, float* v_list0,
    int* i_list0, int cap, const float* __restrict__ gate,
    const int* __restrict__ gint, const float* __restrict__ qsv, int* len) {
  static_assert((kA / 4) % kE == 0, "kE divides the query pairs");
#pragma unroll
  for (int j0 = 0; j0 < kA / 4; j0 += kE) {
    if constexpr (kIntGate) {
      bool over = false;
#pragma unroll
      for (int u = 0; u < kE; ++u) {
        const int j = j0 + u;
        const int2 gi =
            *reinterpret_cast<const int2*>(gint + query_col(4 * j));
        over |= (acc[4 * j] > gi.x) | (acc[4 * j + 1] > gi.y) |
                (acc[4 * j + 2] > gi.x) | (acc[4 * j + 3] > gi.y);
      }
      if (!over) continue;
    }
    float s[kE][4];
    bool p[kE][4];
    bool any = false;
#pragma unroll
    for (int u = 0; u < kE; ++u) {
      const int j = j0 + u;
      const int ql = query_col(4 * j);
      const float2 g2 = *reinterpret_cast<const float2*>(gate + ql);
      const float2 q2 = kEpi == kScaleQs
                            ? *reinterpret_cast<const float2*>(qsv + ql)
                            : make_float2(0.0f, 0.0f);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[u][e] = score_epilogue<kEpi>(dot_value(acc[4 * j + e]),
                                       aux_r[e >> 1], mask_r[e >> 1],
                                       e & 1 ? q2.y : q2.x);
        p[u][e] = s[u][e] > (e & 1 ? g2.y : g2.x);
        any |= p[u][e];
      }
    }
    if (any) {
#pragma unroll
      for (int u = 0; u < kE; ++u) {
        const int ql = query_col(4 * (j0 + u));
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (p[u][e]) {
            const int qe = ql + (e & 1);
            const size_t at = (size_t)qe * cap + atomicAdd(len + qe, 1);
            v_list0[at] = s[u][e];
            i_list0[at] = row0 + 8 * (e >> 1) + offset;
          }
        }
      }
    }
  }
}

// K1 scans every tile it is given. (fused_theta.cu passes a test that lets
// a tile whose scores cannot count pass without its dots.)
struct NoSkip {
  __device__ bool operator()(int, const float*) const { return false; }
};

// K1 takes each tile's dots in one call. (extract.cuh's X3 passes dots
// that signal the other warpgroup between two ranges of the tile's
// stages.) `first`: the part's first tile; done(): after its last.
struct WholeTile {
  template <class Kind, int kA>
  __device__ __forceinline__ void tile(typename Kind::Acc (&acc)[kA],
                                       const Geometry& geo, const Ring& ring,
                                       int& stage, int& phase, bool) const {
    consume_tile<Kind>(acc, geo, ring, stage, phase);
  }
  __device__ __forceinline__ void done(bool) const {}
};

// The consumer warpgroups of K1: per row tile, the dots and the gate;
// every cut_every tiles (and at the end) the list cuts, the only points
// where the two warpgroups wait for each other. A list holds cap = k +
// (cut_every + 1) tiles of candidates (ops/cuda_topk.py: topk_plan): at a
// cut, lists longer than cap - cut_every tiles are cut back to k, so the
// next cut_every tiles (at most 128 candidates each) always fit. Query
// ql's list starts at cand_v + list0 + ql * cap (global lists: list0 =
// (part * b + q0) * cap; lists in shared memory: 0), and its length goes
// to cand_n[part * b + q0 + ql] unless cand_n is null. The ring position
// (stage, phase) continues from the caller's. kE: gate_tile's query pairs
// per branch; `dots` takes a tile's dots (WholeTile: K1's); mask: the
// row's additive mask (RowMask, FloatMask; a kernel's RowMask parameter is
// __grid_constant__, so the reference reads it in place and holds no
// registers); kN: the query group's width.
template <class Kind, int kEpi, bool kIntGate, int kE = 1, class Skip,
          class Dots = WholeTile, int kN = kGroup, class Mask>
__device__ __forceinline__ void consume_all(
    const Geometry& geo, const Ring& ring, int& stage, int& phase,
    const float* __restrict__ aux, const Mask& mask, int n,
    int b, int k, int offset, int part, int parts, int tiles, int q0,
    int cap, size_t list0, float* gate, const IntGate& ig, const float* qsv,
    int* len, unsigned* hist, float* __restrict__ cand_v,
    int* __restrict__ cand_i, int* __restrict__ cand_n, const Skip& skip,
    const Dots& dots = Dots{}) {
  using Acc = typename Kind::Acc;
  Acc acc[kN / 2];
  const int cut_every = (cap - k) / kTileRows - 1;
  int since_cut = 0;
  for (int t = part; t < tiles; t += parts) {
    // The rows' aux and mask, loaded before the dots so they have arrived
    // by the gate.
    const int row0 = t * kTileRows + tile_row(0);
    float aux_r[2], mask_r[2];
    typename Mask::Raw raw[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gr = row0 + 8 * h;
      aux_r[h] = gr < n ? ldg_f32(aux + gr) : 0.0f;
      raw[h] = mask.fetch(gr < n ? gr : 0);
    }
    if (skip(t, gate)) {
      pass_tile(geo, ring, stage, phase);
    } else {
      dots.template tile<Kind>(acc, geo, ring, stage, phase, t == part);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mask_r[h] = row0 + 8 * h < n ? Mask::value(raw[h]) : -INFINITY;
      }
      // tools/kernel_probe.py builds K1 without the gate to see where the
      // time goes; such a build returns wrong results by design.
#ifndef VROD_PROBE_NO_GATE
      gate_tile<Kind, kEpi, kIntGate, kE>(acc, aux_r, mask_r, row0, offset,
                                          cand_v + list0, cand_i + list0,
                                          cap, gate, ig.g, qsv, len);
#endif
    }
    if (++since_cut == cut_every) {
      since_cut = 0;
      consumer_sync();  // the tiles' candidates and lengths are in
      cut_lists<kIntGate, kN>(cand_v, cand_i, len, gate, ig, hist, list0,
                              q0, b, k, cap, cap - cut_every * kTileRows);
      consumer_sync();  // gates and lengths are read again
    }
  }
  dots.done(part < tiles);
  consumer_sync();
  cut_lists<kIntGate, kN>(cand_v, cand_i, len, gate, ig, hist, list0, q0, b,
                          k, cap, k);
  consumer_sync();
  if (cand_n == nullptr) return;
  for (int i = threadIdx.x; i < kN && q0 + i < b; i += kConsumers) {
    cand_n[(size_t)part * b + q0 + i] = len[i];
  }
}

// A warp's end of the merge of one query: its n gathered candidates (gv,
// gi) cut to the k best (an exact select, in place) and written to ov/oi
// ranked by (value desc, slot asc), (-inf, -1) on the ranks past them.
__device__ void merge_ranked(float* gv, int* gi, int n, int k, unsigned* hist,
                             float* __restrict__ ov, int* __restrict__ oi) {
  const int lane = threadIdx.x & 31;
  __syncwarp();
  if (n > k) {
    warp_select(gv, gi, n, k, hist);
    n = k;
  }
  __syncwarp();
  for (int e = lane; e < n; e += 32) {
    const float ve = gv[e];
    const int ke = float_key(ve);
    const int ie = gi[e];
    int rank = 0;
    for (int f = 0; f < n; ++f) {
      const int kf = float_key(gv[f]);
      rank += kf > ke || (kf == ke && gi[f] < ie);
    }
    ov[rank] = ve;
    oi[rank] = ie;
  }
  for (int e = n + lane; e < k; e += 32) {
    ov[e] = -INFINITY;
    oi[e] = -1;
  }
}

__global__ void __launch_bounds__(kMergeThreads) fused_topk_merge(
    const float* __restrict__ cand_v, const int* __restrict__ cand_i,
    const int* __restrict__ cand_n, int nparts, int cap, int b, int k,
    float* __restrict__ merge_v, int* __restrict__ merge_i,
    float* __restrict__ out_v, int* __restrict__ out_i) {
  __shared__ unsigned hist[kMergeWarps * 256];
  const int lane = threadIdx.x & 31;
  const int qq = blockIdx.x * kMergeWarps + (threadIdx.x >> 5);
  if (qq >= b) return;  // whole warp
  float* gv = merge_v + (size_t)qq * nparts * k;
  int* gi = merge_i + (size_t)qq * nparts * k;
  // Gather the part lists: each lane takes every 32nd part, and a warp
  // scan of their lengths places them, so the parts' latencies overlap.
  int n = 0;
  for (int c0 = 0; c0 < nparts; c0 += 32) {
    const int c = c0 + lane;
    const int L = c < nparts ? cand_n[(size_t)c * b + qq] : 0;
    int incl = L;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += t;
    }
    const size_t list = ((size_t)c * b + qq) * cap;
    for (int e = 0; e < L; ++e) {
      gv[n + incl - L + e] = cand_v[list + e];
      gi[n + incl - L + e] = cand_i[list + e];
    }
    n += __shfl_sync(kFull, incl, 31);
  }
  merge_ranked(gv, gi, n, k, hist + (threadIdx.x >> 5) * 256,
               out_v + (size_t)qq * k, out_i + (size_t)qq * k);
}

// The merge launch behind a scan: b / 2 blocks of two warps.
inline int launch_merge(const void* cand_v, const void* cand_i,
                        const void* cand_n, int parts, int cap, int b, int k,
                        void* merge_v, void* merge_i, void* out_v,
                        void* out_i, cudaStream_t s) {
  fused_topk_merge<<<(b + kMergeWarps - 1) / kMergeWarps, kMergeThreads, 0,
                     s>>>(
      static_cast<const float*>(cand_v), static_cast<const int*>(cand_i),
      static_cast<const int*>(cand_n), parts, cap, b, k,
      static_cast<float*>(merge_v), static_cast<int*>(merge_i),
      static_cast<float*>(out_v), static_cast<int*>(out_i));
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace vrod
