// K1's scan machinery, shared by the fused top-k scan (fused_topk.cu,
// fused_topk_small.cu: K1's long scan without a floor and its small scans,
// and its int32 gate bound, X9; fused_topk_floor.cu, the long scan from a
// floor, takes the cuts, the n256 append, Scratch and the merge), the
// one-launch sampled floor (fused_theta.cu: X6/X8) and the extraction
// experiments' gated builds (extract.cuh: X1's gate, X3, X4): the exact
// radix select, the gated core (each score tested in its register against
// its query's k-th, lists on chip filled by warp-aggregated appends and
// cut only when full, by a warp bitonic sort), and the merge of the part
// lists. See fused_topk.cu for the design.

#pragma once

#include <climits>
#include <cmath>

#include "score.cuh"

namespace vrod {
namespace {

// The most stages of K1's (and X6/X8's) TMA ring: a launch takes the
// deepest ring up to it that fits beside its queries and lists
// (ops/cuda_topk.py: topk_layout, which reads this depth from the
// library). 4 measured best of 4, 6 and 8 (PERF.md: deeper rings leave the
// lists fewer places, so more cuts without a floor; tools/kernel_ab.py
// --ring builds -DVROD_K1_RING=N).
#ifndef VROD_K1_RING
#define VROD_K1_RING 4
#endif
constexpr int kRing = VROD_K1_RING;
static_assert(kRing >= 2 &&
                  1024 + kRing * stage_bytes<F32X3>(64) <= 227 * 1024,
              "K1's ring: 2 stages or more, within a block's shared memory");

constexpr int kMergeThreads = 64;  // two queries a block: b / 2 blocks
constexpr int kMergeWarps = kMergeThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// Probe builds (tools/kernel_probe.py and kexp_probe.py,
// -DVROD_PROBE_COUNT): event counters of the gated core in device memory
// (GateLists::probe: K1's here, read and reset through vrod_probe_counts in
// fused_topk.cu; the extraction kernels' their launch's cnt): [0] warp
// appends (a warp's query pair with a passing score), [1] lists cut, [2]
// rounds of cuts (a block's), [3] tiles walked (a block's). The scan from
// a floor keeps its own (fused_topk_floor.cu: vrod_probe_counts_floor).
#ifdef VROD_PROBE_COUNT
__device__ int probe_counts[8];
#endif

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

// -- The gated core --------------------------------------------------------
//
// K1 (fused_topk.cu: its long and its small scans), its int gate (X9), the
// one-launch floor's scan (fused_theta.cu: X6/X8) and the extraction
// experiments' gated builds (extract.cuh: X1's gate, X4, X3) run this one
// core. Per row tile a consumer warpgroup takes its 64 rows' dots for the
// block's kN queries (kN / 2 accumulators a thread); each score is tested
// in the register that holds its dot against its query's k-th, held in
// registers (gates: max(theta0, the k-th the list's last cut left), +inf
// past the batch; reloaded after a cut); the passing ones are appended to
// their query's list by warp-aggregated counts (one shared atomic a warp
// and query column); one vote barrier a tile learns whether a score found
// its list full, and only then the owning warps cut their lists (a warp
// bitonic sort to 256 entries, the radix select past that) and what waited
// is tested again at or above the new k-th. No list is cut on a schedule.

// K1's query group: wgmma n64, whose 32 accumulators a thread leave room
// for its query pairs' k-ths in registers (PERF.md: the forms measured).
constexpr int kWidth = 64;

// The shape of a long scan's shared memory (K1's, X6/X8's;
// ops/cuda_topk.py: topk_layout): ring stages of the row box and the query
// box (F32X3: both query halves), then the lists when on chip.
struct Layout {
  int ring;     // stages (<= kRing)
  int cap;      // a list's places
  int on_chip;  // the lists in shared memory
  template <class Kind>
  __host__ __device__ int ring_bytes() const {
    return ring * stage_bytes<Kind>(kWidth);
  }
  // Dynamic shared memory, past the 1024-byte alignment.
  template <class Kind>
  __host__ __device__ int smem() const {
    return 1024 + ring_bytes<Kind>() + (on_chip ? kWidth * cap * 8 : 0);
  }
};

// A consumer barrier that also votes (bar.red.or on named barrier kBar):
// true in every consumer thread when `v` holds in any of them. The gated
// core's tiles vote on kBarVote, fused_theta.cuh's sample skip on
// kBarSkip.
constexpr int kBarSkip = 2;
constexpr int kBarVote = 4;

template <int kBar = kBarVote>
__device__ __forceinline__ bool consumer_any(bool v) {
  int r;
  asm volatile(
      "{\n .reg .pred p, q;\n setp.ne.b32 q, %1, 0;\n"
      " bar.red.or.pred p, %2, %3, q;\n selp.b32 %0, 1, 0, p;\n}\n"
      : "=r"(r)
      : "r"((int)v), "n"(kBar), "n"(kConsumers)
      : "memory");
  return r != 0;
}

// atomicAdd on an int in shared memory (the lists' lengths), as
// atom.shared, whose address needs no generic translation.
__device__ __forceinline__ int shared_add(int* p, int v) {
  int old;
  asm volatile("atom.shared.add.u32 %0, [%1], %2;\n"
               : "=r"(old) : "r"(smem_u32(p)), "r"(v) : "memory");
  return old;
}

// A block's lists: per query q of the group, cap places (values v, slots
// i) from q * cap, in shared memory beside the ring or, past the k where
// they fit (ops/cuda_topk.py: topk_plan), in global memory; len[q], its
// length, which a tile's appends may carry past cap (those places are not
// written: their scores wait for a cut); gate[q], max(theta0, the k-th its
// last cut left) (+inf past the batch); with the int gate (X9) gint[q], the
// int32 bound of gate[q] over the aux range [amin, amax] of the rows the
// block walks.
struct GateLists {
  float* v;
  int* i;
  int* len;
  float* gate;
  int* gint;
  float amin, amax;
  int cap, k;
#ifdef VROD_PROBE_COUNT
  int* probe;  // probe builds: the event counters (probe_counts' layout)
#endif
};

// A consumer thread's copy of its query pairs' gates (pair j: columns
// query_col(4j) and query_col(4j) + 1): the k-ths, with the int gate their
// bounds G, and for int8/int4 l2 (kScaleQs) the queries' 2 * q_scale.
template <int kP, int kEpi, bool kIntGate>
struct Gates {
  float2 g[kP];
  int2 G[kIntGate ? kP : 1];
  float2 qs[kEpi == kScaleQs ? kP : 1];
};

// Read after every cut, so never stale.
template <int kP, int kEpi, bool kIntGate>
__device__ __forceinline__ void load_gates(Gates<kP, kEpi, kIntGate>& gr,
                                           const GateLists& L) {
#pragma unroll
  for (int j = 0; j < kP; ++j) {
    const int c = query_col(4 * j);
    gr.g[j] = make_float2(L.gate[c], L.gate[c + 1]);
    if constexpr (kIntGate) gr.G[j] = make_int2(L.gint[c], L.gint[c + 1]);
  }
}

// A consumer thread's 2 * q_scale of its query pairs (kScaleQs only),
// from q_scale (doubled here) or from 2 * q_scale (`doubled`).
template <int kP, int kEpi, bool kIntGate>
__device__ __forceinline__ void load_qs(Gates<kP, kEpi, kIntGate>& gr,
                                        const float* __restrict__ qs2,
                                        bool doubled, int q0, int b) {
  if constexpr (kEpi == kScaleQs) {
#pragma unroll
    for (int j = 0; j < kP; ++j) {
      float v[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qq = q0 + query_col(4 * j) + e;
        v[e] = qq < b ? (doubled ? qs2[qq] : __fmul_rn(2.0f, qs2[qq]))
                      : 0.0f;
      }
      gr.qs[j] = make_float2(v[0], v[1]);
    }
  }
}

// The scores of query pairs [kJ0, kJ1) of acc (one 64-row slab; this
// thread's rows have slots slot0 and slot0 + 8, their aux and mask in
// aux_r, mask_r) among the candidates `cand` (bit i: acc[i]) that pass,
// above their query's gate (or with `ge` at or above it: the re-test after
// a cut, when the list may hold this tile's higher slots at the new k-th),
// join their queries' lists. The test runs in the accumulators' registers,
// unrolled, with one warp vote for the whole slab; with the int gate, a
// pair's four dots all at or below their G skip the epilogue (not in the
// re-test: what waits passed it). Then one warp-uniform branch per kE
// query pairs with a passing score appends them (one copy of that code a
// pair, unrolled, measured faster than one copy looped over the pairs:
// PERF.md). The eight lanes 4g + t of a warp hold the same two query
// columns, so lane t takes the places of all eight with one shared atomic
// a column, and ballots place each lane's scores after those of the lanes
// below it. A score placed past its list's capacity is not written and
// waits: returns the bits that wait.
template <class Kind, int kEpi, bool kIntGate, int kE, int kJ0, int kJ1,
          int kA>
__device__ __forceinline__ unsigned gate_append(
    const typename Kind::Acc (&acc)[kA], const float (&aux_r)[2],
    const float (&mask_r)[2], int slot0,
    const Gates<kA / 4, kEpi, kIntGate>& gr, const GateLists& L,
    unsigned cand, bool ge) {
  static_assert(kA <= 32 && (kJ1 - kJ0) % kE == 0 && kE <= 4,
                "one 64-row slab; kE divides the pairs");
  float s[kA];
  unsigned bits = 0;
#pragma unroll
  for (int j = kJ0; j < kJ1; ++j) {
    bool over = true;
    if constexpr (kIntGate) {
      over = ge || acc[4 * j] > gr.G[j].x || acc[4 * j + 1] > gr.G[j].y ||
             acc[4 * j + 2] > gr.G[j].x || acc[4 * j + 3] > gr.G[j].y;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * j + e;
      s[i] = 0.0f;
      if (over) {
        float qs = 0.0f;
        if constexpr (kEpi == kScaleQs) qs = e & 1 ? gr.qs[j].y : gr.qs[j].x;
        s[i] = score_epilogue<kEpi>(dot_value(acc[i]), aux_r[e >> 1],
                                    mask_r[e >> 1], qs);
        const float g = e & 1 ? gr.g[j].y : gr.g[j].x;
        const bool pass = ((cand >> i) & 1u) && (ge ? s[i] >= g : s[i] > g);
        bits |= (unsigned)pass << i;
      }
    }
  }
  if (!__any_sync(kFull, bits != 0)) return 0;
#ifdef VROD_PROBE_TEST_ONLY
  return 0;  // probe builds: the test without the appends
#endif
  const int lane = threadIdx.x & 31;
  const unsigned same = 0x11111111u << (lane & 3);
  const unsigned lt = lanemask_lt();
  unsigned wait = 0;
#pragma unroll
  for (int j0 = kJ0; j0 < kJ1; j0 += kE) {
    if (!__any_sync(kFull, (bits >> (4 * j0)) & ((1u << (4 * kE)) - 1u))) {
      continue;
    }
#pragma unroll
    for (int u = 0; u < kE; ++u) {
      const int j = j0 + u;
      const unsigned b4 = (bits >> (4 * j)) & 15u;
      const int col = query_col(4 * j);  // columns col, col + 1
      int at[2], base[2] = {0, 0};
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const unsigned c0 = __ballot_sync(kFull, (b4 >> e) & 1u) & same;
        const unsigned c1 = __ballot_sync(kFull, (b4 >> (2 + e)) & 1u) & same;
        const int cnt = __popc(c0) + __popc(c1);
        at[e] = __popc(c0 & lt) + __popc(c1 & lt);
        if (lane < 4 && cnt > 0) base[e] = shared_add(L.len + col + e, cnt);
        at[e] += __shfl_sync(kFull, base[e], lane & 3);
      }
#ifdef VROD_PROBE_COUNT
      if (lane == 0) atomicAdd(L.probe + 0, 1);
#endif
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if ((b4 >> e) & 1u) {
          const int p = at[e & 1]++;
          if (p < L.cap) {
            const size_t w = (size_t)(col + (e & 1)) * L.cap + p;
            L.v[w] = s[4 * j + e];
            L.i[w] = slot0 + 8 * (e >> 1);
          } else {
            wait |= 1u << (4 * j + e);
          }
        }
      }
    }
  }
  return wait;
}

// Whether (va, ia) ranks before (vb, ib): value desc, then slot asc.
__device__ __forceinline__ bool ranks_before(float va, int ia, float vb,
                                             int ib) {
  return va > vb || (va == vb && ia < ib);
}

// A whole warp cuts the list (v, ix)[0, n), k <= n <= 256, to its k best
// by (value desc, slot asc), written sorted to [0, k), and returns the k-th
// value: a bitonic sort of the entries padded to 256 with (-inf, INT_MAX),
// lane l holding entries 8l..8l+7 in registers (strides under 8 within a
// lane, the others between lanes by shuffles). No shared atomics, unlike
// warp_select's radix passes, whose histograms all lists' similar values
// crowd into a few bins.
__device__ float sort_cut(float* v, int* ix, int n, int k) {
  const int lane = threadIdx.x & 31;
  float a[8];
  int b[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int e = 8 * lane + r;
    a[r] = e < n ? v[e] : -INFINITY;
    b[r] = e < n ? ix[e] : INT_MAX;
  }
#pragma unroll
  for (int size = 2; size <= 256; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride >= 8) {
        const bool lower = (lane & (stride >> 3)) == 0;
        const bool asc = ((8 * lane) & size) == 0;
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const float ov = __shfl_xor_sync(kFull, a[r], stride >> 3);
          const int oi = __shfl_xor_sync(kFull, b[r], stride >> 3);
          const bool other = ranks_before(ov, oi, a[r], b[r]);
          if (other == (lower == asc)) {
            a[r] = ov;
            b[r] = oi;
          }
        }
      } else {
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          if (r & stride) continue;
          const int q = r | stride;
          const bool asc = ((8 * lane + r) & size) == 0;
          if (ranks_before(a[q], b[q], a[r], b[r]) == asc) {
            const float tv = a[r];
            const int ti = b[r];
            a[r] = a[q];
            b[r] = b[q];
            a[q] = tv;
            b[q] = ti;
          }
        }
      }
    }
  }
  __syncwarp();  // every lane has read its entries
  float kth = -INFINITY;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int e = 8 * lane + r;
    if (e < k) {
      v[e] = a[r];
      ix[e] = b[r];
    }
    if (e == k - 1) kth = a[r];
  }
  __syncwarp();
  return __shfl_sync(kFull, kth, (k - 1) >> 3);
}

// The cut of a list of n > k entries to its k best for k <= 192
// (kSortLongK), written sorted to [0, k), and its k-th value, with no
// shared memory and no atomics: sort_cut of its first 256 entries (or
// all), then of the k kept beside each next window of 256 - k entries (at
// least 64), moved behind them. K1's scan from a floor, whose lists in
// global memory hold k + 5 row tiles.
constexpr int kSortLongK = 192;

__device__ float sort_cut_long(float* v, int* ix, int n, int k) {
  const int lane = threadIdx.x & 31;
  int m = min(n, 256);  // entries [0, m) to sort
  float kth;
  for (int w = m;; ) {
    kth = sort_cut(v, ix, m, k);
    if (w >= n) return kth;
    m = min(256 - k, n - w);
    for (int e = lane; e < m; e += 32) {
      v[k + e] = v[w + e];
      ix[k + e] = ix[w + e];
    }
    __syncwarp();
    w += m;
    m += k;
  }
}

// The n256 instance of the gated core's append (gate_append, whose k-ths
// sit in registers, one 64-query slab): K1's scan from a floor, whose
// consumer threads hold 32 query pairs of a tile's scores, read their
// gates from shared memory, and see few scores pass. Its test records each
// query pair with a passing score (Pending: the pair's four scores, and j
// | bits << 8: pair j, columns query_col(4j) and + 1, rows slot0 and
// slot0 + 8, bit e for s[e]), and append_pending appends them all in one
// loop: one copy of the appends' code a kernel (an append block a pair in
// the unrolled test measured slower, PERF.md).
struct Pending {
  float s[4];
  int jb;
};

// Round r takes every lane's r-th record; per score of it the lanes
// appending to the same column take their places at once: a match, one
// shared atomic by the lowest of them, and each lane's place by popcount,
// in the lists of cap places from col * cap (lengths len). The lists
// never fill between two cuts (the caller's cap), so every score is kept.
__device__ __forceinline__ void append_pending(const Pending* rec, int n,
                                               int slot0, int* len,
                                               float* v, int* ix, int cap) {
  const int lane = threadIdx.x & 31;
  const unsigned lt = lanemask_lt();
  const int rounds = __reduce_max_sync(kFull, n);
  for (int r = 0; r < rounds; ++r) {
    Pending p{};
    if (r < n) p = rec[r];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool bit = (p.jb >> (8 + e)) & 1;
      if (!__any_sync(kFull, bit)) continue;
      const int col = bit ? query_col(4 * (p.jb & 255)) + (e & 1) : -1;
      const unsigned peers = __match_any_sync(kFull, col);
      const int leader = __ffs(peers) - 1;
      int base = 0;
      if (bit && lane == leader) {
        base = shared_add(len + col, __popc(peers));
#ifdef VROD_PROBE_COUNT
        atomicAdd(probe_counts + 4, 1);
#endif
      }
      base = __shfl_sync(kFull, base, leader);
      if (bit) {
#ifdef VROD_PROBE_COUNT
        atomicAdd(probe_counts + 0, 1);
#endif
        const size_t w = (size_t)col * cap + base + __popc(peers & lt);
        v[w] = p.s[e];
        ix[w] = slot0 + 8 * (e >> 1);
      }
    }
  }
}

// A cut of a list of n entries to its k best (k < n): sort_cut to 256
// entries (measured 6-10% faster end to end than warp_select, PERF.md),
// else warp_select; returns the new k-th value.
__device__ __forceinline__ float cut_list(float* v, int* ix, int n, int k,
                                          unsigned* hist) {
  if (n <= 256) return sort_cut(v, ix, n, k);
  return key_float(warp_select(v, ix, n, k, hist));
}

// A round, after a vote found a waiting score: each warp cuts every list
// of the queries it owns [own0, own1) that holds more than k entries (the
// full ones and the others alike: fewer rounds for the same cuts than
// cutting only the full or the half-full ones, PERF.md) to its k best and
// raises its gate to the new k-th value (with the int gate, and its G);
// then every consumer thread reads its gates again.
template <int kP, int kEpi, bool kIntGate>
__device__ __forceinline__ void gate_round(const GateLists& L,
                                           unsigned* hist, int own0,
                                           int own1,
                                           Gates<kP, kEpi, kIntGate>& gr) {
#ifdef VROD_PROBE_COUNT
  if (threadIdx.x == 0) atomicAdd(L.probe + 2, 1);
#endif
  for (int q = own0; q < own1; ++q) {
    const int n = min(L.len[q], L.cap);
    if (n <= L.k) continue;  // warp-uniform
    const float kth = cut_list(L.v + (size_t)q * L.cap,
                               L.i + (size_t)q * L.cap, n, L.k, hist);
    if ((threadIdx.x & 31) == 0) {
#ifdef VROD_PROBE_COUNT
      atomicAdd(L.probe + 1, 1);
#endif
      L.len[q] = L.k;
      const float g = fmaxf(L.gate[q], kth);
      L.gate[q] = g;
      if constexpr (kIntGate) L.gint[q] = int_gate(g, L.amin, L.amax);
    }
  }
  consumer_sync();  // the cut lists and raised gates are read again
  load_gates(gr, L);
}

// A copy of an accumulator in a register of its own, made where the copy
// stands (asm volatile: the compiler may not sink it into the test's
// divergent branches). The test reads the copies, so no accumulator of
// the wgmma pipeline is read in a divergent path, where ptxas would insert
// a warpgroup arrive and serialize the wgmmas.
__device__ __forceinline__ int acc_copy(int a) {
  int r;
  asm volatile("mov.b32 %0, %1;\n" : "=r"(r) : "r"(a));
  return r;
}

__device__ __forceinline__ float acc_copy(float a) {
  float r;
  asm volatile("mov.b32 %0, %1;\n" : "=f"(r) : "f"(a));
  return r;
}

// K1 scans every tile it is given. (fused_theta.cu passes a test that lets
// a tile whose scores cannot count pass without its dots.)
struct NoSkip {
  __device__ bool operator()(int, const float*) const { return false; }
};

// The consumer warpgroups' walk over a part's row tiles t = part, part +
// parts, ... < tiles, in ascending order (rows n and on read as -inf),
// from ring position (stage, phase): per tile the dots, the test and
// appends in the accumulators' registers, one vote barrier, and rounds
// while a score waits. Slots are row + offset; mask: the rows' additive
// mask (RowMask, FloatMask; fetched with the aux before the dots, so the
// loads' latency hides under them); own0, own1: the queries this warp cuts
// (kN / 8 a warp); kE: query pairs a branch (X4's unrolled builds).
template <class Kind, int kEpi, bool kIntGate, int kE, int kN, class Mask,
          class Skip = NoSkip>
__device__ __forceinline__ void gate_consume(
    const Geometry& geo, const Ring& ring, int& stage, int& phase,
    const float* __restrict__ aux, const Mask& mask, int n, int offset,
    int part, int parts, int tiles, const GateLists& L,
    Gates<kN / 8, kEpi, kIntGate>& gr, unsigned* hist, int own0, int own1,
    const Skip& skip = Skip{}) {
  constexpr int kA = kN / 2;
  constexpr int kP = kA / 4;
  using Acc = typename Kind::Acc;
  Acc acc[kA];
  for (int t = part; t < tiles; t += parts) {
    const int row0 = t * kTileRows + tile_row(0);
    float aux_r[2], mask_r[2];
    typename Mask::Raw raw[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + 8 * h;
      aux_r[h] = r < n ? ldg_f32(aux + r) : 0.0f;
      raw[h] = mask.fetch(r < n ? r : 0);
    }
#ifdef VROD_PROBE_COUNT
    if (threadIdx.x == 0) atomicAdd(L.probe + 3, 1);
#endif
    if (skip(t, L.gate)) {
      pass_tile(geo, ring, stage, phase);
      continue;
    }
    consume_tile_overlap<Kind>(acc, geo, ring, stage, phase);
    Acc dot[kA];
#pragma unroll
    for (int i = 0; i < kA; ++i) dot[i] = acc_copy(acc[i]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mask_r[h] = row0 + 8 * h < n ? Mask::value(raw[h]) : -INFINITY;
    }
#ifdef VROD_PROBE_NO_GATE
    // tools' probe builds: the scan without the test (wrong results by
    // design), with its vote barrier unless VROD_PROBE_NO_CUT_BARRIERS.
#ifndef VROD_PROBE_NO_CUT_BARRIERS
    if (consumer_any(false)) break;
#endif
    continue;
#endif
    unsigned wait = gate_append<Kind, kEpi, kIntGate, kE, 0, kP>(
        dot, aux_r, mask_r, row0 + offset, gr, L, ~0u, false);
    while (consumer_any(wait != 0)) {
      gate_round(L, hist + (threadIdx.x >> 5) * 256, own0, own1, gr);
      wait = gate_append<Kind, kEpi, kIntGate, kE, 0, kP>(
          dot, aux_r, mask_r, row0 + offset, gr, L, wait, true);
    }
  }
}

// The hand-over at the part's end: each list the warp owns cut to its k
// best. With cand_n, its length goes to cand_n[len0 + q] and, for lists on
// chip, its entries to the (part, query) lists of cand_v/cand_i at stride k
// from list0 (lists in global memory are already there, at stride cap):
// what fused_topk_merge reads. Without (K1's small scans), the cut lists
// stay in shared memory with their lengths in L.len.
__device__ __forceinline__ void gate_handover(const GateLists& L,
                                              unsigned* hist, int own0,
                                              int own1, bool on_chip,
                                              float* __restrict__ cand_v,
                                              int* __restrict__ cand_i,
                                              int* __restrict__ cand_n,
                                              size_t list0, size_t len0) {
  const int lane = threadIdx.x & 31;
  for (int q = own0; q < own1; ++q) {
    __syncwarp();
    int n = min(L.len[q], L.cap);
    float* v = L.v + (size_t)q * L.cap;
    int* ix = L.i + (size_t)q * L.cap;
    if (n > L.k) {
      cut_list(v, ix, n, L.k, hist);
      n = L.k;
    }
    __syncwarp();
    if (cand_n == nullptr) {
      if (lane == 0) L.len[q] = n;
      continue;
    }
    if (on_chip) {
      for (int e = lane; e < n; e += 32) {
        cand_v[list0 + (size_t)q * L.k + e] = v[e];
        cand_i[list0 + (size_t)q * L.k + e] = ix[e];
      }
    }
    if (lane == 0) cand_n[len0 + q] = n;
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

// The smallest and largest aux over the rows of a block's row tiles (part,
// part + parts, ... < tiles), reduced by the whole block into lo_hi; a NaN
// makes lo NaN, which turns the int gate off.
__device__ void aux_range(const float* __restrict__ aux, int n, int part,
                          int parts, int tiles, float* lo_hi) {
  __shared__ float red[2][kThreads / 32];
  float lo = INFINITY, hi = -INFINITY;
  int nan = 0;
  const long rows = (long)((tiles - part + parts - 1) / parts) * kTileRows;
  for (long e = threadIdx.x; e < rows; e += kThreads) {
    const long r = (part + e / kTileRows * parts) * (long)kTileRows
                   + e % kTileRows;
    if (r < n) {
      const float a = aux[r];
      nan |= a != a;
      lo = fminf(lo, a);
      hi = fmaxf(hi, a);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(kFull, lo, o));
    hi = fmaxf(hi, __shfl_xor_sync(kFull, hi, o));
  }
  if ((threadIdx.x & 31) == 0) {
    red[0][threadIdx.x >> 5] = lo;
    red[1][threadIdx.x >> 5] = hi;
  }
  nan = __syncthreads_or(nan);
  if (threadIdx.x == 0) {
    for (int w = 1; w < kThreads / 32; ++w) {
      lo = fminf(lo, red[0][w]);
      hi = fmaxf(hi, red[1][w]);
    }
    lo_hi[0] = nan ? NAN : lo;
    lo_hi[1] = hi;
  }
  __syncthreads();
}

// The scratch of a long scan, one buffer: lists (parts, b, stride) of
// values and of slots (stride k when the lists were on chip, else cap),
// their lengths (parts, b), and the merge's gather (b, parts, k) of values
// and of slots.
struct Scratch {
  float* cand_v;
  int* cand_i;
  int* cand_n;
  float* merge_v;
  int* merge_i;
  Scratch(void* base, int parts, int b, int k, int stride) {
    const size_t lists = (size_t)parts * b * stride;
    const size_t gather = (size_t)b * parts * k;
    cand_v = static_cast<float*>(base);
    cand_i = reinterpret_cast<int*>(cand_v + lists);
    cand_n = cand_i + lists;
    merge_v = reinterpret_cast<float*>(cand_n + (size_t)parts * b);
    merge_i = reinterpret_cast<int*>(merge_v + gather);
  }
};

// The maps of a K1 launch: the wrapper's cached encodings when it gives
// them, else encoded here (X9), the queries in boxes of a group; in the
// copying build the granule.
template <class Kind, bool kTma>
int launch_maps(Maps* maps, const void* const* m3, const void* x,
                const void* q, int n, int b, int row_bytes, int q_box,
                int granule) {
  if constexpr (!kTma) return copy_maps(maps, x, q, row_bytes, granule);
  if (m3 != nullptr) {
    *maps = maps_from(m3[0], m3[1], m3[2]);
    return 0;
  }
  return make_maps(maps, Kind::kHalves, x, q, n, b, row_bytes, q_box);
}

}  // namespace
}  // namespace vrod
