// The extraction experiments of the JAX package, X1-X4, on K1's scoring
// core (score.cuh's producer, ring and wgmma consumers; topk.cuh's radix
// select and merge). Each mode is built in a .cu file of its own
// (extract_<mode>.cu), one C entry point per file (the gated modes, the
// store and the carry add their shared-memory account), in two builds, as
// K1's: rows and queries loaded by TMA, and for the shapes TMA cannot load
// (row bytes not a multiple of 16, unaligned bases: int8 dim 30 or 100,
// bfloat16 dim 100, float32 dim 25) the same kernel with the producer
// warpgroup copying each stage into the same swizzled layout (score.cuh:
// copy_stage, by the granule the wrapper picks; kTma false), built apart
// in extract_<mode>_copy.cu so that nvcc compiles both at once. The
// wrapper picks the build by shape (cuda_topk.copy_granule).
//
// Replaces the Pallas kernels experiments/kexp.py: make_call -> build_kernel
// (X1), kexp2.py: make_call (X2), kexp3.py: make_call (X3) and kexp5.py:
// make_call -> build_kernel (X4). Each scores whole blocks of block_rows
// rows (rows after the last whole block are never read) with the
// experiments' epilogue, score = epi(g) + mask with epi cosine g * aux, l2
// 2g - aux, dot g, for int8 rows (int8 query, exact int32 dots), bfloat16
// and float32 rows (TF32 at precision_name "fast", three TF32 products,
// score.cuh's F32X3, at "high" and "exact": the experiments' HIGH and
// HIGHEST), and returns the exact top-k by (value desc, slot asc), slots
// col + offset[0], (-inf, -1) on empty ranks. All four ask what
// the extraction of the top-k from a scored block costs. Every mode but the
// floor runs query groups of 64 (wgmma m64n64, kNarrow: measured faster
// than n128 for each), keeps its lists or carry in shared memory beside the
// 4-stage ring where they fit (global memory past that), places passing
// scores by warp-aggregated counts (one shared atomic a warp and query
// column) and cuts or merges a query's list only when it is full, in the
// warp that owns the query. What each mode does:
//   kXFloor     X1 floor: the dots, the epilogue and a running max per
//               query in registers, at K1's 256-query groups; no lists, no
//               cuts. Every rank holds the query's max, ids -1 (kexp.py's
//               floor). The scan's floor.
//   kXStore     X1 base/maxref ("store the block, then extract"): every
//               score of a tile goes to a score tile in shared memory; then
//               each consumer warp reads its queries' stored scores and
//               appends those above the query's k-th (the value a cut last
//               left, -inf before) to the query's list.
//   kXGate      X1 gate/nostore/argmax/subdot and X4 (kE = 1, 2, 4):
//               topk.cuh's gated core, K1's own: the scores stay in the
//               registers that hold their dots; each is held against its
//               query's k-th (kept in registers, reloaded after a cut) and
//               the passing ones are appended, one warp-uniform branch per
//               kE query pairs. One vote barrier a tile learns whether a
//               score found its list full; if so the owning warps cut their
//               full lists, and what waited is tested again at or above the
//               new k-th (rounds: gate_round).
//   kXPingPong  X3: kXGate's lists, test and cuts, with the gate of tile t
//               under the wgmmas of tile t + 1: each consumer warpgroup
//               issues the next tile's stages into a second set of
//               accumulators and gates a share of this tile's scores
//               between the issues.
//   kXCarry     X2: a sorted running top-k of exactly k (value, slot) per
//               query, with no candidate lists, no cuts and no locks. Per
//               tile each score above its query's carried k-th joins the
//               query's stage in shared memory; after one consumer barrier
//               the warp that owns a query whose stage is full sorts it in
//               its lanes (bitonic) and merges it into the carry (binary
//               search and a shift), keeping k. Stages alternate between
//               two buffers a tile, so one barrier a tile; a stage that
//               overflows is merged and refilled in rounds. With `count`,
//               one part per query group walks the rows in global order
//               and counts, after each block, the carry entries that block
//               put there (kexp2's while-iterations follow from those
//               counts).
// What bounds every mode: K1's bound, the rows once (805 MB at the int8
// main path, 0.24 ms at 3.35 TB/s) with the dots close behind; at n64 each
// row tile is read by four blocks (one a query group), from L2 after the
// first.

#pragma once

#include <type_traits>

#include "topk.cuh"

namespace vrod {
namespace {

enum XMode : int {
  kXFloor = 0,
  kXStore = 1,
  kXGate = 2,
  kXPingPong = 3,
  kXCarry = 4
};

// The query group of every mode but the floor (wgmma n64, K1's kWidth):
// measured faster than n128 for the store, the carry and the gate
// (PERF.md).
constexpr int kNarrow = kWidth;

// One launch's arguments (ops/cuda_extract.py: _launch).
struct XArgs {
  const int8_t* x;      // (n, row_bytes): the whole blocks only
  const int8_t* q;      // (b, row_bytes), as the kernel reads it (F32X3:
                        // (b, 2 * row_bytes), big then small parts)
  const float* aux;     // (n,)
  const float* mask;    // (n,) additive
  const int* offset;    // (1,) added to every slot
  int n, b, k, row_bytes, groups, parts, cap, block_rows;
  int count;            // kXCarry: count the carry entries per block
  int on_chip;          // kXStore: the lists, kXCarry: the carry, in shared
                        // memory (handed over as (parts, b, k) lists)
  int stage;            // kXCarry: entries of each stage a query (<= 32)
  int granule;          // the copying build's (score.cuh: Maps)
  float* cand_v;        // lists (parts, b, cap, or k when on_chip);
  int* cand_i;          // kXFloor: maxima (parts, b)
  int* cand_n;          // (parts, b)
  int* cnt;             // kXCarry with count: (n / block_rows, b)
};

// The experiments' score of acc[i] (its row's aux and mask in aux_r[h],
// mask_r[h], h = (i >> 1) & 1).
template <class Kind, int kEpi, int kA>
__device__ __forceinline__ float x_score(
    const typename Kind::Acc (&acc)[kA], int i, const float (&aux_r)[2],
    const float (&mask_r)[2]) {
  return score_epilogue<kEpi>(dot_value(acc[i]), aux_r[(i >> 1) & 1],
                              mask_r[(i >> 1) & 1], 0.0f);
}

// The rows' aux and mask of one tile for this thread (rows row0 and row0 +
// 8, -inf past n).
__device__ __forceinline__ void x_rows(const XArgs& a, int row0,
                                       float (&aux_r)[2],
                                       float (&mask_r)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int gr = row0 + 8 * h;
    aux_r[h] = gr < a.n ? ldg_f32(a.aux + gr) : 0.0f;
    mask_r[h] = gr < a.n ? ldg_f32(a.mask + gr) : -INFINITY;
  }
}

// -- X2: the carry -----------------------------------------------------------

// This thread's waiting scores (bit i of `wait`: acc[i]) join their
// queries' stage (values sv, slots si: S places a query; counts sn). The
// eight lanes 4g + t of a warp hold the same two query columns, so lane t
// takes the places of all eight with one shared atomic a column, and
// ballots place each lane's scores after those of the lanes below it. A
// score whose stage is full keeps waiting; returns the bits that wait.
template <class Kind, int kEpi, int kA, class W>
__device__ __forceinline__ W carry_stage(const typename Kind::Acc (&acc)[kA],
                                         const float (&aux_r)[2],
                                         const float (&mask_r)[2], int slot0,
                                         W wait, float* sv, int* si, int* sn,
                                         int S) {
  const int lane = threadIdx.x & 31;
  const unsigned same = 0x11111111u << (lane & 3);
  const unsigned lt = lanemask_lt();
#pragma unroll
  for (int j = 0; j < kA / 4; ++j) {
    const unsigned bits = (unsigned)(wait >> (4 * j)) & 15u;
    if (!__any_sync(kFull, bits != 0)) continue;
    const int col = query_col(4 * j);  // columns col (e = 0) and col + 1
    int at[2], cnt[2], base[2] = {0, 0};
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const unsigned b0 = __ballot_sync(kFull, (bits >> e) & 1u) & same;
      const unsigned b1 =
          __ballot_sync(kFull, (bits >> (2 + e)) & 1u) & same;
      cnt[e] = __popc(b0) + __popc(b1);
      at[e] = __popc(b0 & lt) + __popc(b1 & lt);
      if (lane < 4 && cnt[e] > 0) base[e] = atomicAdd(sn + col + e, cnt[e]);
      at[e] += __shfl_sync(kFull, base[e], lane & 3);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if ((bits >> i) & 1u) {
        const int e = i & 1;
        const int p = at[e]++;
        if (p < S) {
          const int q = col + e;
          sv[q * S + p] = x_score<Kind, kEpi>(acc, 4 * j + i, aux_r, mask_r);
          si[q * S + p] = slot0 + 8 * (i >> 1);
          wait &= ~((W)1 << (4 * j + i));
        }
      }
    }
  }
  return wait;
}

// A whole warp merges one query's stage, m (1..32) entries (sv, si), into
// its carry (cv, ci)[0, k), sorted by (value desc, slot asc) with (-inf,
// -1) on empty ranks: the stage is sorted in the lanes (a bitonic network
// over the least power of two >= m lanes), each entry finds by binary
// search the c carry entries that come before it (so it lands at c +
// lane), and the carry entries from the first such place on move down by
// the stage entries that come before them, four chunks of 32 at a time
// from the top, each batch read before it is written; what passes rank k
// drops. Returns the carry's new k-th value.
__device__ float carry_merge(float* cv, int* ci, int k, const float* sv,
                             const int* si, int m) {
  const int lane = threadIdx.x & 31;
  float v = lane < m ? sv[lane] : -INFINITY;
  int id = lane < m ? si[lane] : INT_MAX;
  for (int size = 2; size < 2 * m; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const float ov = __shfl_xor_sync(kFull, v, stride);
      const int oi = __shfl_xor_sync(kFull, id, stride);
      const bool better = ov > v || (ov == v && oi < id);
      const bool keep_best = ((lane & size) == 0) == ((lane & stride) == 0);
      if (better == keep_best) {
        v = ov;
        id = oi;
      }
    }
  }
  int c = k;
  if (lane < m) {
    int lo = 0, hi = k;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      const float w = cv[mid];
      if (w > v || (w == v && ci[mid] < id)) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    c = lo;
  }
  const int cmin = __shfl_sync(kFull, c, 0);
  if (cmin < k) {
    // Four chunks at a time, from the top: all four read, then written.
    const int low = cmin >> 5;
    for (int top = (k - 1) >> 5; top >= low; top -= 4) {
      float w[4];
      int wi[4], dst[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = (top - u) * 32 + lane;
        // The stage entries before carry entry i: those with c <= i.
        int add = 0;
#pragma unroll
        for (int st = 16; st > 0; st >>= 1) {
          const int cl = __shfl_sync(kFull, c, add + st - 1);
          if (add + st <= m && cl <= i) add += st;
        }
        dst[u] = top - u >= low && i >= cmin && i + add < k ? i + add : -1;
        if (dst[u] >= 0) {
          w[u] = cv[i];
          wi[u] = ci[i];
        }
      }
      __syncwarp();
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (dst[u] >= 0) {
          cv[dst[u]] = w[u];
          ci[dst[u]] = wi[u];
        }
      }
      __syncwarp();
    }
    if (lane < m && c + lane < k) {
      cv[c + lane] = v;
      ci[c + lane] = id;
    }
    __syncwarp();
  }
  return cv[k - 1];
}

// The carry entries of one query that lie in slots [lo, lo + rows).
__device__ int carry_count(const float* cv, const int* ci, int k, long lo,
                           int rows) {
  int n = 0;
  for (int base = 0; base < k; base += 32) {
    const int e = base + (threadIdx.x & 31);
    bool in = false;
    if (e < k) {
      const long id = ci[e];
      in = cv[e] > -INFINITY && id >= lo && id < lo + rows;
    }
    n += __popc(__ballot_sync(kFull, in));
  }
  return n;
}

// A warp merges the stages of at least `at` entries of the queries it owns
// [own0, own1) in one buffer (values bv, slots bi, counts bn) into their
// carries, and raises their gates.
__device__ void carry_merge_own(int own0, int own1, int k, int S, int at,
                                float* bv, int* bi, int* bn, float* cv,
                                int* ci, float* gate) {
  for (int ql = own0; ql < own1; ++ql) {
    const int m = min(bn[ql], S);
    if (m == 0 || m < at) continue;  // warp-uniform
    const float kth = carry_merge(cv + (size_t)ql * k, ci + (size_t)ql * k, k,
                                  bv + ql * S, bi + ql * S, m);
    if ((threadIdx.x & 31) == 0) {
      gate[ql] = kth;
      bn[ql] = 0;
    }
  }
}

// X2's consumer warpgroups. Per tile: the dots; each score above its
// query's carried k-th (gate: exact after each merge; a stale read is
// lower, which is sound) waits for a place in its query's stage of this
// tile's buffer; the vote barrier; then each warp merges the stages of the
// queries it owns (kN / 8 of them) that are full and raises their gates,
// while the other warps may already stage the next tile into the other
// buffer. A stage waits in its buffer until it is full (or until another
// stage of the buffer fills, or the carry must be exact: a counted block's
// end, the part's end), so one merge takes up to S passing scores of
// several tiles at once; what waits above the carried k-th only keeps the
// gate lower, which is sound (merging every tile, or at 16 or 24 of 32,
// measured slower: PERF.md). When a stage filled, every warp waits for the merges
// (now of every stage of the buffer), re-tests what still waits against
// the new k-th (at or above it now: the carry may hold this tile's rows,
// and a tie with a lower slot comes first) and stages it, in rounds until
// nothing waits. At a counted block's end and at the part's end every
// stage of both buffers is merged, behind barriers that keep the other
// warps from staging into them meanwhile.
template <class Kind, int kEpi, int kN>
__device__ __forceinline__ void carry_consume(const Geometry& geo,
                                              const Ring& ring,
                                              const XArgs& a, int part,
                                              int tiles, int q0, float* gate,
                                              int* staged, float* cv,
                                              int* ci, float* sv, int* si) {
  constexpr int kA = kN / 2;
  constexpr int kOwn = kN / (kConsumers / 32);
  using Acc = typename Kind::Acc;
  using Wait = typename std::conditional<(kA > 32), unsigned long long,
                                         unsigned>::type;
  const int lane = threadIdx.x & 31;
  const int own0 = (threadIdx.x >> 5) * kOwn;
  const int own1 = min(own0 + kOwn, a.b - q0);
  const int offset = *a.offset;
  const int S = a.stage, k = a.k;
  Acc acc[kA];
  int stage = 0, phase = 0, buf = 0;
  for (int t = part; t < tiles; t += a.parts) {
    const int row0 = t * kTileRows + tile_row(0);
    float aux_r[2], mask_r[2];
    x_rows(a, row0, aux_r, mask_r);
    consume_tile<Kind>(acc, geo, ring, stage, phase);
    Wait wait = 0;
#pragma unroll
    for (int i = 0; i < kA; ++i) {
      if (x_score<Kind, kEpi>(acc, i, aux_r, mask_r) > gate[query_col(i)]) {
        wait |= (Wait)1 << i;
      }
    }
    float* bv = sv + (size_t)buf * kN * S;
    int* bi = si + (size_t)buf * kN * S;
    int* bn = staged + buf * kN;
    const bool block_end =
        a.count && ((t + 1) * kTileRows) % a.block_rows == 0;
    for (;;) {
      wait = carry_stage<Kind, kEpi>(acc, aux_r, mask_r, row0 + offset, wait,
                                     bv, bi, bn, S);
      const bool more = consumer_any(wait != 0);
      carry_merge_own(own0, own1, k, S,
                      more || block_end ? 1 : S, bv, bi, bn, cv, ci, gate);
      if (!more) break;
      consumer_sync();  // the merges are done: the stages are free
#pragma unroll
      for (int i = 0; i < kA; ++i) {
        if (((wait >> i) & 1) &&
            !(x_score<Kind, kEpi>(acc, i, aux_r, mask_r) >=
              gate[query_col(i)])) {
          wait &= ~((Wait)1 << i);
        }
      }
    }
    if (block_end) {
      // One part walks every tile in order: with the other buffer's stages
      // merged too, the carries hold the exact top-k of the rows up to
      // this block's end.
      consumer_sync();  // no warp stages the next tile yet
      carry_merge_own(own0, own1, k, S, 1, sv + (size_t)(buf ^ 1) * kN * S,
                      si + (size_t)(buf ^ 1) * kN * S, staged + (buf ^ 1) * kN,
                      cv, ci, gate);
      const int j = (t + 1) * kTileRows / a.block_rows - 1;
      const long lo = (long)j * a.block_rows + offset;
      for (int ql = own0; ql < own1; ++ql) {
        const int c = carry_count(cv + (size_t)ql * k, ci + (size_t)ql * k,
                                  k, lo, a.block_rows);
        if (lane == 0) a.cnt[(size_t)j * a.b + q0 + ql] = c;
      }
      consumer_sync();  // the other buffer is merged before it is staged
    }
    buf ^= 1;
  }
  consumer_sync();  // every tile is staged: what waits in either buffer
  for (int b2 = 0; b2 < 2; ++b2) {
    carry_merge_own(own0, own1, k, S, 1, sv + (size_t)b2 * kN * S,
                    si + (size_t)b2 * kN * S, staged + b2 * kN, cv, ci, gate);
  }
  // The hand-over: each carry's finite entries are its prefix.
  const size_t list0 = ((size_t)part * a.b + q0) * k;
  for (int ql = own0; ql < own1; ++ql) {
    int n = 0;
    for (int base = 0; base < k; base += 32) {
      const int e = base + lane;
      const float v = e < k ? cv[(size_t)ql * k + e] : -INFINITY;
      n += __popc(__ballot_sync(kFull, v > -INFINITY));
      if (a.on_chip && e < k) {
        a.cand_v[list0 + (size_t)ql * k + e] = v;
        a.cand_i[list0 + (size_t)ql * k + e] = ci[(size_t)ql * k + e];
      }
    }
    if (lane == 0) a.cand_n[(size_t)part * a.b + q0 + ql] = n;
  }
}

template <class Kind, int kEpi, int kN, bool kTma>
__global__ void __launch_bounds__(kThreads, 1) extract_carry(
    const __grid_constant__ Maps maps, const __grid_constant__ XArgs a) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t full[kRing], empty[kRing];
  __shared__ float gate[kN];       // the carried k-th; +inf past the batch
  __shared__ int staged[2 * kN];   // entries of each stage, two buffers
  uint8_t* base = align1024(smem_raw);
  const Ring ring{base, full, empty, kRing, !kTma};
  const Geometry geo = make_geometry<Kind, kN>(a.row_bytes);
  const int part = blockIdx.x / a.groups;
  const int q0 = blockIdx.x % a.groups * kN;
  const int tiles = (a.n + kTileRows - 1) / kTileRows;
  const int live = min(kN, a.b - q0);
  // Shared memory: the ring, the carry (kN x k values, then slots) when on
  // chip, then the stages (2 x kN x S values, then slots).
  uint8_t* rest = base + ring.n * stage_bytes<Kind>(kN);
  float* cv;
  int* ci;
  if (a.on_chip) {
    cv = reinterpret_cast<float*>(rest);
    ci = reinterpret_cast<int*>(cv + (size_t)kN * a.k);
    rest += (size_t)kN * a.k * 8;
  } else {
    const size_t list0 = ((size_t)part * a.b + q0) * a.k;
    cv = a.cand_v + list0;
    ci = a.cand_i + list0;
  }
  float* sv = reinterpret_cast<float*>(rest);
  int* si = reinterpret_cast<int*>(sv + (size_t)2 * kN * a.stage);
  for (int e = threadIdx.x; e < live * a.k; e += kThreads) {
    cv[e] = -INFINITY;
    ci[e] = -1;
  }
  for (int i = threadIdx.x; i < kN; i += kThreads) {
    gate[i] = i < live ? -INFINITY : INFINITY;
    staged[i] = 0;
    staged[kN + i] = 0;
  }
  ring_init(ring);
  __syncthreads();
  if (threadIdx.x >= kConsumers) {
    producer_regs();
    if (ring_loader<kTma>()) {
      produce<Kind, kTma, kN>(maps, Loads{a.x, a.q, a.n, a.b}, geo, ring, q0,
                              part, tiles, a.parts);
    }
  } else {
    consumer_regs();
    carry_consume<Kind, kEpi, kN>(geo, ring, a, part, tiles, q0, gate,
                                  staged, cv, ci, sv, si);
  }
}

// -- X1's store --------------------------------------------------------------

// Floats a query row of the score tile: a pitch of 132 puts the 32 scores
// a warp stores at once (8 rows x 4 query columns) in 32 banks.
constexpr int kStorePitch = kTileRows + 4;

// One query's extraction from the stored tile whose row r has slot slot0
// + r (row: the query's 128 stored scores), by a whole warp: lane l reads
// rows 4l..4l+3 at once and appends those above the query's k-th (g) to
// its list (v, ix; n of cap entries), places by a warp scan. Where the
// tile's passing scores would not fit, the rows go 32 at a time in slot
// order instead, and a list that could not take the next 32 is cut to its
// k best first (topk.cuh: warp_select), which raises the k-th; the list's
// entries then all have lower slots than what follows, so a tie with the
// k-th never passes. (Reading 32 rows at a time throughout measured 3-9%
// slower: PERF.md.)
__device__ __forceinline__ void store_extract(const float* row, int slot0,
                                              float& g, int& n, float* v,
                                              int* ix, int k, int cap,
                                              unsigned* hist) {
  const int lane = threadIdx.x & 31;
  const float4 s4 = reinterpret_cast<const float4*>(row)[lane];
  const float s[4] = {s4.x, s4.y, s4.z, s4.w};
  int mine = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e) mine += s[e] > g;
  if (!__any_sync(kFull, mine > 0)) return;
  int incl = mine;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += t;
  }
  const int total = __shfl_sync(kFull, incl, 31);
  if (n + total <= cap) {
    int p = n + incl - mine;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (s[e] > g) {
        v[p] = s[e];
        ix[p] = slot0 + 4 * lane + e;
        ++p;
      }
    }
    n += total;
    return;
  }
  const unsigned lt = lanemask_lt();
#pragma unroll
  for (int c = 0; c < kTileRows / 32; ++c) {
    const float sc = row[32 * c + lane];
    unsigned bal = __ballot_sync(kFull, sc > g);
    if (bal == 0) continue;
    if (n + __popc(bal) > cap) {
      g = fmaxf(g, key_float(warp_select(v, ix, n, k, hist)));
      n = k;
      bal = __ballot_sync(kFull, sc > g);
    }
    if (sc > g) {
      const int p = n + __popc(bal & lt);
      v[p] = sc;
      ix[p] = slot0 + 32 * c + lane;
    }
    n += __popc(bal);
  }
}

// X1 base/maxref's consumer warpgroups. Per tile: the dots; once every
// warp has read the last tile's store, every score goes to the store;
// then each warp extracts the queries it owns (kN / 8: store_extract).
template <class Kind, int kEpi, int kN>
__device__ __forceinline__ void store_consume(
    const Geometry& geo, const Ring& ring, const XArgs& a, int part,
    int tiles, int q0, float* gate, int* len, unsigned* hist, float* store,
    float* lv, int* li) {
  constexpr int kA = kN / 2;
  constexpr int kOwn = kN / (kConsumers / 32);
  using Acc = typename Kind::Acc;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int own0 = warp * kOwn;
  const int own1 = min(own0 + kOwn, a.b - q0);
  const int offset = *a.offset;
  unsigned* my_hist = hist + warp * 256;
  Acc acc[kA];
  int stage = 0, phase = 0;
  for (int t = part; t < tiles; t += a.parts) {
    float aux_r[2], mask_r[2];
    x_rows(a, t * kTileRows + tile_row(0), aux_r, mask_r);
    consume_tile<Kind>(acc, geo, ring, stage, phase);
    consumer_sync();  // the last tile's store has been read
#pragma unroll
    for (int i = 0; i < kA; ++i) {
      store[query_col(i) * kStorePitch + tile_row(i)] =
          x_score<Kind, kEpi>(acc, i, aux_r, mask_r);
    }
    consumer_sync();  // the tile is stored
    for (int ql = own0; ql < own1; ++ql) {
      float g = gate[ql];
      int n = len[ql];
      store_extract(store + ql * kStorePitch, t * kTileRows + offset, g, n,
                    lv + (size_t)ql * a.cap, li + (size_t)ql * a.cap, a.k,
                    a.cap, my_hist);
      if (lane == 0) {
        gate[ql] = g;
        len[ql] = n;
      }
    }
  }
  // The hand-over: each list cut to its k best.
  const int out_cap = a.on_chip ? a.k : a.cap;
  const size_t list0 = ((size_t)part * a.b + q0) * out_cap;
  for (int ql = own0; ql < own1; ++ql) {
    __syncwarp();
    int n = len[ql];
    float* v = lv + (size_t)ql * a.cap;
    int* ix = li + (size_t)ql * a.cap;
    if (n > a.k) {
      warp_select(v, ix, n, a.k, my_hist);
      n = a.k;
    }
    __syncwarp();
    if (a.on_chip) {
      for (int e = lane; e < n; e += 32) {
        a.cand_v[list0 + (size_t)ql * out_cap + e] = v[e];
        a.cand_i[list0 + (size_t)ql * out_cap + e] = ix[e];
      }
    }
    if (lane == 0) a.cand_n[(size_t)part * a.b + q0 + ql] = n;
  }
}

template <class Kind, int kEpi, int kN, bool kTma>
__global__ void __launch_bounds__(kThreads, 1) extract_store(
    const __grid_constant__ Maps maps, const __grid_constant__ XArgs a) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t full[kRing], empty[kRing];
  __shared__ float gate[kN];  // each list's k-th after its last cut
  __shared__ int len[kN];     // list lengths
  __shared__ __align__(16) unsigned hist[kConsumers / 32 * 256];
  uint8_t* base = align1024(smem_raw);
  const Ring ring{base, full, empty, kRing, !kTma};
  const Geometry geo = make_geometry<Kind, kN>(a.row_bytes);
  const int part = blockIdx.x / a.groups;
  const int q0 = blockIdx.x % a.groups * kN;
  const int tiles = (a.n + kTileRows - 1) / kTileRows;
  // Shared memory: the ring, the score tile (kN x kStorePitch), then the
  // lists (kN x cap values, then slots) when on chip.
  float* store =
      reinterpret_cast<float*>(base + ring.n * stage_bytes<Kind>(kN));
  float* lv;
  int* li;
  if (a.on_chip) {
    lv = store + kN * kStorePitch;
    li = reinterpret_cast<int*>(lv + (size_t)kN * a.cap);
  } else {
    const size_t list0 = ((size_t)part * a.b + q0) * a.cap;
    lv = a.cand_v + list0;
    li = a.cand_i + list0;
  }
  for (int i = threadIdx.x; i < kN; i += kThreads) {
    gate[i] = -INFINITY;
    len[i] = 0;
  }
  ring_init(ring);
  __syncthreads();
  if (threadIdx.x >= kConsumers) {
    producer_regs();
    if (ring_loader<kTma>()) {
      produce<Kind, kTma, kN>(maps, Loads{a.x, a.q, a.n, a.b}, geo, ring, q0,
                              part, tiles, a.parts);
    }
  } else {
    consumer_regs();
    store_consume<Kind, kEpi, kN>(geo, ring, a, part, tiles, q0, gate, len,
                                  hist, store, lv, li);
  }
}

// -- X1's gate, X4 and X3: the gated extraction ----------------------------

// X3: gate share `sh` of kShares (kP / kShares query pairs each) of a
// tile's accumulators.
constexpr int kShares = 4;

// A gated experiment's gates in registers (no int gate, no query scale).
template <int kP, int kEpi>
using XGates = Gates<kP, kEpi, false>;

template <class Kind, int kEpi, int kA>
__device__ __forceinline__ unsigned gate_share(
    const typename Kind::Acc (&acc)[kA], const float (&aux_r)[2],
    const float (&mask_r)[2], int slot0, const XGates<kA / 4, kEpi>& gr,
    const GateLists& L, int sh) {
  constexpr int kS = kA / 4 / kShares;
  static_assert(kS * kShares == kA / 4, "shares of whole query pairs");
  switch (sh) {
    case 0:
      return gate_append<Kind, kEpi, false, 1, 0, kS>(
          acc, aux_r, mask_r, slot0, gr, L, ~0u, false);
    case 1:
      return gate_append<Kind, kEpi, false, 1, kS, 2 * kS>(
          acc, aux_r, mask_r, slot0, gr, L, ~0u, false);
    case 2:
      return gate_append<Kind, kEpi, false, 1, 2 * kS, 3 * kS>(
          acc, aux_r, mask_r, slot0, gr, L, ~0u, false);
    default:
      return gate_append<Kind, kEpi, false, 1, 3 * kS, 4 * kS>(
          acc, aux_r, mask_r, slot0, gr, L, ~0u, false);
  }
}

// One tile of X3 in one consumer warpgroup: tile i's scores
// are in cur (rows from row slot0 - offset, aux and mask in cur_aux,
// cur_mask); when tile i + 1 exists, its stages are issued into nxt one at
// a time, and between an issue and the wait for its wgmmas a share of
// tile i's gate runs (the shares spread over the stages); then the vote
// and rounds of tile i.
template <class Kind, int kEpi, int kA>
__device__ __forceinline__ void overlap_tile(
    typename Kind::Acc (&cur)[kA], const float (&cur_aux)[2],
    const float (&cur_mask)[2], typename Kind::Acc (&nxt)[kA],
    float (&nxt_aux)[2], float (&nxt_mask)[2], bool next, int row_next,
    int slot0, const Geometry& geo, const Ring& ring, int& stage,
    int& phase, const XArgs& a, const GateLists& L, unsigned* hist,
    int own0, int own1, XGates<kA / 4, kEpi>& gr) {
  unsigned wait = 0;
  int done = 0;
  if (next) {
    x_rows(a, row_next, nxt_aux, nxt_mask);
    StageA<Kind> st;
    for (int v = 0; v < geo.nv; ++v) {
      issue_stage<Kind>(nxt, st, geo, ring, stage, phase, v);
#ifndef VROD_PROBE_NO_GATE
      for (const int upto = (v + 1) * kShares / geo.nv; done < upto; ++done) {
        wait |= gate_share<Kind, kEpi>(cur, cur_aux, cur_mask, slot0, gr, L,
                                       done);
      }
#endif
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      release_stage(ring, stage);
      next_stage(ring, stage, phase);
    }
  }
#ifdef VROD_PROBE_NO_GATE
  done = kShares;
#endif
  for (; done < kShares; ++done) {
    wait |= gate_share<Kind, kEpi>(cur, cur_aux, cur_mask, slot0, gr, L,
                                   done);
  }
  while (consumer_any(wait != 0)) {
    gate_round(L, hist + (threadIdx.x >> 5) * 256, own0, own1, gr);
    wait = gate_append<Kind, kEpi, false, 1, 0, kA / 4>(
        cur, cur_aux, cur_mask, slot0, gr, L, wait, true);
  }
}

// X3: each consumer warpgroup 64 rows of every tile, in two sets of
// accumulators that alternate by tile, the gate of one tile under the
// wgmmas of the next. (A second form, the two warpgroups on whole tiles in
// turn, CUTLASS's ping-pong, measured slower at int8: one warpgroup's four
// warps, one a scheduler, could not hide their own test's latency under
// the other's wgmmas; PERF.md.)
template <class Kind, int kEpi>
__device__ __forceinline__ void overlap_consume(const Geometry& geo,
                                                const Ring& ring,
                                                const XArgs& a, int part,
                                                int tiles, const GateLists& L,
                                                unsigned* hist, int own0,
                                                int own1) {
  constexpr int kA = kNarrow / 2;
  using Acc = typename Kind::Acc;
  const int offset = *a.offset;
  const int count = part < tiles ? (tiles - part + a.parts - 1) / a.parts : 0;
  if (count == 0) return;
  Acc a0[kA], a1[kA];
  float aux0[2], mask0[2], aux1[2], mask1[2];
  XGates<kA / 4, kEpi> gr;
  load_gates(gr, L);
  int stage = 0, phase = 0;
  int row = part * kTileRows + tile_row(0);
  const int step = a.parts * kTileRows;
  x_rows(a, row, aux0, mask0);
  consume_tile<Kind>(a0, geo, ring, stage, phase);
  for (int i = 0; i < count; i += 2) {
    overlap_tile<Kind, kEpi>(a0, aux0, mask0, a1, aux1, mask1, i + 1 < count,
                             row + step, row + offset, geo, ring, stage,
                             phase, a, L, hist, own0, own1, gr);
    row += step;
    if (i + 1 == count) break;
    overlap_tile<Kind, kEpi>(a1, aux1, mask1, a0, aux0, mask0, i + 2 < count,
                             row + step, row + offset, geo, ring, stage,
                             phase, a, L, hist, own0, own1, gr);
    row += step;
  }
}

// X1's gate and X4 (kOverlap false: gate_consume) and X3 (kOverlap true:
// overlap_consume).
template <class Kind, int kEpi, int kE, bool kOverlap, bool kTma>
__global__ void __launch_bounds__(kThreads, 1) extract_gate(
    const __grid_constant__ Maps maps, const __grid_constant__ XArgs a) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t full[kRing], empty[kRing];
  __shared__ float gate[kNarrow];  // each list's k-th after its last cut
  __shared__ int len[kNarrow];     // list lengths
  __shared__ __align__(16) unsigned hist[kConsumers / 32 * 256];
  uint8_t* base = align1024(smem_raw);
  const Ring ring{base, full, empty, kRing, !kTma};
  const Geometry geo = make_geometry<Kind, kNarrow>(a.row_bytes);
  const int part = blockIdx.x / a.groups;
  const int q0 = blockIdx.x % a.groups * kNarrow;
  const int tiles = (a.n + kTileRows - 1) / kTileRows;
  // Shared memory: the ring, then the lists (kNarrow x cap values, then
  // slots) when on chip.
  GateLists L{nullptr, nullptr, len, gate, nullptr, 0.0f, 0.0f, a.cap, a.k};
#ifdef VROD_PROBE_COUNT
  L.probe = a.cnt;
  if (kOverlap && threadIdx.x == 0) {
    atomicAdd(a.cnt + 3, (tiles - part + a.parts - 1) / a.parts);
  }
#endif
  if (a.on_chip) {
    L.v = reinterpret_cast<float*>(base +
                                   ring.n * stage_bytes<Kind>(kNarrow));
    L.i = reinterpret_cast<int*>(L.v + (size_t)kNarrow * a.cap);
  } else {
    const size_t list0 = ((size_t)part * a.b + q0) * a.cap;
    L.v = a.cand_v + list0;
    L.i = a.cand_i + list0;
  }
  for (int i = threadIdx.x; i < kNarrow; i += kThreads) {
    gate[i] = q0 + i < a.b ? -INFINITY : INFINITY;
    len[i] = 0;
  }
  ring_init(ring);
  __syncthreads();
  if (threadIdx.x >= kConsumers) {
    producer_regs();
    if (ring_loader<kTma>()) {
      produce<Kind, kTma, kNarrow>(maps, Loads{a.x, a.q, a.n, a.b}, geo,
                                   ring, q0, part, tiles, a.parts);
    }
  } else {
    consumer_regs();
    constexpr int kOwn = kNarrow / (kConsumers / 32);
    const int own0 = (threadIdx.x >> 5) * kOwn;
    const int own1 = min(own0 + kOwn, a.b - q0);
    if constexpr (kOverlap) {
      overlap_consume<Kind, kEpi>(geo, ring, a, part, tiles, L, hist, own0,
                                  own1);
    } else {
      XGates<kNarrow / 8, kEpi> gr;
      load_gates(gr, L);
      int stage = 0, phase = 0;
      gate_consume<Kind, kEpi, false, kE, kNarrow>(
          geo, ring, stage, phase, a.aux, FloatMask{a.mask}, a.n, *a.offset,
          part, a.parts, tiles, L, gr, hist, own0, own1);
    }
    gate_handover(L, hist + (threadIdx.x >> 5) * 256, own0, own1,
                  a.on_chip != 0, a.cand_v, a.cand_i, a.cand_n,
                  ((size_t)part * a.b + q0) * a.k, (size_t)part * a.b + q0);
  }
}

// -- X1's floor, on K1's 256-query groups -----------------------------------

// kXFloor's consumer warpgroups: per row tile the dots and a running max
// per query in registers; then the maxima to the second launch.
template <class Kind, int kEpi>
__device__ __forceinline__ void floor_consume(const Geometry& geo,
                                              const Ring& ring,
                                              const XArgs& a, int part,
                                              int tiles, int q0,
                                              unsigned* hist) {
  using Acc = typename Kind::Acc;
  Acc acc[kAcc];
  float rmax[kAcc / 2];  // the running max per query column
#pragma unroll
  for (int c = 0; c < kAcc / 2; ++c) rmax[c] = -INFINITY;
  int stage = 0, phase = 0;
  for (int t = part; t < tiles; t += a.parts) {
    float aux_r[2], mask_r[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gr = t * kTileRows + tile_row(0) + 8 * h;
      aux_r[h] = gr < a.n ? a.aux[gr] : 0.0f;
      mask_r[h] = gr < a.n ? a.mask[gr] : -INFINITY;
    }
    consume_tile<Kind>(acc, geo, ring, stage, phase);
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      const int c = (i >> 2) * 2 + (i & 1);
      rmax[c] = fmaxf(rmax[c], score_epilogue<kEpi>(
                                   dot_value(acc[i]), aux_r[(i >> 1) & 1],
                                   mask_r[(i >> 1) & 1], 0.0f));
    }
  }
  // Lanes 4g + t (g = 0..7) hold the same queries: fold them, then the
  // eight warps (each its own rows) through shared memory.
#pragma unroll
  for (int c = 0; c < kAcc / 2; ++c) {
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) {
      rmax[c] = fmaxf(rmax[c], __shfl_xor_sync(kFull, rmax[c], o));
    }
  }
  float* red = reinterpret_cast<float*>(hist);  // (8 warps, kGroup)
  const int lane = threadIdx.x & 31;
  if (lane < 4) {
#pragma unroll
    for (int c = 0; c < kAcc / 2; ++c) {
      red[(threadIdx.x >> 5) * kGroup + (c >> 1) * 8 + lane * 2 + (c & 1)] =
          rmax[c];
    }
  }
  consumer_sync();
  for (int i = threadIdx.x; i < kGroup && q0 + i < a.b; i += kConsumers) {
    float m = -INFINITY;
    for (int w = 0; w < kConsumers / 32; ++w) {
      m = fmaxf(m, red[w * kGroup + i]);
    }
    a.cand_v[(size_t)part * a.b + q0 + i] = m;
  }
}

template <class Kind, int kEpi, bool kTma>
__global__ void __launch_bounds__(kThreads, 1) extract_local(
    const __grid_constant__ Maps maps, const __grid_constant__ XArgs a) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t full[kRing], empty[kRing];
  __shared__ __align__(16) unsigned hist[kConsumers / 32 * 256];  // maxima
  uint8_t* base = align1024(smem_raw);
  const Ring ring{base, full, empty, kRing, !kTma};
  const Geometry geo = make_geometry<Kind, kGroup>(a.row_bytes);
  const int part = blockIdx.x / a.groups;
  const int q0 = blockIdx.x % a.groups * kGroup;
  const int tiles = (a.n + kTileRows - 1) / kTileRows;
  ring_init(ring);
  __syncthreads();
  if (threadIdx.x >= kConsumers) {
    producer_regs();
    if (ring_loader<kTma>()) {
      produce<Kind, kTma>(maps, Loads{a.x, a.q, a.n, a.b}, geo, ring, q0,
                          part, tiles, a.parts);
    }
  } else {
    consumer_regs();
    floor_consume<Kind, kEpi>(geo, ring, a, part, tiles, q0, hist);
  }
}

// kXFloor's second launch: every rank of a query gets the max over the
// parts' maxima, every id -1.
__global__ void extract_floor_finish(const float* __restrict__ part_max,
                                     int parts, int b, int k,
                                     float* __restrict__ out_v,
                                     int* __restrict__ out_i) {
  const long e = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (long)b * k) return;
  const int qq = (int)(e / k);
  float m = -INFINITY;
  for (int p = 0; p < parts; ++p) m = fmaxf(m, part_max[(size_t)p * b + qq]);
  out_v[e] = m;
  out_i[e] = -1;
}

// The dynamic shared memory of a block of every mode but the floor, past
// the 1024-byte alignment (ops/cuda_extract.py's plans follow it, and the
// card tests hold them to vrod_extract_{store,carry,gate}_smem).
template <int kMode, class Kind>
int narrow_smem(const XArgs& a) {
  int smem = 1024 + kRing * stage_bytes<Kind>(kNarrow);
  if constexpr (kMode == kXStore) {
    smem += kNarrow * kStorePitch * 4;
    if (a.on_chip) smem += kNarrow * a.cap * 8;
  } else if constexpr (kMode == kXCarry) {
    smem += 2 * kNarrow * a.stage * 8;
    if (a.on_chip) smem += kNarrow * a.k * 8;
  } else {
    if (a.on_chip) smem += kNarrow * a.cap * 8;
  }
  return smem;
}

// The kernel of one leg of a mode, TMA or copying build; kV: X4's kE.
template <int kMode, int kV, class Kind, int kEpi, bool kTma>
constexpr auto narrow_kernel() {
  if constexpr (kMode == kXStore) {
    return extract_store<Kind, kEpi, kNarrow, kTma>;
  } else if constexpr (kMode == kXCarry) {
    return extract_carry<Kind, kEpi, kNarrow, kTma>;
  } else {
    return extract_gate<Kind, kEpi, kV, kMode == kXPingPong, kTma>;
  }
}

// A block's whole shared memory in the TMA (kTma) or the copying build
// of a leg of Kind: the kernel's static part (the same in every leg and
// variant) and narrow_smem; -1 if the card cannot say.
template <int kMode, bool kTma, class Kind>
int narrow_need(const XArgs& a) {
  cudaFuncAttributes attr{};
  if (cudaFuncGetAttributes(&attr,
                            narrow_kernel<kMode, 1, Kind, kScale, kTma>()) !=
      cudaSuccess) {
    return -1;
  }
  return (int)attr.sharedSizeBytes + narrow_smem<kMode, Kind>(a);
}

// The C entry point of a mode's shared-memory account: (k, stage, cap,
// on_chip) as the mode reads them; split: the f32x3 legs' (whose stages
// hold both query halves), else every other leg's.
template <int kMode, bool kTma>
int extract_smem(int k, int stage, int cap, int on_chip, int split) {
  XArgs a{};
  a.k = k;
  a.stage = stage;
  a.cap = cap;
  a.on_chip = on_chip;
  return split ? narrow_need<kMode, kTma, F32X3>(a)
               : narrow_need<kMode, kTma, I8>(a);
}

template <int kMode, int kV>
struct LaunchExtract {
  // Every mode but the floor: a need above the card's limit fails
  // ensure_smem.
  template <class Kind, int kEpi, bool kTma>
  static int narrow(const XArgs& a, const Maps& maps, cudaStream_t s) {
    constexpr auto kern = narrow_kernel<kMode, kV, Kind, kEpi, kTma>();
    if (kMode == kXCarry && (a.stage < 1 || a.stage > 32)) {
      return (int)cudaErrorInvalidValue;
    }
    if (kMode != kXCarry && a.cap < a.k + 32) {
      return (int)cudaErrorInvalidValue;
    }
    const int smem = narrow_smem<kMode, Kind>(a);
    const int e = ensure_smem<kern>(smem);
    if (e != 0) return e;
    kern<<<a.groups * a.parts, kThreads, smem, s>>>(maps, a);
    return (int)cudaGetLastError();
  }

  // The copying build encodes no tensor map (topk.cuh: launch_maps): its
  // producer warpgroup copies a.x and a.q by a.granule.
  template <class Kind, int kEpi, bool kTma>
  static int run(const XArgs& a, void* merge_v, void* merge_i, void* out_v,
                 void* out_i, cudaStream_t s) {
    Maps maps;
    int e = launch_maps<Kind, kTma>(&maps, nullptr, a.x, a.q, a.n, a.b,
                                    a.row_bytes,
                                    kMode == kXFloor ? kGroup : kNarrow,
                                    a.granule);
    if (e != 0) return e;
    if constexpr (kMode != kXFloor) {
      e = narrow<Kind, kEpi, kTma>(a, maps, s);
      if (e != 0) return e;
      return launch_merge(a.cand_v, a.cand_i, a.cand_n, a.parts,
                          a.on_chip || kMode == kXCarry ? a.k : a.cap, a.b,
                          a.k, merge_v, merge_i, out_v, out_i, s);
    } else {
      const int smem = 1024 + kRing * kStageBytes;
      auto* kern = extract_local<Kind, kEpi, kTma>;
      e = ensure_smem<extract_local<Kind, kEpi, kTma>>(smem);
      if (e != 0) return e;
      kern<<<a.groups * a.parts, kThreads, smem, s>>>(maps, a);
      cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
      const long total = (long)a.b * a.k;
      extract_floor_finish<<<(unsigned)((total + 255) / 256), 256, 0, s>>>(
          a.cand_v, a.parts, a.b, a.k, static_cast<float*>(out_v),
          static_cast<int*>(out_i));
      return (int)cudaGetLastError();
    }
  }
};

// The legs the experiments take: int8 (int8 query), bfloat16 and float32
// rows, float32 in TF32 at precision_name "fast" and in three TF32
// products (F32X3: the query as (b, 2 * dim), its big then its small TF32
// parts, read through the second query map, or by the copying producer at
// its row's byte offset) at "high" and "exact", each with the experiments'
// cosine (kScale: g * aux), l2 (kL2: 2g - aux) and dot (kDot: g)
// epilogues; kCosineOnly for X4. kTma: the build's producer.
template <class L, bool kCosineOnly, bool kTma, class... A>
int dispatch_x(int elem, int epi, A... a) {
  if (kCosineOnly && epi != kScale) return (int)cudaErrorInvalidValue;
  switch (elem * 4 + epi) {
    case kI8 * 4 + kScale: return L::template run<I8, kScale, kTma>(a...);
    case kBF16 * 4 + kScale: return L::template run<BF16, kScale, kTma>(a...);
    case kF32 * 4 + kScale: return L::template run<TF32, kScale, kTma>(a...);
    case kF32X3 * 4 + kScale:
      return L::template run<F32X3, kScale, kTma>(a...);
    default: break;
  }
  if constexpr (!kCosineOnly) {
    switch (elem * 4 + epi) {
      case kI8 * 4 + kL2: return L::template run<I8, kL2, kTma>(a...);
      case kI8 * 4 + kDot: return L::template run<I8, kDot, kTma>(a...);
      case kBF16 * 4 + kL2: return L::template run<BF16, kL2, kTma>(a...);
      case kBF16 * 4 + kDot: return L::template run<BF16, kDot, kTma>(a...);
      case kF32 * 4 + kL2: return L::template run<TF32, kL2, kTma>(a...);
      case kF32 * 4 + kDot: return L::template run<TF32, kDot, kTma>(a...);
      case kF32X3 * 4 + kL2: return L::template run<F32X3, kL2, kTma>(a...);
      case kF32X3 * 4 + kDot:
        return L::template run<F32X3, kDot, kTma>(a...);
      default: break;
    }
  }
  return (int)cudaErrorInvalidValue;
}

// One build of a mode file's C entry point: XArgs and the merge's scratch
// and outputs; rc is cudaGetLastError() after the launches. kUnroll: X4's
// unrolled builds, variant = kE (2 or 4), cosine only; kTma: the TMA
// build, else the copying one.
template <int kMode, bool kUnroll, bool kTma>
int extract_entry(int elem, int epi, int variant, const XArgs& a,
                  void* merge_v, void* merge_i, void* out_v, void* out_i,
                  void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if constexpr (kUnroll) {
    if (variant == 2) {
      return dispatch_x<LaunchExtract<kMode, 2>, true, kTma>(
          elem, epi, a, merge_v, merge_i, out_v, out_i, s);
    }
    if (variant == 4) {
      return dispatch_x<LaunchExtract<kMode, 4>, true, kTma>(
          elem, epi, a, merge_v, merge_i, out_v, out_i, s);
    }
    return (int)cudaErrorInvalidValue;
  } else {
    return dispatch_x<LaunchExtract<kMode, 1>, false, kTma>(
        elem, epi, a, merge_v, merge_i, out_v, out_i, s);
  }
}

}  // namespace
}  // namespace vrod

// The parameters of every extract_*.cu entry point (ops/cuda_extract.py
// binds them) and the XArgs they make.
#define VROD_EXTRACT_PARAMS                                                  \
  int elem, int epi, int variant, const void *x, const void *aux,            \
      const void *mask, const void *q, const void *offset, int n,            \
      int row_bytes, int b, int k, int groups, int parts, int cap,           \
      int block_rows, int count, int on_chip, int stage, int granule,        \
      void *cand_v, void *cand_i, void *cand_n, void *cnt,                   \
      void *merge_v, void *merge_i, void *out_v, void *out_i, void *stream
#define VROD_EXTRACT_XARGS                                                   \
  vrod::XArgs{static_cast<const int8_t*>(x),                                 \
              static_cast<const int8_t*>(q),                                 \
              static_cast<const float*>(aux),                                \
              static_cast<const float*>(mask),                               \
              static_cast<const int*>(offset),                               \
              n, b, k, row_bytes, groups, parts, cap, block_rows,            \
              count, on_chip, stage, granule,                                \
              static_cast<float*>(cand_v),                                   \
              static_cast<int*>(cand_i), static_cast<int*>(cand_n),          \
              static_cast<int*>(cnt)}
// The entry point `fn` of one build of a mode (mode: an XMode; unroll:
// X4's, variant = kE; tma: the TMA build, else the copying one). Mode file
// extract_<name>.cu defines vrod_extract_<name> (TMA), its twin
// extract_<name>_copy.cu vrod_extract_<name>_copy (the copying build), so
// that nvcc compiles the two builds at once; ops/cuda_extract.py picks the
// entry by the rows' shape.
#define VROD_EXTRACT_ENTRY(fn, mode, unroll, tma)                            \
  extern "C" int fn(VROD_EXTRACT_PARAMS) {                                   \
    return vrod::extract_entry<mode, unroll, tma>(                           \
        elem, epi, variant, VROD_EXTRACT_XARGS, merge_v, merge_i, out_v,     \
        out_i, stream);                                                      \
  }
