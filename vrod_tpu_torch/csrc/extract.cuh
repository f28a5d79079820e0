// The extraction experiments of the JAX package, X1-X4, as modes of K1's
// machinery (score.cuh's producer, ring and wgmma m64n256 consumers;
// topk.cuh's radix select, list cuts and merge). Each mode is built in a
// .cu file of its own (extract_*.cu), one C entry point per file.
//
// Replaces the Pallas kernels experiments/kexp.py: make_call -> build_kernel
// (X1), kexp2.py: make_call (X2), kexp3.py: make_call (X3) and kexp5.py:
// make_call -> build_kernel (X4). Each scores whole blocks of block_rows
// rows (rows after the last whole block are never read) with the
// experiments' epilogue, score = epi(g) + mask with epi cosine g * aux, l2
// 2g - aux, dot g, for int8 rows (int8 query, exact int32 dots), bfloat16
// and float32 rows (TF32), and returns the exact top-k by (value desc, slot
// asc), slots col + offset[0], (-inf, -1) on empty ranks. All four ask what
// the extraction of the top-k from a scored block costs; on the H100 that
// cost is K1's gate. What each mode does about it:
//   kXFloor     X1 floor: the dots, the epilogue and a running max per
//               query in registers; no lists, no cuts. Every rank holds the
//               query's max, ids -1 (kexp.py's floor). The scan's floor.
//   kXStore     X1 base/maxref ("store the block, then extract"): no
//               register gate; every finite score of a tile is appended to
//               its query's list and the lists are cut to k after each tile.
//   kXGate      X1 gate/nostore/argmax/subdot and X4 (kE = 1, 2, 4): K1's
//               own consume_all and gate_tile (topk.cuh) from theta0 =
//               -inf, with one divergent branch per kE query pairs (4 kE
//               scores; the appends inside are predicated per score). kE =
//               1 is K1's own form.
//   kXPingPong  X3: K1's consume_all with the PingPong dots: the two
//               consumer warpgroups staggered by half a tile through
//               ordered named barriers, so one warpgroup's gate runs under
//               the other's wgmmas.
//   kXCarry     X2: a sorted running top-k of exactly k (value, slot) per
//               query, in shared memory when it fits beside the ring (else
//               in global memory, where L2 holds it), each passing score
//               inserted in place by a whole warp under a per-query lock;
//               no candidate lists and no cuts. With `count`, one part
//               per query group walks the rows in global order and
//               counts, after each block, the carry entries that block
//               put there (kexp2's while-iterations follow from those
//               counts).
// What bounds every mode: K1's bound, the rows once (805 MB at the int8
// main path, 0.24 ms at 3.35 TB/s) with the dots close behind.

#pragma once

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

// One launch's arguments (ops/cuda_extract.py: _launch).
struct XArgs {
  const int8_t* x;      // (n, row_bytes): the whole blocks only
  const int8_t* q;      // (b, row_bytes), as the kernel reads it
  const float* aux;     // (n,)
  const float* mask;    // (n,) additive
  const int* offset;    // (1,) added to every slot
  int n, b, k, row_bytes, groups, parts, cap, block_rows;
  int ring;             // kXCarry: stages of the ring (<= kRing)
  int count;            // kXCarry: count the carry entries per block
  int carry_smem;       // kXCarry: the carry lives in shared memory
  float* cand_v;        // lists (parts, b, cap); kXFloor: maxima (parts, b)
  int* cand_i;
  int* cand_n;          // (parts, b)
  int* cnt;             // kXCarry with count: (n / block_rows, b)
};

// The ping-pong's ordered barriers (ids 0 and 1 are __syncthreads and
// consumer_sync): kBarA completes when warpgroup 0 has taken the first
// half of a tile's stages, kBarB when warpgroup 1 has.
constexpr int kBarA = 2;
constexpr int kBarB = 3;

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "n"(kConsumers) : "memory");
}

__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "n"(kConsumers)
               : "memory");
}

// X3's dots of a tile (consume_all's Dots): warpgroup 1 starts a tile once
// warpgroup 0 has taken its first `half` stages; warpgroup 0 starts the
// next once warpgroup 1 has taken half of this one. Between those points
// each gates while the other's wgmmas run. half is at most the ring, so a
// warpgroup never waits for stages the other has yet to release.
struct PingPong {
  int half;
  template <class Kind>
  __device__ __forceinline__ void tile(typename Kind::Acc (&acc)[kAcc],
                                       const Geometry& geo, const Ring& ring,
                                       int& stage, int& phase,
                                       bool first) const {
    const int wg = threadIdx.x / 128;
    if (wg == 1) {
      named_sync(kBarA);
    } else if (!first) {
      named_sync(kBarB);
    }
    consume_stages<Kind>(acc, geo, ring, stage, phase, 0, half);
    named_arrive(wg == 0 ? kBarA : kBarB);
    consume_stages<Kind>(acc, geo, ring, stage, phase, half, geo.nv);
  }
  // Warpgroup 0 meets warpgroup 1's arrival in the part's last tile.
  __device__ __forceinline__ void done(bool any) const {
    if (threadIdx.x / 128 == 0 && any) named_sync(kBarB);
  }
};

// X2: the whole warp inserts (s, id) into one query's sorted carry (v,
// ix)[0, k) if it comes before the carry's k-th by (value desc, slot asc),
// under the query's lock (lane 0 takes it); lane l moves elements l, l +
// 32, ..., so an insert costs a few warp-wide passes, not k steps of one
// thread. The carry's new k-th value goes to *gate. A call, not inlined:
// carry_tile's 64 unrolled query pairs would otherwise copy it 64 times.
__device__ __noinline__ void carry_insert(float* cv, int* ci, int k,
                                             int* lock, float* gate, float s,
                                             int id) {
  const int lane = threadIdx.x & 31;
  if (lane == 0) {
    while (atomicCAS(lock, 0, 1) != 0) {
    }
  }
  __syncwarp();
  __threadfence_block();
  volatile float* v = cv;
  volatile int* ix = ci;
  // The entries that come before (s, id) are a prefix: its length is the
  // insert position.
  int pos = 0;
  for (int base = 0; base < k; base += 32) {
    const int e = base + lane;
    bool before = false;
    if (e < k) {
      const float ve = v[e];
      before = ve > s || (ve == s && ix[e] < id);
    }
    pos += __popc(__ballot_sync(kFull, before));
  }
  if (pos < k) {
    // Shift [pos, k - 1) up by one: each chunk reads its old entries, takes
    // each one's predecessor by shuffle (lane 0: the previous chunk's last),
    // then writes.
    float last_v = 0.0f;
    int last_i = 0;
    for (int base = 0; base < k; base += 32) {
      const int e = base + lane;
      const float ve = e < k ? v[e] : 0.0f;
      const int ie = e < k ? ix[e] : 0;
      float pv = __shfl_up_sync(kFull, ve, 1);
      int pi = __shfl_up_sync(kFull, ie, 1);
      if (lane == 0) {
        pv = last_v;
        pi = last_i;
      }
      last_v = __shfl_sync(kFull, ve, 31);
      last_i = __shfl_sync(kFull, ie, 31);
      __syncwarp();
      if (e < k && e >= pos) {
        v[e] = e == pos ? s : pv;
        ix[e] = e == pos ? id : pi;
        if (e == k - 1) *reinterpret_cast<volatile float*>(gate) = v[e];
      }
    }
  }
  __threadfence_block();
  __syncwarp();
  if (lane == 0) atomicExch(lock, 0);
}

// X2's pass over one tile's scores: a score at or above its query's
// carried k-th value (a stale read is sound: the k-th only rises) joins
// the warp's queue (value, slot, query: 128 entries, four per lane), and
// the warp then inserts the queue's entries one by one, each under its
// query's lock. Every warp fills its queue in the same query order, so
// each drains it from its own start: warps 0-3 at the entries of queries
// 0, 2, 4, 6 of the pair group, warps 4-7 at 1, 3, 5, 7, and the eight
// seldom wait on one lock.
template <class Kind, int kEpi>
__device__ __forceinline__ void carry_tile(
    const typename Kind::Acc (&acc)[kAcc], const float (&aux_r)[2],
    const float (&mask_r)[2], int row0, int offset, float* cv, int* ci,
    int k, float* gate, int* lock, float* queue_v, int* queue_i,
    int* queue_q) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < kAcc / 4; ++j) {
    const int ql = query_col(4 * j);
    const float2 g2 = *reinterpret_cast<const float2*>(gate + ql);
    float s[4];
    bool p[4];
    int mine = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[e] = score_epilogue<kEpi>(dot_value(acc[4 * j + e]), aux_r[e >> 1],
                                  mask_r[e >> 1], 0.0f);
      p[e] = s[e] > -INFINITY && s[e] >= (e & 1 ? g2.y : g2.x);
      mine += p[e];
    }
    if (__any_sync(kFull, mine > 0)) {
      int incl = mine;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += t;
      }
      int at = incl - mine;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (p[e]) {
          queue_v[at] = s[e];
          queue_i[at] = row0 + 8 * (e >> 1) + offset;
          queue_q[at] = ql + (e & 1);
          ++at;
        }
      }
      const int total = __shfl_sync(kFull, incl, 31);
      const int warp = (threadIdx.x >> 5) & 7;
      const int start = (4 * (warp & 3) + (warp >> 2)) % total;
      __syncwarp();
#pragma unroll 1
      for (int c0 = 0; c0 < total; ++c0) {
        const int c = c0 + start < total ? c0 + start : c0 + start - total;
        const int q = queue_q[c];
        carry_insert(cv + (size_t)q * k, ci + (size_t)q * k, k, lock + q,
                     gate + q, queue_v[c], queue_i[c]);
      }
      __syncwarp();  // the queue is read before it is written again
    }
  }
}

// The consumer warpgroups of the modes that are not K1's consume_all
// (kXFloor, kXStore, kXCarry): per row tile the dots, then the mode's
// extraction; then the mode's hand-over (lists and lengths, or maxima) to
// the second launch.
template <class Kind, int kEpi, int kMode>
__device__ __forceinline__ void extract_consume(
    const Geometry& geo, const Ring& ring, const XArgs& a, int part,
    int tiles, int q0, float* gate, float* cut_gate, int* len,
    unsigned* hist, float* cv, int* ci, float* queue_v, int* queue_i,
    int* queue_q) {
  using Acc = typename Kind::Acc;
  const size_t list0 = ((size_t)part * a.b + q0) * a.cap;
  const int offset = *a.offset;
  Acc acc[kAcc];
  float rmax[kAcc / 2];  // kXFloor: the running max per query column
#pragma unroll
  for (int c = 0; c < kAcc / 2; ++c) rmax[c] = -INFINITY;
  const IntGate no_ig{nullptr, 0.0f, 0.0f};
  int stage = 0, phase = 0;
  for (int t = part; t < tiles; t += a.parts) {
    const int row0 = t * kTileRows + tile_row(0);
    float aux_r[2], mask_r[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gr = row0 + 8 * h;
      aux_r[h] = gr < a.n ? a.aux[gr] : 0.0f;
      mask_r[h] = gr < a.n ? a.mask[gr] : -INFINITY;
    }
    consume_tile<Kind>(acc, geo, ring, stage, phase);
    if constexpr (kMode == kXFloor) {
#pragma unroll
      for (int i = 0; i < kAcc; ++i) {
        const int c = (i >> 2) * 2 + (i & 1);
        rmax[c] = fmaxf(rmax[c], score_epilogue<kEpi>(
                                     dot_value(acc[i]), aux_r[(i >> 1) & 1],
                                     mask_r[(i >> 1) & 1], 0.0f));
      }
    } else if constexpr (kMode == kXCarry) {
      const int q0w = (threadIdx.x >> 5) * 128;  // this warp's queue
      carry_tile<Kind, kEpi>(acc, aux_r, mask_r, row0, offset, cv, ci, a.k,
                             gate, len, queue_v + q0w, queue_i + q0w,
                             queue_q + q0w);
      if (a.count && ((t + 1) * kTileRows) % a.block_rows == 0) {
        // One part walks every tile in order: the carry now holds the
        // exact top-k of the rows up to this block's end.
        consumer_sync();
        const int j = (t + 1) * kTileRows / a.block_rows - 1;
        const long lo = (long)j * a.block_rows + offset;
        for (int i = threadIdx.x; i < kGroup && q0 + i < a.b;
             i += kConsumers) {
          int c = 0;
          for (int e = 0; e < a.k; ++e) {
            const long id = ci[(size_t)i * a.k + e];
            c += cv[(size_t)i * a.k + e] > -INFINITY && id >= lo &&
                 id < lo + a.block_rows;
          }
          a.cnt[(size_t)j * a.b + q0 + i] = c;
        }
        consumer_sync();
      }
    } else {
      // kXStore: K1's gate_tile against a gate of -inf that is never
      // raised (the cuts raise cut_gate), so every finite score is
      // appended; then every list is cut back to k.
      gate_tile<Kind, kEpi, false>(acc, aux_r, mask_r, row0, offset,
                                   a.cand_v + list0, a.cand_i + list0, a.cap,
                                   gate, nullptr, nullptr, len);
      consumer_sync();
      cut_lists<false>(a.cand_v, a.cand_i, len, cut_gate, no_ig, hist, list0,
                       q0, a.b, a.k, a.cap, a.k);
      consumer_sync();
    }
  }
  if constexpr (kMode == kXFloor) {
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
  } else if constexpr (kMode == kXCarry) {
    consumer_sync();
    for (int i = threadIdx.x; i < kGroup && q0 + i < a.b; i += kConsumers) {
      int n = 0;
      for (int e = 0; e < a.k; ++e) {
        const float v = cv[(size_t)i * a.k + e];
        const int id = ci[(size_t)i * a.k + e];
        n += v > -INFINITY;
        if (a.carry_smem) {
          a.cand_v[list0 + (size_t)i * a.k + e] = v;
          a.cand_i[list0 + (size_t)i * a.k + e] = id;
        }
      }
      a.cand_n[(size_t)part * a.b + q0 + i] = n;
    }
  } else {
    // Every tile ended with a cut and a consumer_sync.
    for (int i = threadIdx.x; i < kGroup && q0 + i < a.b; i += kConsumers) {
      a.cand_n[(size_t)part * a.b + q0 + i] = len[i];
    }
  }
}

template <class Kind, int kEpi, int kMode, int kE>
__global__ void __launch_bounds__(kThreads, 1) extract_local(
    const __grid_constant__ Maps maps, const __grid_constant__ XArgs a) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t full[kRing], empty[kRing];
  // The gate (K1's: max of -inf and the list's k-th; kXStore: -inf, never
  // raised; kXCarry: the carry's k-th), read as float2 pairs, +inf past the
  // batch.
  __shared__ __align__(16) float gate[kGroup];
  // kXStore's cuts raise this one instead.
  __shared__ float cut_gate[kMode == kXStore ? kGroup : 1];
  __shared__ int len[kGroup];  // list lengths; kXCarry: the locks
  // A select's counters per warp; kXFloor: the warps' maxima.
  __shared__ __align__(16) unsigned hist[kMode == kXCarry ? 1
                                         : kConsumers / 32 * 256];
  // kXCarry: each consumer warp's queue of passing scores (value, slot,
  // query), 128 entries.
  constexpr int kQueue = kMode == kXCarry ? kConsumers / 32 * 128 : 1;
  __shared__ float queue_v[kQueue];
  __shared__ int queue_i[kQueue], queue_q[kQueue];
  uint8_t* base = align1024(smem_raw);
  const Ring ring{base, full, empty, kMode == kXCarry ? a.ring : kRing};
  const Geometry geo = make_geometry<Kind>(a.row_bytes);
  const int part = blockIdx.x / a.groups;
  const int q0 = blockIdx.x % a.groups * kGroup;
  const int tiles = (a.n + kTileRows - 1) / kTileRows;
  ring_init(ring);
  float* cv = nullptr;
  int* ci = nullptr;
  if constexpr (kMode == kXCarry) {
    const size_t list0 = ((size_t)part * a.b + q0) * a.cap;
    if (a.carry_smem) {
      cv = reinterpret_cast<float*>(base + ring.n * kStageBytes);
      ci = reinterpret_cast<int*>(cv + (size_t)kGroup * a.k);
    } else {
      cv = a.cand_v + list0;
      ci = a.cand_i + list0;
    }
    // Past the batch the carry is not read (gate +inf); in global memory
    // it has no room there.
    const int live = min(kGroup, a.b - q0) * a.k;
    for (int e = threadIdx.x; e < live; e += kThreads) {
      cv[e] = -INFINITY;
      ci[e] = -1;
    }
  }
  for (int i = threadIdx.x; i < kGroup; i += kThreads) {
    gate[i] = q0 + i < a.b ? -INFINITY : INFINITY;
    if constexpr (kMode == kXStore) cut_gate[i] = gate[i];
    len[i] = 0;
  }
  __syncthreads();
  if (threadIdx.x >= kConsumers) {
    producer_regs();
    if (threadIdx.x < kConsumers + 32) {
      produce<Kind, true>(maps, Loads{a.x, a.q, a.n, a.b}, geo, ring, q0,
                          part, tiles, a.parts);
    }
  } else {
    consumer_regs();
    if constexpr (kMode == kXGate || kMode == kXPingPong) {
      int stage = 0, phase = 0;
      const IntGate no_ig{nullptr, 0.0f, 0.0f};
      const int offset = *a.offset;
      const auto run = [&](const auto& dots) {
        consume_all<Kind, kEpi, false, kE>(
            geo, ring, stage, phase, a.aux, a.mask, a.n, a.b, a.k, offset,
            part, a.parts, tiles, q0, a.cap, gate, no_ig, nullptr, len, hist,
            a.cand_v, a.cand_i, a.cand_n, NoSkip{}, dots);
      };
      if constexpr (kMode == kXGate) {
        run(WholeTile{});
      } else {
        run(PingPong{max(1, min(geo.nv / 2, ring.n))});
      }
    } else {
      extract_consume<Kind, kEpi, kMode>(geo, ring, a, part, tiles, q0, gate,
                                         cut_gate, len, hist, cv, ci, queue_v,
                                         queue_i, queue_q);
    }
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

template <int kMode, int kE>
struct LaunchExtract {
  template <class Kind, int kEpi>
  static int run(const XArgs& a, void* merge_v, void* merge_i, void* out_v,
                 void* out_i, cudaStream_t s) {
    Maps maps{};
    int e = make_maps(&maps, false, a.x, a.q, a.n, a.b, a.row_bytes);
    if (e != 0) return e;
    const int ring_n = kMode == kXCarry ? a.ring : kRing;
    if (ring_n < 2 || ring_n > kRing) return (int)cudaErrorInvalidValue;
    int smem = 1024 + ring_n * kStageBytes;
    if (kMode == kXCarry && a.carry_smem) smem += kGroup * a.k * 8;
    auto* kern = extract_local<Kind, kEpi, kMode, kE>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    kern<<<a.groups * a.parts, kThreads, smem, s>>>(maps, a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    if constexpr (kMode == kXFloor) {
      const long total = (long)a.b * a.k;
      extract_floor_finish<<<(unsigned)((total + 255) / 256), 256, 0, s>>>(
          a.cand_v, a.parts, a.b, a.k, static_cast<float*>(out_v),
          static_cast<int*>(out_i));
      return (int)cudaGetLastError();
    } else {
      return launch_merge(a.cand_v, a.cand_i, a.cand_n, a.parts, a.cap, a.b,
                          a.k, merge_v, merge_i, out_v, out_i, s);
    }
  }
};

// The legs the experiments take: int8 (int8 query), bfloat16 and float32
// (TF32) rows, each with the experiments' cosine (kScale: g * aux), l2
// (kL2: 2g - aux) and dot (kDot: g) epilogues; kCosineOnly for X4.
template <class L, bool kCosineOnly, class... A>
int dispatch_x(int elem, int epi, A... a) {
  if (kCosineOnly && epi != kScale) return (int)cudaErrorInvalidValue;
  switch (elem * 4 + epi) {
    case kI8 * 4 + kScale: return L::template run<I8, kScale>(a...);
    case kBF16 * 4 + kScale: return L::template run<BF16, kScale>(a...);
    case kF32 * 4 + kScale: return L::template run<TF32, kScale>(a...);
    default: break;
  }
  if constexpr (!kCosineOnly) {
    switch (elem * 4 + epi) {
      case kI8 * 4 + kL2: return L::template run<I8, kL2>(a...);
      case kI8 * 4 + kDot: return L::template run<I8, kDot>(a...);
      case kBF16 * 4 + kL2: return L::template run<BF16, kL2>(a...);
      case kBF16 * 4 + kDot: return L::template run<BF16, kDot>(a...);
      case kF32 * 4 + kL2: return L::template run<TF32, kL2>(a...);
      case kF32 * 4 + kDot: return L::template run<TF32, kDot>(a...);
      default: break;
    }
  }
  return (int)cudaErrorInvalidValue;
}

// The C entry point of one mode file: XArgs and the merge's scratch and
// outputs; rc is cudaGetLastError() after the launches.
template <int kMode, int kE, bool kCosineOnly>
int run_extract(int elem, int epi, const XArgs& a, void* merge_v,
                void* merge_i, void* out_v, void* out_i, void* stream) {
  return dispatch_x<LaunchExtract<kMode, kE>, kCosineOnly>(
      elem, epi, a, merge_v, merge_i, out_v, out_i,
      static_cast<cudaStream_t>(stream));
}

}  // namespace
}  // namespace vrod

// The parameters of every extract_*.cu entry point (ops/cuda_extract.py
// binds them), and the XArgs they make.
#define VROD_EXTRACT_PARAMS                                                  \
  int elem, int epi, int variant, const void *x, const void *aux,            \
      const void *mask, const void *q, const void *offset, int n,            \
      int row_bytes, int b, int k, int groups, int parts, int cap,           \
      int block_rows, int ring, int count, int carry_smem, void *cand_v,     \
      void *cand_i, void *cand_n, void *cnt, void *merge_v, void *merge_i,   \
      void *out_v, void *out_i, void *stream
#define VROD_EXTRACT_XARGS                                                   \
  vrod::XArgs{static_cast<const int8_t*>(x),                           \
                    static_cast<const int8_t*>(q),                           \
                    static_cast<const float*>(aux),                          \
                    static_cast<const float*>(mask),                         \
                    static_cast<const int*>(offset),                         \
                    n, b, k, row_bytes, groups, parts, cap, block_rows,      \
                    ring, count, carry_smem, static_cast<float*>(cand_v),    \
                    static_cast<int*>(cand_i), static_cast<int*>(cand_n),    \
                    static_cast<int*>(cnt)}
