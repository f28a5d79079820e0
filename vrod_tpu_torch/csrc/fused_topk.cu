// K1: fused distance scan + exact top-k, every leg of the TPU kernel:
// int8 and packed int4 rows (metrics cosine, dot, l2), bfloat16 and
// float32 rows (cosine, dot, l2). The scoring of each leg is score.cuh's.
//
// Replaces the Pallas kernel vrod_tpu/ops/pallas_topk.py: fused_topk ->
// _fused_call_db -> _kernel_db (and _fused_call -> _kernel, the same math
// on the auto-pipelined grid for dims that are not a multiple of 128).
//
// What bounds it on an H100: at 1M x 768 and B = 256 a search must read
// 805 MB of int8 rows (0.24 ms at 3.35 TB/s; int4 half, bf16 twice, f32
// four times that) and do 2*B*N*D = 412 G operations (0.21 ms at the
// tensor cores' 1,979 int8 TOP/s; 0.42 ms at 989 bf16 TFLOP/s, 0.83 ms at
// 495 TF32 TFLOP/s), so bytes bound it, with the operations close behind.
// The design (score.cuh): each row byte leaves device memory once and
// passes through shared memory once per query group of 256, by TMA into a
// ring that one producer warp keeps full; the dots run as wgmma m64n256
// with the queries streaming beside the rows; and the (B, N) score matrix
// never exists: each score is compared, in the register that holds it,
// with max(theta0, its query's list k-th), and only the few that beat it
// are appended to a list.
//
// The TPU kernel walks the row blocks in order on one core and carries its
// top-k in VMEM. Here a persistent grid has about one block per SM:
//   1. fused_topk_local: block (part p, query group) walks row tiles p,
//      p + parts, ... in ascending order and keeps, per query, an unordered
//      candidate list in global scratch of capacity cap = k + 5 tiles.
//      Every 4 tiles, a list longer than cap - 4 tiles (the most the next
//      four can add) is cut back to exactly k by an exact select, and its
//      k-th value joins the query's gate. Rows come in
//      ascending slot order, so a later score equal to the gate loses its
//      tie anyway.
//   2. fused_topk_merge: one warp per query gathers the part lists, cuts
//      them to k, and ranks the survivors by (value desc, slot asc).
// The select is exact and independent of scheduling: the k-th key is found
// by a radix select over order-isomorphic 32-bit keys, a byte at a time
// (the method of distances.kth_largest_count), and ties at the k-th value
// are broken by the m-th smallest slot, found the same way. The result is the top-k of
// {slots with score > theta0} in (value desc, slot asc) order, with
// (-inf, -1) on empty ranks: the Pallas kernel's contract.

#include <climits>
#include <cmath>

#include "score.cuh"

namespace vrod {
namespace {

// Stages of the TMA ring. 4 measured fastest on the main path's shapes: 3
// was ~1.5% slower and 2 ~11% (PERF.md, PR 3, the ring-depth A/B of
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

// The consumer warps cut every list of the group longer than `limit` (>=
// k) to its k best and raise its query's gate to the new k-th value.
__device__ void cut_lists(float* cand_v, int* cand_i, int* len, float* gate,
                          unsigned* hist, size_t list0, int q0, int b, int k,
                          int cap, int limit) {
  for (int ql = threadIdx.x >> 5; ql < kGroup && q0 + ql < b;
       ql += kConsumers / 32) {
    const int n = len[ql];
    if (n <= limit) continue;  // warp-uniform
    const size_t list = list0 + (size_t)ql * cap;
    const int kth = warp_select(cand_v + list, cand_i + list, n, k,
                                hist + (threadIdx.x >> 5) * 256);
    if ((threadIdx.x & 31) == 0) {
      len[ql] = k;
      gate[ql] = fmaxf(gate[ql], key_float(kth));
    }
  }
}

// The gate of one tile's scores, in the registers that hold their dots:
// per query pair of this thread (columns ql = 8j + 2t and ql + 1) and its
// two rows, four scores against the pair's gates and one branch for the
// four; only scores above their gate are appended to their query's list.
// Nothing here writes a gate, so the __restrict__ views let their loads
// run ahead of the appends.
template <class Kind, int kEpi>
__device__ __forceinline__ void gate_tile(
    const typename Kind::Acc (&acc)[kAcc], const float (&aux_r)[2],
    const float (&mask_r)[2], int row0, int offset, float* v_list0,
    int* i_list0, int cap, const float* __restrict__ gate,
    const float* __restrict__ qsv, int* len) {
#pragma unroll
  for (int j = 0; j < kAcc / 4; ++j) {
    const int ql = query_col(4 * j);
    const float2 g2 = *reinterpret_cast<const float2*>(gate + ql);
    const float2 q2 = kEpi == kScaleQs
                          ? *reinterpret_cast<const float2*>(qsv + ql)
                          : make_float2(0.0f, 0.0f);
    float s[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[e] = score_epilogue<kEpi>(dot_value(acc[4 * j + e]), aux_r[e >> 1],
                                  mask_r[e >> 1], e & 1 ? q2.y : q2.x);
    }
    const bool p0 = s[0] > g2.x, p1 = s[1] > g2.y;
    const bool p2 = s[2] > g2.x, p3 = s[3] > g2.y;
    if (p0 | p1 | p2 | p3) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (e == 0 ? p0 : e == 1 ? p1 : e == 2 ? p2 : p3) {
          const int qe = ql + (e & 1);
          const size_t at = (size_t)qe * cap + atomicAdd(len + qe, 1);
          v_list0[at] = s[e];
          i_list0[at] = row0 + 8 * (e >> 1) + offset;
        }
      }
    }
  }
}

// The consumer warpgroups of K1: per row tile, the dots and the gate;
// every cut_every tiles (and at the end) the list cuts, the only points
// where the two warpgroups wait for each other. A list holds cap = k +
// (cut_every + 1) tiles of candidates (ops/cuda_topk.py: topk_plan): at a
// cut, lists longer than cap - cut_every tiles are cut back to k, so the
// next cut_every tiles (at most 128 candidates each) always fit.
template <class Kind, int kEpi>
__device__ __forceinline__ void consume_all(
    const Geometry& geo, const Ring& ring, const float* __restrict__ aux,
    const float* __restrict__ mask, int n, int b, int k, int offset,
    int part, int parts, int tiles, int q0, int cap, float* gate,
    const float* qsv, int* len, unsigned* hist, float* __restrict__ cand_v,
    int* __restrict__ cand_i, int* __restrict__ cand_n) {
  using Acc = typename Kind::Acc;
  const size_t list0 = ((size_t)part * b + q0) * cap;
  Acc acc[kAcc];
  const int cut_every = (cap - k) / kTileRows - 1;
  int stage = 0, phase = 0, since_cut = 0;
  for (int t = part; t < tiles; t += parts) {
    // The rows' aux and mask, loaded before the dots so they have arrived
    // by the gate.
    const int row0 = t * kTileRows + tile_row(0);
    float aux_r[2], mask_r[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gr = row0 + 8 * h;
      aux_r[h] = gr < n ? aux[gr] : 0.0f;
      mask_r[h] = gr < n ? mask[gr] : -INFINITY;
    }
    consume_tile<Kind>(acc, geo, ring, stage, phase);
    // tools/kernel_probe.py builds K1 without the gate to see where the time
    // goes; such a build returns wrong results by design.
#ifndef VROD_PROBE_NO_GATE
    gate_tile<Kind, kEpi>(acc, aux_r, mask_r, row0, offset, cand_v + list0,
                          cand_i + list0, cap, gate, qsv, len);
#endif
    if (++since_cut == cut_every) {
      since_cut = 0;
      consumer_sync();  // the tiles' candidates and lengths are in
      cut_lists(cand_v, cand_i, len, gate, hist, list0, q0, b, k, cap,
                cap - cut_every * kTileRows);
      consumer_sync();  // gates and lengths are read again
    }
  }
  consumer_sync();
  cut_lists(cand_v, cand_i, len, gate, hist, list0, q0, b, k, cap, k);
  consumer_sync();
  for (int i = threadIdx.x; i < kGroup && q0 + i < b; i += kConsumers) {
    cand_n[(size_t)part * b + q0 + i] = len[i];
  }
}

template <class Kind, int kEpi, bool kTma>
__global__ void __launch_bounds__(kThreads, 1) fused_topk_local(
    const __grid_constant__ Maps maps, const int8_t* __restrict__ x,
    const int8_t* __restrict__ q, const float* __restrict__ aux,
    const float* __restrict__ mask, const float* __restrict__ qs2,
    int row_bytes, const float* __restrict__ theta0, int n, int b, int k,
    int offset, int groups, int parts, int cap,
    float* __restrict__ cand_v, int* __restrict__ cand_i,
    int* __restrict__ cand_n) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t full[kRing], empty[kRing];
  // max(theta0, the list's k-th), and the group's qs2 (kScaleQs); read
  // as float2 pairs.
  __shared__ __align__(16) float gate[kGroup];
  __shared__ __align__(16) float qsv[kGroup];
  __shared__ int len[kGroup];
  __shared__ unsigned hist[kConsumers / 32 * 256];  // a select's, per warp
  const Ring ring{align1024(smem_raw), full, empty, kRing};
  const Geometry geo = make_geometry<Kind>(row_bytes);
  const int part = blockIdx.x / groups;
  const int q0 = blockIdx.x % groups * kGroup;
  const int tiles = (n + kTileRows - 1) / kTileRows;
  ring_init(ring);
  for (int i = threadIdx.x; i < kGroup; i += kThreads) {
    const int qq = q0 + i;
    gate[i] = qq < b ? theta0[qq] : INFINITY;
    qsv[i] = kEpi == kScaleQs && qq < b ? qs2[qq] : 0.0f;
    len[i] = 0;
  }
  __syncthreads();
  if (threadIdx.x >= kConsumers) {
    producer_regs();
    if (threadIdx.x < kConsumers + 32) {
      produce<Kind, kTma>(maps, Loads{x, q, n, b}, geo, ring, q0, part,
                          tiles, parts);
    }
  } else {
    consumer_regs();
    consume_all<Kind, kEpi>(geo, ring, aux, mask, n, b, k, offset, part,
                            parts, tiles, q0, cap, gate, qsv, len, hist,
                            cand_v, cand_i, cand_n);
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
  __syncwarp();
  if (n > k) {
    warp_select(gv, gi, n, k, hist + (threadIdx.x >> 5) * 256);
    n = k;
  }
  __syncwarp();
  float* ov = out_v + (size_t)qq * k;
  int* oi = out_i + (size_t)qq * k;
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

}  // namespace
}  // namespace vrod

using namespace vrod;

struct LaunchTopk {
  template <class Kind, int kEpi, bool kTma>
  static int run(const void* x, const void* aux, const void* mask,
                 const void* q, const void* qs2, int row_bytes,
                 const void* theta0, int n, int b, int k, int offset,
                 int groups, int parts, int cap, void* cand_v, void* cand_i,
                 void* cand_n, void* merge_v, void* merge_i, void* out_v,
                 void* out_i, cudaStream_t s) {
    Maps maps{};
    if constexpr (kTma) {
      const int e = make_maps(&maps, Kind::kPacked, x, q, n, b, row_bytes);
      if (e != 0) return e;
    }
    const int smem = 1024 + kRing * kStageBytes;
    auto* kern = fused_topk_local<Kind, kEpi, kTma>;
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    kern<<<groups * parts, kThreads, smem, s>>>(
        maps, static_cast<const int8_t*>(x), static_cast<const int8_t*>(q),
        static_cast<const float*>(aux), static_cast<const float*>(mask),
        static_cast<const float*>(qs2), row_bytes,
        static_cast<const float*>(theta0), n, b, k, offset, groups, parts,
        cap, static_cast<float*>(cand_v), static_cast<int*>(cand_i),
        static_cast<int*>(cand_n));
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    fused_topk_merge<<<(b + kMergeWarps - 1) / kMergeWarps, kMergeThreads, 0,
                       s>>>(
        static_cast<const float*>(cand_v), static_cast<const int*>(cand_i),
        static_cast<const int*>(cand_n), parts, cap, b, k,
        static_cast<float*>(merge_v), static_cast<int*>(merge_i),
        static_cast<float*>(out_v), static_cast<int*>(out_i));
    return (int)cudaGetLastError();
  }
};

// elem/epi: score.cuh's Elem and Epi codes; tma: rows and queries load by
// TMA (row bytes a multiple of 16, 16-byte aligned bases), else the
// producer warp copies them. row_bytes: bytes per stored row (int4: dim /
// 2). qs2 (b,) is read by kScaleQs only. groups, parts, cap: the plan
// (ops/cuda_topk.py: topk_plan).
extern "C" int vrod_fused_topk(
    int elem, int epi, int tma, const void* x, const void* aux,
    const void* mask, const void* q, const void* qs2, const void* theta0,
    int n, int row_bytes, int b, int k, int offset, int groups, int parts,
    int cap, void* cand_v, void* cand_i, void* cand_n,
    void* merge_v, void* merge_i, void* out_v, void* out_i, void* stream) {
  return dispatch_leg<LaunchTopk>(
      elem, epi, tma != 0, x, aux, mask, q, qs2, row_bytes, theta0, n, b, k,
      offset, groups, parts, cap, cand_v, cand_i, cand_n, merge_v,
      merge_i, out_v, out_i, static_cast<cudaStream_t>(stream));
}
