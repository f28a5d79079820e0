// K1: fused distance scan + exact top-k, every leg of the TPU kernel:
// int8 and packed int4 rows (metrics cosine, dot, l2), bfloat16 and
// float32 rows (cosine, dot, l2); float32 in TF32 at the precision "fast"
// and in three TF32 products (score.cuh's F32X3) at "high" and "exact",
// the TPU kernel's HIGHEST. The scoring of each leg is score.cuh's.
//
// Replaces the Pallas kernel vrod_tpu/ops/pallas_topk.py: fused_topk ->
// _fused_call_db -> _kernel_db (and _fused_call -> _kernel, the same math
// on the auto-pipelined grid for dims that are not a multiple of 128).
//
// What bounds it on an H100: at 1M x 768 and B = 256 a search must read
// 805 MB of int8 rows (0.24 ms at 3.35 TB/s; int4 half, bf16 twice, f32
// four times that) and do 2*B*N*D = 412 G operations (0.21 ms at the
// tensor cores' 1,979 int8 TOP/s; 0.42 ms at 989 bf16 TFLOP/s, 0.83 ms at
// 495 TF32 TFLOP/s), so bytes bound it, with the operations close behind
// (float32 at "high"/"exact" does three TF32 products, 2.5 ms: operations
// bound it).
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
// (-inf, -1) on empty ranks: the Pallas kernel's contract. The select, the
// cuts, the gate and the merge live in topk.cuh, which the one-launch
// sampled floor (fused_theta.cu) shares.
//
// X9, the int32 gate bound (vrod_fused_intgate): the same kernel with
// kIntGate, for int8 rows under cosine or dot. It replaces the Pallas
// kernel experiments/kexp22.py: fused_intgate -> _kernel_db_intgate, which
// bounds each query's best score in a 2048-row block from the int32
// accumulator before the float epilogue and skips the epilogue and the
// extraction of a block whose bound does not clear theta. Here every score
// already meets its gate in the register that holds it, so the bound works
// per score: each query's gate becomes an integer G (topk.cuh: int_gate),
// the largest dot whose score cannot beat it, from the aux range of the
// rows this block walks, and four dots of a query pair that are all <= G
// skip the convert, multiply and add of their epilogue. A score above G
// goes through the exact epilogue and K1's own gate, so the result is K1's
// by construction. Per part and not per 128-row tile (the TPU kernel's per
// block): a tile's range would need a barrier of both warpgroups and 256
// new bounds per tile, about the work of the epilogues it saves. The bound
// holds for aux >= 0 and finite on every row walked (never-written slots
// hold 0, erased ones keep their aux, an all-zero row quantizes to scale
// 0); a range that breaks it turns the integer test off (G = INT_MIN).

#include "topk.cuh"

namespace vrod {
namespace {

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

template <class Kind, int kEpi, bool kTma, bool kIntGate>
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
  // The int gate's G per query (read as int2 pairs) and aux range.
  __shared__ __align__(16) int gint[kIntGate ? kGroup : 2];
  __shared__ float arange[2];
  const Ring ring{align1024(smem_raw), full, empty, kRing};
  const Geometry geo = make_geometry<Kind>(row_bytes);
  const int part = blockIdx.x / groups;
  const int q0 = blockIdx.x % groups * kGroup;
  const int tiles = (n + kTileRows - 1) / kTileRows;
  ring_init(ring);
  if constexpr (kIntGate) aux_range(aux, n, part, parts, tiles, arange);
  const IntGate ig{gint, kIntGate ? arange[0] : 0.0f,
                   kIntGate ? arange[1] : 0.0f};
  for (int i = threadIdx.x; i < kGroup; i += kThreads) {
    const int qq = q0 + i;
    gate[i] = qq < b ? theta0[qq] : INFINITY;
    qsv[i] = kEpi == kScaleQs && qq < b ? qs2[qq] : 0.0f;
    len[i] = 0;
    if constexpr (kIntGate) gint[i] = int_gate(gate[i], ig.amin, ig.amax);
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
    int stage = 0, phase = 0;
    consume_all<Kind, kEpi, kIntGate>(
        geo, ring, stage, phase, aux, mask, n, b, k, offset, part, parts,
        tiles, q0, cap, gate, ig, qsv, len, hist, cand_v, cand_i, cand_n,
        NoSkip{});
  }
}

}  // namespace
}  // namespace vrod

using namespace vrod;

template <bool kIntGate>
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
    auto* kern = fused_topk_local<Kind, kEpi, kTma, kIntGate>;
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
    return launch_merge(cand_v, cand_i, cand_n, parts, cap, b, k, merge_v,
                        merge_i, out_v, out_i, s);
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
  return dispatch_leg<LaunchTopk<false>, true>(
      elem, epi, tma != 0, x, aux, mask, q, qs2, row_bytes, theta0, n, b, k,
      offset, groups, parts, cap, cand_v, cand_i, cand_n, merge_v,
      merge_i, out_v, out_i, static_cast<cudaStream_t>(stream));
}

// X9: K1 with the int32 gate bound, int8 rows under cosine or dot only
// (epilogue kScale with mask 0 or -inf); arguments as vrod_fused_topk's.
extern "C" int vrod_fused_intgate(
    int tma, const void* x, const void* aux, const void* mask,
    const void* q, const void* theta0, int n, int row_bytes, int b, int k,
    int offset, int groups, int parts, int cap, void* cand_v, void* cand_i,
    void* cand_n, void* merge_v, void* merge_i, void* out_v, void* out_i,
    void* stream) {
  auto* run = tma ? &LaunchTopk<true>::run<I8, kScale, true>
                  : &LaunchTopk<true>::run<I8, kScale, false>;
  return run(x, aux, mask, q, nullptr, row_bytes, theta0, n, b, k, offset,
             groups, parts, cap, cand_v, cand_i, cand_n, merge_v, merge_i,
             out_v, out_i, static_cast<cudaStream_t>(stream));
}
