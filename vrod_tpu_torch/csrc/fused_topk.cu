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
// This file holds the long scan of a call without a floor (theta0 null);
// ops/cuda_topk.py's scan_route sends a call with one to
// fused_topk_floor.cu's n256 scan, and a short scan to fused_topk_small.cu.
// The design (score.cuh, topk.cuh's gated core): each row byte leaves
// device memory once and passes through shared memory once per query
// group of 64 (kWidth), by TMA into a ring that one producer warp keeps
// full; the dots run as wgmma m64n64 with the queries streaming beside the
// rows; and the (B, N) score matrix never exists: each score is compared,
// in the register that holds it, with its query's gate, max(theta0, the
// k-th its list's last cut left), held in registers, and only the few that
// beat it are appended to the query's list.
//
// The TPU kernel walks the row blocks in order on one core and carries its
// top-k in VMEM. Here a persistent grid has about one block per SM:
//   1. fused_topk_local: block (part p, query group) walks row tiles p,
//      p + parts, ... in ascending order and keeps, per query, an unordered
//      candidate list in shared memory beside the ring (in global scratch
//      past the k where the lists no longer fit: ops/cuda_topk.py,
//      topk_plan), filled by warp-aggregated appends. One vote barrier a
//      tile learns whether a passing score found its list full; only then
//      the warps that own the full lists cut them to exactly k (a warp
//      bitonic sort to 256 entries, an exact radix select past that), each
//      cut's k-th joins its query's gate, and what waited is tested again
//      at or above it. Rows come in ascending slot order, so a later score
//      equal to the gate loses its tie anyway. At the part's end each list
//      is cut to k and handed to the merge.
//   2. fused_topk_merge: one warp per query gathers the part lists, cuts
//      them to k, and ranks the survivors by (value desc, slot asc).
// The select is exact and independent of scheduling: the k-th key is found
// by a bitonic sort or by a radix select over order-isomorphic 32-bit keys,
// a byte at a time (the method of distances.kth_largest_count), and ties at
// the k-th value are broken by the lowest slots. The result is the top-k
// of {slots with score > theta0} in (value desc, slot asc) order, with
// (-inf, -1) on empty ranks: the Pallas kernel's contract. The gated core,
// the selects and the merge live in topk.cuh, which the one-launch sampled
// floor (fused_theta.cu) and the gated extraction experiments share.
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
// rows this block walks, held in registers beside the gate, and four dots
// of a query pair that are all <= G skip the convert, multiply and add of
// their epilogue. A score above G goes through the exact epilogue and K1's
// own gate, so the result is K1's by construction. Per part and not per
// 128-row tile (the TPU kernel's per block): a tile's range would need a
// barrier of both warpgroups and new bounds per tile, about the work of
// the epilogues it saves. The bound holds for aux >= 0 and finite on every
// row walked (never-written slots hold 0, erased ones keep their aux, an
// all-zero row quantizes to scale 0); a range that breaks it turns the
// integer test off (G = INT_MIN).

#include "topk.cuh"

namespace vrod {
namespace {

// K1's long scan: block (part, group) of a grid of groups x parts. Lists
// on chip or at cand_v/cand_i (parts, b, cap); the hand-over to
// cand_v/cand_i/cand_n at stride k (on chip) or cap.
template <class Kind, int kEpi, bool kTma, bool kIntGate>
__global__ void __launch_bounds__(kThreads, 1) fused_topk_local(
    const __grid_constant__ Maps maps, const int8_t* __restrict__ x,
    const int8_t* __restrict__ q, const float* __restrict__ aux,
    const __grid_constant__ RowMask mask,
    const float* __restrict__ q_scale, int row_bytes,
    const float* __restrict__ theta0, int n, int b, int k, int offset,
    int groups, int parts, const Layout lay, float* __restrict__ cand_v,
    int* __restrict__ cand_i, int* __restrict__ cand_n) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t full[kRing], empty[kRing];
  __shared__ float gate[kWidth];
  __shared__ int len[kWidth];
  __shared__ int gint[kWidth];  // X9: each query's G
  __shared__ float arange[2];   // X9: the aux range of the part's rows
  __shared__ __align__(16) unsigned hist[kConsumers / 32 * 256];
  uint8_t* base = align1024(smem_raw);
  const Geometry geo = make_geometry<Kind, kWidth>(row_bytes);
#ifdef VROD_PROBE_PRESPLIT
  __shared__ uint64_t ready[kRing];
  const Ring ring{base, full, empty, lay.ring, !kTma,
                  kTma && Kind::kSplit ? ready : nullptr};
#else
  const Ring ring{base, full, empty, lay.ring, !kTma};
#endif
  const int part = blockIdx.x / groups;
  const int q0 = blockIdx.x % groups * kWidth;
  const int tiles = (n + kTileRows - 1) / kTileRows;
  const int cap = lay.cap;
  GateLists L{nullptr, nullptr, len, gate, gint, 0.0f, 0.0f, cap, k};
#ifdef VROD_PROBE_COUNT
  L.probe = probe_counts;
#endif
  if (lay.on_chip) {
    L.v = reinterpret_cast<float*>(base + lay.ring_bytes<Kind>());
    L.i = reinterpret_cast<int*>(L.v + (size_t)kWidth * cap);
  } else {
    const size_t list0 = ((size_t)part * b + q0) * cap;
    L.v = cand_v + list0;
    L.i = cand_i + list0;
  }
  ring_init(ring);
  if constexpr (kIntGate) {
    aux_range(aux, n, part, parts, tiles, arange);  // syncs the block
    L.amin = arange[0];
    L.amax = arange[1];
  }
  for (int i = threadIdx.x; i < kWidth; i += kThreads) {
    const int qq = q0 + i;
    const float g =
        qq >= b ? INFINITY : theta0 != nullptr ? theta0[qq] : -INFINITY;
    gate[i] = g;
    len[i] = 0;
    gint[i] = kIntGate ? int_gate(g, L.amin, L.amax) : 0;
  }
  __syncthreads();
  // Each role's whole remaining code lies inside its branch, so that ptxas
  // compiles it under that role's register budget (setmaxnreg).
  if (threadIdx.x >= kConsumers) {
    producer_regs<kGateProducerRegs>();
    if (ring_loader<kTma>()) {
      produce<Kind, kTma, kWidth>(maps, Loads{x, q, n, b}, geo, ring, q0,
                                  part, tiles, parts);
    }
  } else {
    consumer_regs<kGateConsumerRegs>();
    constexpr int kOwn = kWidth / (kConsumers / 32);
    const int own0 = (threadIdx.x >> 5) * kOwn;
    const int own1 = min(own0 + kOwn, b - q0);
    Gates<kWidth / 8, kEpi, kIntGate> gr;
    load_gates(gr, L);
    load_qs(gr, q_scale, false, q0, b);
    int stage = 0, phase = 0;
    gate_consume<Kind, kEpi, kIntGate, 1, kWidth>(
        geo, ring, stage, phase, aux, mask, n, offset, part, parts, tiles,
        L, gr, hist, own0, own1);
    gate_handover(L, hist + (threadIdx.x >> 5) * 256, own0, own1,
                  lay.on_chip != 0, cand_v, cand_i, cand_n,
                  ((size_t)part * b + q0) * k, (size_t)part * b + q0);
  }
}

}  // namespace
}  // namespace vrod

using namespace vrod;

template <bool kIntGate>
struct LaunchTopk {
  template <class Kind, int kEpi, bool kTma>
  static int run(const void* x, const void* aux, RowMask mask, const void* q,
                 const void* q_scale, int row_bytes, const void* theta0,
                 int n, int b, int k, int offset, int groups, int parts,
                 const Layout& lay, void* scratch, void* out_v, void* out_i,
                 int granule, const void* const* m3, cudaStream_t s) {
    if (lay.cap < k + 32 || lay.ring < 2 || lay.ring > kRing) {
      return (int)cudaErrorInvalidValue;
    }
    Maps maps;
    int e = launch_maps<Kind, kTma>(&maps, m3, x, q, n, b, row_bytes, kWidth,
                                    granule);
    if (e != 0) return e;
    const int smem = lay.smem<Kind>();
    e = ensure_smem<fused_topk_local<Kind, kEpi, kTma, kIntGate>>(smem);
    if (e != 0) return e;
    const int stride = lay.on_chip ? k : lay.cap;
    const Scratch sc(scratch, parts, b, k, stride);
    fused_topk_local<Kind, kEpi, kTma, kIntGate>
        <<<groups * parts, kThreads, smem, s>>>(
            maps, static_cast<const int8_t*>(x),
            static_cast<const int8_t*>(q), static_cast<const float*>(aux),
            mask, static_cast<const float*>(q_scale), row_bytes,
            static_cast<const float*>(theta0), n, b, k, offset, groups,
            parts, lay, sc.cand_v, sc.cand_i, sc.cand_n);
    e = (int)cudaGetLastError();
    if (e != 0) return e;
    return launch_merge(sc.cand_v, sc.cand_i, sc.cand_n, parts, stride, b, k,
                        sc.merge_v, sc.merge_i, out_v, out_i, s);
  }
};

// elem/epi: score.cuh's Elem and Epi codes; granule: 16, rows and queries
// load by TMA (row bytes a multiple of 16, 16-byte aligned bases), else
// the producer warpgroup copies them by granules of 8, 4, 2 or 1 bytes
// (ops/cuda_topk.py: copy_granule). valid (n,) bool and bias (n,) or null: the
// rows' mask (RowMask). q_scale (b,) is read by kScaleQs only; theta0 (b,)
// or null (no floor). row_bytes: bytes per stored row (int4: dim / 2).
// groups, parts, cap, on_chip, ring: the plan (ops/cuda_topk.py:
// topk_plan). scratch: the buffer of Scratch. maps: the three encoded
// tensor maps (x, q, q_hi; vrod_encode_map: queries in boxes of the
// group), null without TMA. The short scans' kernel is
// fused_topk_small.cu's.
extern "C" int vrod_fused_topk(
    int elem, int epi, int granule, const void* x, const void* aux,
    const void* valid, const void* bias, const void* q, const void* q_scale,
    const void* theta0, int n, int row_bytes, int b, int k, int offset,
    int groups, int parts, int cap, int on_chip, int ring, void* scratch,
    void* out_v, void* out_i, const void* x_map,
    const void* q_map, const void* q_hi_map, void* stream) {
  const RowMask mask{static_cast<const uint8_t*>(valid),
                     static_cast<const float*>(bias)};
  const Layout lay{ring, cap, on_chip};
  const void* m3[3] = {x_map, q_map, q_hi_map};
  const void* const* maps = x_map != nullptr ? m3 : nullptr;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch_leg<LaunchTopk<false>, true>(
      elem, epi, granule == 16, x, aux, mask, q, q_scale, row_bytes, theta0,
      n, b, k, offset, groups, parts, lay, scratch, out_v, out_i, granule,
      maps, s);
}

// X9: K1 with the int32 gate bound, int8 rows under cosine or dot only
// (epilogue kScale, mask 0 or -inf: no bias); arguments as
// vrod_fused_topk's, its maps encoded here.
extern "C" int vrod_fused_intgate(
    int granule, const void* x, const void* aux, const void* valid,
    const void* q, const void* theta0, int n, int row_bytes, int b, int k,
    int offset, int groups, int parts, int cap, int on_chip, int ring,
    void* scratch, void* out_v, void* out_i, void* stream) {
  auto* run = granule == 16 ? &LaunchTopk<true>::run<I8, kScale, true>
                            : &LaunchTopk<true>::run<I8, kScale, false>;
  return run(x, aux, RowMask{static_cast<const uint8_t*>(valid), nullptr},
             q, nullptr, row_bytes, theta0, n, b, k, offset, groups, parts,
             Layout{ring, cap, on_chip}, scratch, out_v, out_i, granule,
             nullptr, static_cast<cudaStream_t>(stream));
}

// The ring depth the long scan was built with (ops/cuda_topk.py's plan).
extern "C" int vrod_k1_ring() { return kRing; }

// A long-scan block's whole shared memory at a layout (a ring of `ring`
// stages, lists of `cap` on chip or not) of the f32x3 legs (split: stages
// that hold both query halves) or of every other: the kernel's static part
// (the X9 build's, the largest) and the dynamic part (bytes; -1 if the
// card cannot say).
extern "C" int vrod_topk_smem(int ring, int cap, int on_chip, int split) {
  cudaFuncAttributes attr{};
  if (cudaFuncGetAttributes(&attr, fused_topk_local<I8, kScale, true, true>)
      != cudaSuccess) {
    return -1;
  }
  const Layout lay{ring, cap, on_chip};
  return (int)attr.sharedSizeBytes
         + (split ? lay.smem<F32X3>() : lay.smem<I8>());
}

#ifdef VROD_PROBE_COUNT
// Probe builds: copy K1's event counters (topk.cuh: probe_counts) to host
// memory `out` (8 ints) and zero them.
extern "C" int vrod_probe_counts(int* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, probe_counts, 8 * sizeof(int));
  if (e != cudaSuccess) return (int)e;
  static const int zero[8] = {};
  return (int)cudaMemcpyToSymbol(probe_counts, zero, 8 * sizeof(int));
}
#endif

// One tensor map (score.cuh: encode_map) into `out` (128 bytes of host
// memory), which the wrapper caches by everything it encodes.
extern "C" int vrod_encode_map(void* out, const void* base, int inner,
                               long outer, long stride, int box_outer) {
  CUtensorMap m;
  const int e = encode_map(&m, base, inner, outer, stride, box_outer);
  if (e == 0) std::memcpy(out, &m, sizeof(m));
  return e;
}
