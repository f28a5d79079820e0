// K1's small scans, in a file of its own so that nvcc compiles them beside
// fused_topk.cu's long scans (one compiler process a source).
//
// The TPU's K2 shapes (pallas_topk.py: _fused_call -> _kernel): scans too
// short for fused_topk.cu's persistent grid, that would give each of sms /
// ceil(b / 256) blocks fewer than SMALL_TILES row tiles (ops/cuda_topk.py:
// small_plan). There the card
// fills by splitting the queries: groups of kSmallGroup = 16 (wgmma n16),
// each scanned by a cluster of `parts` blocks; block p of a cluster walks
// row tiles p, p + parts, ... as K1's parts do, with the gated core at
// n16 and its 16 candidate lists of cap (256: cut by the warp bitonic
// sort) in shared memory, so no list leaves the chip. Then the cluster
// merges in the same launch: each (block, warp) takes some queries of the
// group and gathers their parts' lists from the other blocks' shared
// memory (ld.shared::cluster) into its own, then selects and ranks as K1's
// merge does. One launch, no scratch, no fills.

#include "topk.cuh"

namespace vrod {
namespace {

// ops/cuda_topk.py's SMALL_GROUP, SMALL_RING and SMALL_MAX_K (the plan and
// its shared-memory checks) follow these.
constexpr int kSmallGroup = 16;
constexpr int kSmallRing = 4;
template <class Kind>
__host__ __device__ constexpr int small_ring_bytes() {
  return kSmallRing * stage_bytes<Kind>(kSmallGroup);
}

template <class Kind, int kEpi, bool kTma>
__global__ void __launch_bounds__(kThreads, 1) fused_topk_small(
    const __grid_constant__ Maps maps, const int8_t* __restrict__ x,
    const int8_t* __restrict__ q, const float* __restrict__ aux,
    const __grid_constant__ RowMask mask,
    const float* __restrict__ q_scale, int row_bytes,
    const float* __restrict__ theta0, int n, int b, int k, int offset,
    int parts, int cap, float* __restrict__ out_v, int* __restrict__ out_i) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t full[kSmallRing], empty[kSmallRing];
  __shared__ float gate[kSmallGroup];
  __shared__ int len[kSmallGroup];
  __shared__ unsigned hist[kConsumers / 32 * 256];
  const Ring ring{align1024(smem_raw), full, empty, kSmallRing, !kTma};
  float* lv = reinterpret_cast<float*>(ring.base + small_ring_bytes<Kind>());
  int* li = reinterpret_cast<int*>(lv + (size_t)kSmallGroup * cap);
  const Geometry geo = make_geometry<Kind, kSmallGroup>(row_bytes);
  const int part = cluster_rank();
  const int q0 = blockIdx.y * kSmallGroup;
  const int tiles = (n + kTileRows - 1) / kTileRows;
  GateLists L{lv, li, len, gate, nullptr, 0.0f, 0.0f, cap, k};
#ifdef VROD_PROBE_COUNT
  L.probe = probe_counts;
#endif
  ring_init(ring);
  for (int i = threadIdx.x; i < kSmallGroup; i += kThreads) {
    const int qq = q0 + i;
    gate[i] = qq >= b ? INFINITY : theta0 != nullptr ? theta0[qq] : -INFINITY;
    len[i] = 0;
  }
  __syncthreads();
  // Every thread takes part in the two cluster barriers below, each role
  // inside its branch (so that ptxas compiles it under that role's
  // register budget); only the consumer warps merge.
  if (threadIdx.x >= kConsumers) {
    producer_regs<kGateProducerRegs>();
    if (ring_loader<kTma>()) {
      produce<Kind, kTma, kSmallGroup>(maps, Loads{x, q, n, b}, geo, ring,
                                       q0, part, tiles, parts);
    }
    cluster_sync();
    cluster_sync();
  } else {
    consumer_regs<kGateConsumerRegs>();
    constexpr int kOwn = kSmallGroup / (kConsumers / 32);
    const int warp = threadIdx.x >> 5;
    const int own0 = warp * kOwn;
    const int own1 = min(own0 + kOwn, b - q0);
    Gates<kSmallGroup / 8, kEpi, false> gr;
    load_gates(gr, L);
    load_qs(gr, q_scale, false, q0, b);
    int stage = 0, phase = 0;
    gate_consume<Kind, kEpi, false, 1, kSmallGroup>(
        geo, ring, stage, phase, aux, mask, n, offset, part, parts, tiles,
        L, gr, hist, own0, own1);
    // Each list cut to k in place, its length in len.
    gate_handover(L, hist + warp * 256, own0, own1, true, nullptr, nullptr,
                  nullptr, 0, 0);
    cluster_sync();  // every block's lists are cut to k
    // This warp's gather buffer: the ring, free after the scan.
    const int lane = threadIdx.x & 31;
    float* gv = reinterpret_cast<float*>(ring.base) + (size_t)warp * 2 * parts * k;
    int* gi = reinterpret_cast<int*>(gv + (size_t)parts * k);
    for (int ql = part + parts * warp; ql < kSmallGroup && q0 + ql < b;
         ql += parts * (kConsumers / 32)) {
      int nn = 0;
      for (int p = 0; p < parts; ++p) {
        const int m = ld_peer_s32(peer_addr(&len[ql], p));
        const uint32_t va = peer_addr(lv + (size_t)ql * cap, p);
        const uint32_t ia = peer_addr(li + (size_t)ql * cap, p);
        for (int e = lane; e < m; e += 32) {
          gv[nn + e] = ld_peer_f32(va + 4 * e);
          gi[nn + e] = ld_peer_s32(ia + 4 * e);
        }
        nn += m;
      }
      merge_ranked(gv, gi, nn, k, hist + warp * 256,
                   out_v + (size_t)(q0 + ql) * k,
                   out_i + (size_t)(q0 + ql) * k);
      __syncwarp();
    }
    cluster_sync();  // no block leaves while another reads its lists
  }
}

}  // namespace
}  // namespace vrod

using namespace vrod;

struct LaunchSmall {
  template <class Kind, int kEpi, bool kTma>
  static int run(const void* x, const void* aux, RowMask mask, const void* q,
                 const void* q_scale, int row_bytes, const void* theta0,
                 int n, int b, int k, int offset, int groups, int parts,
                 int cap, void* out_v, void* out_i, int granule,
                 const void* const* m3, cudaStream_t s) {
    if (parts < 1 || parts > kMaxCluster || cap < k + 32 ||
        parts * k * 8 * (kConsumers / 32) > small_ring_bytes<Kind>()) {
      return (int)cudaErrorInvalidValue;
    }
    Maps maps;
    int e = launch_maps<Kind, kTma>(&maps, m3, x, q, n, b, row_bytes,
                                    kSmallGroup, granule);
    if (e != 0) return e;
    const int smem = 1024 + small_ring_bytes<Kind>() + kSmallGroup * cap * 8;
    e = ensure_smem<fused_topk_small<Kind, kEpi, kTma>>(smem);
    if (e != 0) return e;
    return launch_clusters(
        fused_topk_small<Kind, kEpi, kTma>, dim3(parts, groups), parts, smem,
        s, maps, static_cast<const int8_t*>(x),
        static_cast<const int8_t*>(q), static_cast<const float*>(aux), mask,
        static_cast<const float*>(q_scale), row_bytes,
        static_cast<const float*>(theta0), n, b, k, offset, parts, cap,
        static_cast<float*>(out_v), static_cast<int*>(out_i));
  }
};

// The small-scan kernel: arguments as vrod_fused_topk's, the plan
// small_plan's (groups, parts, cap), no scratch.
extern "C" int vrod_fused_topk_small(
    int elem, int epi, int granule, const void* x, const void* aux,
    const void* valid, const void* bias, const void* q, const void* q_scale,
    const void* theta0, int n, int row_bytes, int b, int k, int offset,
    int groups, int parts, int cap, void* out_v, void* out_i,
    const void* x_map, const void* q_map, const void* q_hi_map,
    void* stream) {
  const RowMask mask{static_cast<const uint8_t*>(valid),
                     static_cast<const float*>(bias)};
  const void* m3[3] = {x_map, q_map, q_hi_map};
  const void* const* maps = x_map != nullptr ? m3 : nullptr;
  return dispatch_leg<LaunchSmall, true>(
      elem, epi, granule == 16, x, aux, mask, q, q_scale, row_bytes, theta0,
      n, b, k, offset, groups, parts, cap, out_v, out_i, granule, maps,
      static_cast<cudaStream_t>(stream));
}
