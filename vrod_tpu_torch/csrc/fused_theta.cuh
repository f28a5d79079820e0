// X8 and X6: the sampled floor and the gated scan in one cooperative
// launch (and K1's merge behind it), every leg of K1. The kernel lives in
// this header; fused_theta.cu builds the int8, int4, bfloat16 and TF32
// legs and fused_theta_f32x3.cu the f32x3 legs (float32 at "high" and
// "exact": score.cuh's F32X3), so that nvcc compiles the two halves at
// once. At f32x3 the sample and the scan both take F32X3's dots (each row
// k-block with the query's big and small parts in one stage: score.cuh's
// Walk), so the sample's maxima are the scan's scores bit for bit there
// too; a sample tile skipped with skip_sample_dots passes its stages
// unscored.
//
// Replaces the Pallas kernels experiments/kexp20.py: fused_theta_gated ->
// _kernel_theta_gated (X8) and experiments/kexp17.py: fused_theta ->
// _kernel_theta_fused (X6). Both score a prefix sample into strided
// 128-group maxima, bisect those for a floor below their k-th largest, and
// scan every row from that floor; X6 subtracts a per-query margin and
// extracts ungated, X8 takes margin 0 and the gated extraction. K1's scan
// is gated by construction (each score meets max(theta0, its list's k-th)
// in its register) and its result is the same either way, as kexp17
// asserts against the gated stock kernel, so one kernel serves both: X6 is
// the margin argument, X8 margin 0. Stock, this is K3 (one launch), the
// count threshold (~100 small torch launches) and K1 (two).
//
// What bounds it on an H100: K1's work plus the sample's: at the main path
// (1M x 768 int8, b256, a 32,768-row sample) the rows' 805 MB at 3.35
// TB/s, 0.24 ms, with the sample's 25 MB and 13 G operations on top. The
// design keeps K1's core (score.cuh, topk.cuh: K1's query groups of 64,
// and its gated core) so the sample's
// scores are K1's scores bit for bit, which is what makes margin 0 sound
// (kexp20.py:13-15), and adds three grid-wide barriers (cooperative_groups;
// the launch checks that the grid is co-resident and fails otherwise):
//   0. every block sets its share of the sub-maxima to -inf;   | barrier
//   1. sample: block (part p, group g) scores the p-th of `parts` equal
//      runs of consecutive sample tiles with K1's producer, ring and wgmma,
//      and keeps each score's order key in a running max in the register
//      beside its accumulator, per (query, lane) (lane t of sample block j:
//      rows j * blk + t + 128 i, K3's layout) over the run's tiles of one
//      sample block; when the run leaves a sample block (at most twice) it
//      folds them into the (query, block, lane) maxima in global memory by
//      atomicMax. The keys are a bijection that keeps -0.0 below +0.0, so a
//      maximum is one of the scores bit for bit;                  | barrier
//   2. bisection: one warp per query (warps of every block share the
//      batch) runs distances.bisect_floor's float ops in its order
//      (--fmad=false and __f*_rn: each op rounded once), so theta0 equals
//      the plain version's on the same maxima bit for bit; theta0 = lo -
//      margin. With skip_sample_dots it also takes each sample block's
//      maximum per query;                                          | barrier
//   3. scan: K1's gated core from gate = theta0 over every row tile of the
//      part in ascending order (ties at a raised gate lose by slot, as in
//      K1). With skip_sample_dots a sample tile whose block maxima beat no
//      gate of the group passes through the ring without its wgmma or gate
//      (the TMA stream keeps its shape, as on the TPU: kexp20.py:144-162);
//      the 256 consumers decide together with one bar.red.or.
// Then fused_topk_merge, a second launch, as for K1.

#pragma once

#include <cooperative_groups.h>

#include "topk.cuh"

namespace vrod {
namespace {

namespace cg = cooperative_groups;

constexpr int kLanes = kTileRows;  // sub-maxima lanes per sample block

// The order key of a float that keeps -0.0 below +0.0 (a bijection;
// key_float inverts it): a max of keys is a float max that returns one of
// its arguments bit for bit.
__device__ __forceinline__ int order_key(float f) {
  const int b = __float_as_int(f);
  return b ^ ((b >> 31) & 0x7fffffff);
}

// skip_sample_dots: a sample tile passes without its dots when, for every
// query of the group, its sample block's maximum is at or below the gate:
// then no score of the tile can be appended.
struct SampleSkip {
  const float* bmax;  // (b, s_blocks)
  int s_blocks, blk_tiles, sample_tiles, b, q0;
  bool on;
  __device__ bool operator()(int t, const float* gate) const {
    if (!on || t >= sample_tiles) return false;  // block-uniform
    const int qq = q0 + threadIdx.x;  // consumer thread i < kWidth: query i
    const bool beats =
        threadIdx.x < kWidth && qq < b &&
        __ldcg(bmax + (size_t)qq * s_blocks + t / blk_tiles) >
            gate[threadIdx.x];
    return !consumer_any<kBarSkip>(beats);
  }
};

// Phase 1, a consumer thread's part: the sample tiles [t0, t1), each's
// dots, then each score's order key into the running max beside its
// accumulator; the maxima of one sample block folded into sub_keys when
// the run leaves it and at its end (no atomic a score).
template <class Kind, int kEpi>
__device__ __forceinline__ void sample_pass(
    const Geometry& geo, const Ring& ring, int& stage, int& phase,
    const float* __restrict__ aux, const float* __restrict__ mask,
    const float* __restrict__ qs2, int b, int t0, int t1, int blk_tiles,
    int nsub, int q0, int* __restrict__ sub_keys) {
  constexpr int kA = kWidth / 2;
  constexpr int kNone = (int)0x807fffff;  // order_key(-inf)
  using Acc = typename Kind::Acc;
  Acc acc[kA];
  int mx[kA];
  Gates<kA / 4, kEpi, false> qs;  // only its qs
  load_qs(qs, qs2, true, q0, b);
  const int lane0 = tile_row(0);
  int held = -1;  // the sample block whose maxima mx holds
  const auto fold = [&]() {
#pragma unroll
    for (int i = 0; i < kA; ++i) {
      const int qq = q0 + query_col(i);
      if (qq < b && mx[i] != kNone) {
        atomicMax(sub_keys + (size_t)qq * nsub + held * kLanes + lane0 +
                      8 * ((i >> 1) & 1),
                  mx[i]);
      }
    }
  };
  for (int t = t0; t < t1; ++t) {
    const int row0 = t * kTileRows + lane0;
    float aux_r[2], mask_r[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      aux_r[h] = ldg_f32(aux + row0 + 8 * h);
      mask_r[h] = ldg_f32(mask + row0 + 8 * h);
    }
    consume_tile<Kind>(acc, geo, ring, stage, phase);
    if (t / blk_tiles != held) {
      if (held >= 0) fold();
      held = t / blk_tiles;
#pragma unroll
      for (int i = 0; i < kA; ++i) mx[i] = kNone;
    }
#pragma unroll
    for (int i = 0; i < kA; ++i) {
      float q2 = 0.0f;
      if constexpr (kEpi == kScaleQs) {
        q2 = i & 1 ? qs.qs[i >> 2].y : qs.qs[i >> 2].x;
      }
      const float s = score_epilogue<kEpi>(dot_value(acc[i]),
                                           aux_r[(i >> 1) & 1],
                                           mask_r[(i >> 1) & 1], q2);
      mx[i] = max(mx[i], order_key(s));
    }
  }
  if (held >= 0) fold();
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// Phase 2, one warp per query: theta0 = bisect_floor(sub)[qq] - margin[qq]
// (distances.bisect_floor's ops in its order), and with want_bmax each
// sample block's maximum. The sub-maxima were written by other blocks'
// atomics: read them from L2 (__ldcg).
__device__ void bisect_queries(const int* __restrict__ sub_keys,
                               const float* __restrict__ margin, int b,
                               int k, int nsub, int iters, bool want_bmax,
                               float* __restrict__ bmax,
                               float* __restrict__ theta0) {
  const int lane = threadIdx.x & 31;
  const int warps = gridDim.x * (kConsumers / 32);
  for (int qq = blockIdx.x * (kConsumers / 32) + (threadIdx.x >> 5); qq < b;
       qq += warps) {
    const int* row = sub_keys + (size_t)qq * nsub;
    float hi = -INFINITY, mn = INFINITY;
    for (int e = lane; e < nsub; e += 32) {
      const float v = key_float(__ldcg(row + e));
      hi = fmaxf(hi, v);
      mn = fminf(mn, v);
    }
    hi = warp_max(hi);
    float lo = __fsub_rn(warp_min(mn), 1.0f);
    for (int it = 0; it < iters; ++it) {
      const float mid = __fmul_rn(0.5f, __fadd_rn(lo, hi));
      unsigned c = 0;
      for (int e = lane; e < nsub; e += 32) {
        c += key_float(__ldcg(row + e)) > mid;
      }
      if ((int)__reduce_add_sync(kFull, c) >= k) {
        lo = mid;
      } else {
        hi = mid;
      }
    }
    if (lane == 0) theta0[qq] = __fsub_rn(lo, margin[qq]);
    if (want_bmax) {
      for (int j = 0; j < nsub / kLanes; ++j) {
        float m = -INFINITY;
        for (int e = lane; e < kLanes; e += 32) {
          m = fmaxf(m, key_float(__ldcg(row + j * kLanes + e)));
        }
        m = warp_max(m);
        if (lane == 0) bmax[(size_t)qq * (nsub / kLanes) + j] = m;
      }
    }
  }
}

template <class Kind, int kEpi, bool kTma>
__global__ void __launch_bounds__(kThreads, 1) fused_theta_local(
    const __grid_constant__ Maps maps, const int8_t* __restrict__ x,
    const int8_t* __restrict__ q, const float* __restrict__ aux,
    const float* __restrict__ mask, const float* __restrict__ qs2,
    int row_bytes, const float* __restrict__ margin, int n, int b, int k,
    int offset, int groups, int parts, const Layout lay, int sample_tiles,
    int blk_tiles, int iters, int skip,
    int* __restrict__ sub_keys, float* __restrict__ bmax,
    float* __restrict__ theta0, float* __restrict__ cand_v,
    int* __restrict__ cand_i, int* __restrict__ cand_n) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t full[kRing], empty[kRing];
  __shared__ float gate[kWidth];
  __shared__ int len[kWidth];
  __shared__ __align__(16) unsigned hist[kConsumers / 32 * 256];
  cg::grid_group grid = cg::this_grid();
  uint8_t* base = align1024(smem_raw);
  const Geometry geo = make_geometry<Kind, kWidth>(row_bytes);
  const Ring ring{base, full, empty, lay.ring, !kTma};
  const int cap = lay.cap;
  const int part = blockIdx.x / groups;
  const int q0 = blockIdx.x % groups * kWidth;
  const int tiles = (n + kTileRows - 1) / kTileRows;
  const int s_blocks = sample_tiles / blk_tiles;
  const int nsub = s_blocks * kLanes;
  // The sample tiles this part scores: the part-th of `parts` equal runs.
  const int s0 = (int)((long)part * sample_tiles / parts);
  const int s1 = (int)((long)(part + 1) * sample_tiles / parts);
  const bool producer = threadIdx.x >= kConsumers;
  const bool loader = producer && ring_loader<kTma>();
  const Loads ld{x, q, n, b};
  GateLists L{nullptr, nullptr, len, gate, nullptr, 0.0f, 0.0f, cap, k};
  if (lay.on_chip) {
    L.v = reinterpret_cast<float*>(base + lay.ring_bytes<Kind>());
    L.i = reinterpret_cast<int*>(L.v + (size_t)kWidth * cap);
  } else {
    const size_t list0 = ((size_t)part * b + q0) * cap;
    L.v = cand_v + list0;
    L.i = cand_i + list0;
  }
  ring_init(ring);
  for (int i = threadIdx.x; i < kWidth; i += kThreads) len[i] = 0;
  // 0. The sub-maxima start at -inf.
  const size_t all = (size_t)b * nsub;
  for (size_t e = (size_t)blockIdx.x * kThreads + threadIdx.x; e < all;
       e += (size_t)gridDim.x * kThreads) {
    sub_keys[e] = order_key(-INFINITY);
  }
  grid.sync();
  // Each role's whole remaining code lies inside its branch, so that ptxas
  // compiles it under that role's register budget (setmaxnreg); the
  // barriers are warp-uniform in both.
  int stage = 0, phase = 0;
  if (producer) {
    producer_regs<kGateProducerRegs>();
    // 1. The sample, 2. (theta0: nothing to load), 3. the scan.
    if (loader) {
      produce_tiles<Kind, kTma, kWidth>(maps, ld, geo, ring, q0, s0, s1, 1,
                                        stage, phase);
    }
    grid.sync();
    grid.sync();
    if (loader) {
      produce_tiles<Kind, kTma, kWidth>(maps, ld, geo, ring, q0, part, tiles,
                                        parts, stage, phase);
    }
  } else {
    consumer_regs<kGateConsumerRegs>();
    // 1. The sample's maxima.
    sample_pass<Kind, kEpi>(geo, ring, stage, phase, aux, mask, qs2, b, s0,
                            s1, blk_tiles, nsub, q0, sub_keys);
    grid.sync();
    // 2. theta0 (and the sample blocks' maxima).
    bisect_queries(sub_keys, margin, b, k, nsub, iters, skip != 0, bmax,
                   theta0);
    grid.sync();
    // 3. The scan from theta0.
    for (int i = threadIdx.x; i < kWidth; i += kConsumers) {
      gate[i] = q0 + i < b ? __ldcg(theta0 + q0 + i) : INFINITY;
    }
    consumer_sync();
    constexpr int kOwn = kWidth / (kConsumers / 32);
    const int own0 = (threadIdx.x >> 5) * kOwn;
    const int own1 = min(own0 + kOwn, b - q0);
    Gates<kWidth / 8, kEpi, false> gr;
    load_gates(gr, L);
    load_qs(gr, qs2, true, q0, b);
    gate_consume<Kind, kEpi, false, 1, kWidth>(
        geo, ring, stage, phase, aux, FloatMask{mask}, n, offset, part,
        parts, tiles, L, gr, hist, own0, own1,
        SampleSkip{bmax, s_blocks, blk_tiles, sample_tiles, b, q0,
                   skip != 0});
    gate_handover(L, hist + (threadIdx.x >> 5) * 256, own0, own1,
                  lay.on_chip != 0, cand_v, cand_i, cand_n,
                  ((size_t)part * b + q0) * k, (size_t)part * b + q0);
  }
}

struct LaunchTheta {
  template <class Kind, int kEpi, bool kTma>
  static int run(const void* x, const void* aux, const void* mask,
                 const void* q, const void* qs2, int row_bytes,
                 const void* margin, int n, int b, int k, int offset,
                 int groups, int parts, const Layout& lay,
                 int sample_tiles, int blk_tiles, int iters, int skip,
                 void* sub_keys, void* bmax, void* theta0, void* cand_v,
                 void* cand_i, void* cand_n, void* merge_v, void* merge_i,
                 void* out_v, void* out_i, int granule, cudaStream_t s) {
    if (lay.cap < k + 32 || lay.ring < 2 || lay.ring > kRing) {
      return (int)cudaErrorInvalidValue;
    }
    Maps maps{};
    {
      const int e = kTma ? make_maps(&maps, Kind::kHalves, x, q, n, b,
                                     row_bytes, kWidth)
                         : copy_maps(&maps, x, q, row_bytes, granule);
      if (e != 0) return e;
    }
    const int smem = lay.smem<Kind>();
    constexpr auto kern = fused_theta_local<Kind, kEpi, kTma>;
    cudaError_t e = (cudaError_t)ensure_smem<kern>(smem);
    if (e != cudaSuccess) return (int)e;
    // The barriers need every block resident at once.
    int dev = 0, sms = 0, fit = 0;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
        (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess) {
      return (int)e;
    }
    if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &fit, kern, kThreads, smem)) != cudaSuccess) {
      return (int)e;
    }
    fit *= sms;
    if (groups * parts > fit) {
      return (int)cudaErrorCooperativeLaunchTooLarge;
    }
    const int stride = lay.on_chip ? k : lay.cap;
    const int8_t* xa = static_cast<const int8_t*>(x);
    const int8_t* qa = static_cast<const int8_t*>(q);
    const float* auxa = static_cast<const float*>(aux);
    const float* maska = static_cast<const float*>(mask);
    const float* qs2a = static_cast<const float*>(qs2);
    const float* margina = static_cast<const float*>(margin);
    int* suba = static_cast<int*>(sub_keys);
    float* bmaxa = static_cast<float*>(bmax);
    float* t0a = static_cast<float*>(theta0);
    float* cva = static_cast<float*>(cand_v);
    int* cia = static_cast<int*>(cand_i);
    int* cna = static_cast<int*>(cand_n);
    Layout layv = lay;
    void* args[] = {&maps, &xa, &qa, &auxa, &maska, &qs2a, &row_bytes,
                    &margina, &n, &b, &k, &offset, &groups, &parts, &layv,
                    &sample_tiles, &blk_tiles, &iters, &skip, &suba,
                    &bmaxa, &t0a, &cva, &cia, &cna};
    e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kern),
                                    dim3(groups * parts), dim3(kThreads),
                                    args, smem, s);
    if (e != cudaSuccess) return (int)e;
    return launch_merge(cand_v, cand_i, cand_n, parts, stride, b, k, merge_v,
                        merge_i, out_v, out_i, s);
  }
};

}  // namespace
}  // namespace vrod
