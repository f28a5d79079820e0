// K3: sampled sub-max pre-pass, every leg of the TPU kernel (int8, packed
// int4, bfloat16 and float32 rows; metrics cosine, dot and l2).
//
// Replaces the Pallas kernel vrod_tpu/ops/pallas_topk.py: sampled_submax ->
// _submax_kernel. Scores a prefix sample of the rows with K1's own scoring
// core (score.cuh: the same ring, the same wgmma instructions in the same
// order, so the two agree bit for bit) and emits, for every row block of
// blk rows, 128 strided group maxima: lane t of block j is the max over
// rows j*blk + t, j*blk + t + 128, ... Output (B, 128 * n / blk) f32, the
// layout of the TPU kernel.
//
// What bounds it on an H100: at the int8 headline the sample is 25 MB of
// rows (32,768 x 768: 7.5 us at 3.35 TB/s) and 12.9 G integer operations
// for B = 256 (6.5 us on the tensor cores; the float legs' larger samples
// scale both), so with so little work what bounds it is parallelism and
// each block's start-up. The TPU grid is (query tiles, row blocks): only
// two row blocks at the int8 headline. Here each row block is split into
// spb segments of whole 128-row tiles so the grid fills the SMs. A tile's
// row t feeds lane t (blocks and segments start on whole tiles), so the
// thread that holds a (query, row) accumulator alone owns that (query,
// lane) maximum, kept in shared memory across the segment's tiles without
// atomics; when spb > 1 a second pass takes the max over the segments'
// partial results (max is exact, so the order does not matter).

#include <algorithm>
#include <cmath>

#include "score.cuh"

namespace vrod {
namespace {

constexpr int kLanes = 128;
constexpr int kRing = 2;  // stages: the running maxima take the rest
constexpr int kBestBytes = kGroup * kLanes * 4;

static_assert(kLanes == kTileRows, "tile row t feeds lane t");

// Where (query column ql, lane l) lives in the maxima: query rows of 128
// floats, lanes XOR-swizzled by bits 1-2 of the query so the eight lanes and
// four query columns of one accumulator index hit 32 distinct banks.
__device__ __forceinline__ int best_at(int ql, int l) {
  return ql * kLanes + (l ^ (((ql >> 1) & 3) << 3));
}

// The consumer warpgroups of K3: per row tile, the dots, then each score
// into its (query, lane) maximum; at the end the maxima out.
template <class Kind, int kEpi>
__device__ __forceinline__ void consume_all(
    const Geometry& geo, const Ring& ring, const float* __restrict__ aux,
    const float* __restrict__ mask, int n, int b, int blk, int j, int sg,
    int q0, int t0, int seg_tiles, const float* qsv, float* best,
    float* __restrict__ out) {
  using Acc = typename Kind::Acc;
  Acc acc[kAcc];
  int stage = 0, phase = 0;
  for (int t = t0; t < t0 + seg_tiles; ++t) {
    consume_tile<Kind>(acc, geo, ring, stage, phase);
    const int lane0 = tile_row(0);
    float aux_r[2], mask_r[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      aux_r[h] = aux[t * kTileRows + lane0 + 8 * h];
      mask_r[h] = mask[t * kTileRows + lane0 + 8 * h];
    }
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      const int h = (i >> 1) & 1;
      const int ql = query_col(i);
      float* m = &best[best_at(ql, lane0 + 8 * h)];
      *m = fmaxf(*m, score_epilogue<kEpi>(dot_value(acc[i]), aux_r[h],
                                          mask_r[h], qsv[ql]));
    }
  }
  consumer_sync();
  const size_t width = (size_t)kLanes * (n / blk);
  for (int e = threadIdx.x; e < kGroup * kLanes; e += kConsumers) {
    const int ql = e / kLanes, l = e % kLanes;
    if (q0 + ql < b) {
      out[((size_t)sg * b + q0 + ql) * width + (size_t)j * kLanes + l] =
          best[best_at(ql, l)];
    }
  }
}

template <class Kind, int kEpi, bool kTma>
__global__ void __launch_bounds__(kThreads, 1) submax_partial(
    const __grid_constant__ Maps maps, const int8_t* __restrict__ x,
    const int8_t* __restrict__ q, const float* __restrict__ aux,
    const float* __restrict__ mask, const float* __restrict__ qs2,
    int row_bytes, int n, int b, int blk, int spb, float* __restrict__ out) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t full[kRing], empty[kRing];
  __shared__ float qsv[kGroup];
  const Ring ring{align1024(smem_raw), full, empty, kRing};
  float* best = reinterpret_cast<float*>(ring.base + kRing * kStageBytes);
  const Geometry geo = make_geometry<Kind>(row_bytes);
  const int j = blockIdx.x / spb;
  const int sg = blockIdx.x % spb;
  const int q0 = blockIdx.y * kGroup;
  const int seg_tiles = blk / spb / kTileRows;
  const int t0 = (j * blk) / kTileRows + sg * seg_tiles;
  ring_init(ring);
  for (int i = threadIdx.x; i < kGroup * kLanes; i += kThreads) {
    best[i] = -INFINITY;
  }
  for (int i = threadIdx.x; i < kGroup; i += kThreads) {
    qsv[i] = kEpi == kScaleQs && q0 + i < b ? qs2[q0 + i] : 0.0f;
  }
  __syncthreads();
  if (threadIdx.x >= kConsumers) {
    producer_regs();
    if (threadIdx.x < kConsumers + 32) {
      produce<Kind, kTma>(maps, Loads{x, q, n, b}, geo, ring, q0, t0,
                          t0 + seg_tiles, 1);
    }
  } else {
    consumer_regs();
    consume_all<Kind, kEpi>(geo, ring, aux, mask, n, b, blk, j, sg, q0,
                            t0, seg_tiles, qsv, best, out);
  }
}

__global__ void submax_reduce(const float* __restrict__ part, int spb,
                              size_t total, float* __restrict__ out) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    float m = part[i];
    for (int s = 1; s < spb; ++s) m = fmaxf(m, part[(size_t)s * total + i]);
    out[i] = m;
  }
}

}  // namespace
}  // namespace vrod

using namespace vrod;

struct LaunchSubmax {
  template <class Kind, int kEpi, bool kTma>
  static int run(const void* x, const void* aux, const void* mask,
                 const void* q, const void* qs2, int row_bytes, int n, int b,
                 int blk, int spb, int groups, void* part, void* out,
                 cudaStream_t s) {
    Maps maps{};
    if constexpr (kTma) {
      const int e = make_maps(&maps, Kind::kPacked, x, q, n, b, row_bytes);
      if (e != 0) return e;
    }
    const int smem = 1024 + kRing * kStageBytes + kBestBytes;
    auto* kern = submax_partial<Kind, kEpi, kTma>;
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    float* dst = static_cast<float*>(spb > 1 ? part : out);
    kern<<<dim3((n / blk) * spb, groups), kThreads, smem, s>>>(
        maps, static_cast<const int8_t*>(x), static_cast<const int8_t*>(q),
        static_cast<const float*>(aux), static_cast<const float*>(mask),
        static_cast<const float*>(qs2), row_bytes, n, b, blk, spb, dst);
    e = cudaGetLastError();
    if (e != cudaSuccess || spb == 1) return (int)e;
    const size_t total = (size_t)b * kLanes * (n / blk);
    const int grid = (int)std::min<size_t>(4096, (total + 255) / 256);
    submax_reduce<<<grid, 256, 0, s>>>(static_cast<const float*>(part), spb,
                                       total, static_cast<float*>(out));
    return (int)cudaGetLastError();
  }
};

// elem/epi: score.cuh's Elem and Epi codes; tma as for vrod_fused_topk.
// row_bytes: bytes per stored row (int4: dim / 2). qs2 (b,) is read by
// kScaleQs only. spb, groups: the plan (ops/cuda_topk.py: submax_plan).
extern "C" int vrod_sampled_submax(int elem, int epi, int tma, const void* x,
                                   const void* aux, const void* mask,
                                   const void* q, const void* qs2, int n,
                                   int row_bytes, int b, int blk, int spb,
                                   int groups, void* part, void* out,
                                   void* stream) {
  return dispatch_leg<LaunchSubmax>(
      elem, epi, tma != 0, x, aux, mask, q, qs2, row_bytes, n, b, blk, spb,
      groups, part, out, static_cast<cudaStream_t>(stream));
}
