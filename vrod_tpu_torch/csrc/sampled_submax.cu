// K3: sampled sub-max pre-pass, every leg of the TPU kernel (int8, packed
// int4, bfloat16 and float32 rows; metrics cosine, dot and l2).
//
// Replaces the Pallas kernel vrod_tpu/ops/pallas_topk.py: sampled_submax ->
// _submax_kernel. Scores a prefix sample of the rows with K1's own scoring
// code (score.cuh, so the two agree bit for bit) and emits, for every row
// block of blk rows, 128 strided group maxima: lane t of block j is the max
// over rows j*blk + t, j*blk + t + 128, ... Output (B, 128 * n / blk) f32,
// the layout of the TPU kernel.
//
// What bounds it on an H100: at the int8 headline the sample is 25 MB of
// rows (32,768 x 768: 7.5 us at 3.35 TB/s) and 12.9 G integer operations
// for B = 256 (6.5 us on the tensor cores; the float legs' larger samples
// scale both), so with so little work what bounds it is parallelism. The
// TPU grid is (query tiles, row blocks): only two row blocks at the int8
// headline. Here each row block is further split into spb segments of
// whole 128-row groups, so the grid fills the SMs; each block keeps its
// 32 x 128 running maxima in shared memory, and when spb > 1 a second pass
// takes the max over the segments' partial results (max is exact, so the
// order does not matter).

#include <algorithm>

#include "score.cuh"

namespace vrod {
namespace {

constexpr int kLanes = 128;
constexpr int kBestSt = kLanes + 8;  // row stride of best: fewer conflicts

template <class Kind, int kEpi, bool kVec>
__global__ void __launch_bounds__(kThreads) submax_partial(
    const int8_t* __restrict__ x, const int8_t* __restrict__ q,
    const float* __restrict__ aux, const float* __restrict__ mask,
    const float* __restrict__ qs2, int row_bytes, int n, int b, int blk,
    int seg_rows, int spb, float* __restrict__ out) {
  const Operands op = make_operands<Kind>(x, q, aux, mask, qs2, row_bytes);
  __shared__ __align__(16) int qs[kQT * kSt];
  __shared__ __align__(16) int xs[kTR * kSt];
  // Segments start on whole 128-row groups and row tiles are kTR = 64 rows,
  // so tile row t always feeds lane t or t + 64: the thread that owns
  // (query, tile row) in the accumulator layout alone owns those two lanes.
  __shared__ float best[kQT * kBestSt];
  const int j = blockIdx.x / spb;
  const int sg = blockIdx.x % spb;
  const int q0 = blockIdx.y * kQT;
  const int blk_start = j * blk;
  const int r_begin = blk_start + sg * seg_rows;
  const int r_end = r_begin + seg_rows;
#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    best[acc_query(i) * kBestSt + acc_row(i)] = -INFINITY;
    best[acc_query(i) * kBestSt + acc_row(i) + kTR] = -INFINITY;
  }
  scan_dots<Kind, kVec>(op, n, b, r_begin, r_end, q0, qs, xs,
                  [&](int r0, const auto& acc) {
#pragma unroll
                    for (int i = 0; i < kAcc; ++i) {
                      const int gr = r0 + acc_row(i);
                      const int ql = acc_query(i);
                      float* m = &best[ql * kBestSt
                                       + (gr - blk_start) % kLanes];
                      *m = fmaxf(*m, score_epilogue<kEpi>(
                                         op, dot_value(acc[i]), gr,
                                         min(q0 + ql, b - 1)));
                    }
                  });
  const size_t width = (size_t)kLanes * (n / blk);
#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    const int qq = q0 + acc_query(i);
    if (qq < b) {
      const int t = acc_row(i);
      float* o = out + ((size_t)sg * b + qq) * width + (size_t)j * kLanes;
      o[t] = best[acc_query(i) * kBestSt + t];
      o[t + kTR] = best[acc_query(i) * kBestSt + t + kTR];
    }
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

// Segments per row block: a power of two dividing blk / 128, up to about
// four blocks per SM over the whole grid.
extern "C" int vrod_sampled_submax_plan(int n, int b, int blk, int* spb_out) {
  int dev = 0;
  int sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int grid = (n / blk) * ((b + kQT - 1) / kQT);
  const int target = std::max(1, 4 * sms / std::max(1, grid));
  int spb = 1;
  while (spb * 2 <= target && (blk / kLanes) % (spb * 2) == 0) spb *= 2;
  *spb_out = spb;
  return 0;
}

struct LaunchSubmax {
  template <class Kind, int kEpi, bool kVec>
  static int run(const void* x, const void* aux, const void* mask,
                 const void* q, const void* qs2, int row_bytes, int n, int b,
                 int blk, int spb, void* part, void* out, cudaStream_t s) {
    float* dst = static_cast<float*>(spb > 1 ? part : out);
    submax_partial<Kind, kEpi, kVec>
        <<<dim3((n / blk) * spb, (b + kQT - 1) / kQT), kThreads, 0, s>>>(
            static_cast<const int8_t*>(x), static_cast<const int8_t*>(q),
            static_cast<const float*>(aux), static_cast<const float*>(mask),
            static_cast<const float*>(qs2), row_bytes, n, b, blk, blk / spb,
            spb, dst);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess || spb == 1) return (int)e;
    const size_t total = (size_t)b * kLanes * (n / blk);
    const int grid = (int)std::min<size_t>(4096, (total + 255) / 256);
    submax_reduce<<<grid, 256, 0, s>>>(static_cast<const float*>(part), spb,
                                       total, static_cast<float*>(out));
    return (int)cudaGetLastError();
  }
};

// elem/epi: score.cuh's Elem and Epi codes. row_bytes: bytes per stored
// row (int4: dim / 2). qs2 (b,) is read by kScaleQs only.
extern "C" int vrod_sampled_submax(int elem, int epi, const void* x,
                                   const void* aux, const void* mask,
                                   const void* q, const void* qs2, int n,
                                   int row_bytes, int b, int blk, int spb,
                                   void* part, void* out, void* stream) {
  return dispatch_leg<LaunchSubmax>(
      elem, epi, vector_units(x, q, row_bytes), x, aux, mask, q, qs2,
      row_bytes, n, b, blk, spb, part, out, static_cast<cudaStream_t>(stream));
}
