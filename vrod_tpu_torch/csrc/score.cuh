// Shared scoring for the fused top-k scan (K1, fused_topk.cu) and the
// sampled sub-max pre-pass (K3, sampled_submax.cu).
//
// Both kernels score int8 rows against an int8-quantized query tile with
// the SAME device code, so their scores agree bit for bit: the engine's
// sampled floor is sound only if K3's sub-maxima are true elements of K1's
// score space (vrod_tpu/engine.py:191-202).
//
// Score of query q against row r (metrics cosine and dot):
//   g = sum_d q[d] * x[r, d]              exact int32 (|g| <= 127*127*1040 < 2^24)
//   s = float(g) * aux[r] + mask[r]        two IEEE ops, each rounded once
// mask is 0 on live slots and -inf on dead ones. The multiply and the add
// use __fmul_rn/__fadd_rn, which the compiler never contracts into an FMA.
//
// The integer dots run on the tensor cores: mma.sync m16n8k32 with s8
// inputs and s32 accumulators, which is exact, so the order of the sums
// does not matter. A block scores a tile of kQT = 32 queries (two m16
// tiles) against kTR = 64 rows (eight n8 tiles, one per warp), walking the
// dim in slices of 256 bytes staged through shared memory.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace vrod {

constexpr int kThreads = 256;               // threads per block, every kernel
constexpr int kQT = 32;                     // queries per tile
constexpr int kTR = 64;                     // rows per score tile
constexpr int kAcc = 8;                     // scores per thread per tile
constexpr int kSliceUnits = 16;             // 16-byte units of dim per slice
// Shared-memory row stride in 4-byte words: 68 = 4 (mod 32), so the eight
// rows and four words of one fragment load fall in 32 distinct banks.
constexpr int kSt = kSliceUnits * 4 + 4;

static_assert(kThreads / 32 * 8 == kTR, "one n8 tile of rows per warp");
static_assert(kQT == 32 && kAcc == 8, "two m16 tiles of queries");

// Order-isomorphic int32 key of a float: a < b  <=>  key(a) < key(b).
// The same map as distances.kth_largest_count; -0.0 folds onto +0.0.
__device__ __forceinline__ int float_key(float f) {
  if (f == 0.0f) f = 0.0f;
  const int b = __float_as_int(f);
  return b ^ ((b >> 31) & 0x7fffffff);
}

__device__ __forceinline__ float score_epilogue(int g, float aux,
                                                float mask) {
  return __fadd_rn(__fmul_rn(__int2float_rn(g), aux), mask);
}

// Where score acc[i] of this thread lies in the tile: the accumulator
// layout of mma m16n8k32 (lane = 4 * group + t holds rows 2t, 2t + 1 of its
// warp's n8 tile, for queries group and group + 8 of each m16 tile).
__device__ __forceinline__ int acc_row(int i) {
  return (threadIdx.x >> 5) * 8 + 2 * (threadIdx.x & 3) + (i & 1);
}

__device__ __forceinline__ int acc_query(int i) {
  return (i >> 2) * 16 + ((threadIdx.x & 31) >> 2) + (i & 2) * 4;
}

// One 16-byte unit (dims unit*16 ..) of row gr of a (.., d) int8 matrix.
// Rows at or past row_end and bytes past d read as zero, so they add
// nothing to a dot. vec16: d % 16 == 0 and the base is 16-byte aligned.
__device__ __forceinline__ int4 load_unit(const int8_t* src, int gr,
                                          int row_end, int d, int unit,
                                          bool vec16) {
  const int lim = d - unit * 16;  // bytes of this unit inside the row
  if (gr >= row_end || lim <= 0) return make_int4(0, 0, 0, 0);
  const int8_t* p = src + (size_t)gr * d + (size_t)unit * 16;
  if (vec16) return *reinterpret_cast<const int4*>(p);
  unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    if (i < lim) w[i >> 2] |= (unsigned)(uint8_t)p[i] << ((i & 3) * 8);
  }
  return make_int4((int)w[0], (int)w[1], (int)w[2], (int)w[3]);
}

// This thread's share of one slice (kSliceUnits units of dim) of the query
// tile and of the row tile, held in registers between its load and its
// store to shared memory. Element e = threadIdx.x + p * kThreads is unit
// e % kSliceUnits of tile row e / kSliceUnits.
constexpr int kQUnits = kQT * kSliceUnits / kThreads;  // 2
constexpr int kXUnits = kTR * kSliceUnits / kThreads;  // 4

struct Slice {
  int4 q[kQUnits];
  int4 x[kXUnits];
};

// Issue every load of a slice before any is used, so their latencies
// overlap (the stores wait in store_slice).
__device__ __forceinline__ void load_slice(Slice& s, const int8_t* x,
                                           const int8_t* q, int r0,
                                           int row_end, int b, int q0, int d,
                                           int u0, bool vec16) {
#pragma unroll
  for (int p = 0; p < kQUnits; ++p) {
    const int e = threadIdx.x + p * kThreads;
    s.q[p] = load_unit(q, q0 + e / kSliceUnits, b, d,
                       u0 + e % kSliceUnits, vec16);
  }
#pragma unroll
  for (int p = 0; p < kXUnits; ++p) {
    const int e = threadIdx.x + p * kThreads;
    s.x[p] = load_unit(x, r0 + e / kSliceUnits, row_end, d,
                       u0 + e % kSliceUnits, vec16);
  }
}

__device__ __forceinline__ void store_slice(const Slice& s, int* qs,
                                            int* xs) {
#pragma unroll
  for (int p = 0; p < kQUnits; ++p) {
    const int e = threadIdx.x + p * kThreads;
    *reinterpret_cast<int4*>(qs + e / kSliceUnits * kSt
                             + e % kSliceUnits * 4) = s.q[p];
  }
#pragma unroll
  for (int p = 0; p < kXUnits; ++p) {
    const int e = threadIdx.x + p * kThreads;
    *reinterpret_cast<int4*>(xs + e / kSliceUnits * kSt
                             + e % kSliceUnits * 4) = s.x[p];
  }
}

// c += a (16 x 32 s8, row-major fragment) * b (32 x 8 s8, column fragment).
__device__ __forceinline__ void mma_s8(int (&c)[4], int a0, int a1, int a2,
                                       int a3, int b0, int b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Integer dots of query tile [q0, q0 + kQT) with the rows [r_begin, r_end)
// (rows at or past row_end score as zero rows), one row tile of kTR rows at
// a time: for each tile, epi(r0, acc) gets acc[i], the dot of query
// q0 + acc_query(i) with row r0 + acc_row(i). The dim is walked in slices
// of kSliceUnits units staged through qs (kQT * kSt words) and xs (kTR *
// kSt words), 16-byte aligned shared buffers; the next slice's loads are in
// flight while the tensor cores work on the current one. Every thread of
// the block must call this (it synchronizes).
template <class Epilogue>
__device__ __forceinline__ void scan_dots(const int8_t* x, const int8_t* q,
                                          int row_end, int b, int d,
                                          int r_begin, int r_end, int q0,
                                          bool vec16, int* qs, int* xs,
                                          Epilogue&& epi) {
  const int units = (d + 15) / 16;
  const int slices = (units + kSliceUnits - 1) / kSliceUnits;
  const int steps = (r_end - r_begin + kTR - 1) / kTR * slices;
  const int lane = threadIdx.x & 31;
  const int* xf = xs + ((threadIdx.x >> 5) * 8 + (lane >> 2)) * kSt
                  + (lane & 3);
  const int* qf = qs + (lane >> 2) * kSt + (lane & 3);
  int c0[4] = {0, 0, 0, 0};  // queries 0-15 of the tile
  int c1[4] = {0, 0, 0, 0};  // queries 16-31
  Slice next;
  if (steps > 0) {
    load_slice(next, x, q, r_begin, row_end, b, q0, d, 0, vec16);
  }
  for (int st = 0; st < steps; ++st) {
    const int r0 = r_begin + st / slices * kTR;
    const int u0 = st % slices * kSliceUnits;
    __syncthreads();  // the previous slice is consumed
    store_slice(next, qs, xs);
    __syncthreads();
    if (st + 1 < steps) {
      load_slice(next, x, q, r_begin + (st + 1) / slices * kTR, row_end, b,
                 q0, d, (st + 1) % slices * kSliceUnits, vec16);
    }
    // Whole 32-byte k-steps: an odd last unit meets a zero one after it.
    const int ksteps = (min(kSliceUnits, units - u0) + 1) / 2;
    for (int s = 0; s < ksteps; ++s) {
      const int w = s * 8;
      const int b0 = xf[w];
      const int b1 = xf[w + 4];
      mma_s8(c0, qf[w], qf[w + 8 * kSt], qf[w + 4], qf[w + 8 * kSt + 4],
             b0, b1);
      mma_s8(c1, qf[w + 16 * kSt], qf[w + 24 * kSt], qf[w + 16 * kSt + 4],
             qf[w + 24 * kSt + 4], b0, b1);
    }
    if (u0 + kSliceUnits >= units) {  // the tile's last slice
      const int acc[kAcc] = {c0[0], c0[1], c0[2], c0[3],
                             c1[0], c1[1], c1[2], c1[3]};
      epi(r0, acc);
#pragma unroll
      for (int i = 0; i < 4; ++i) c0[i] = c1[i] = 0;
    }
  }
}

}  // namespace vrod
