// K1: fused int8 distance scan + exact top-k, for metrics cosine and dot.
//
// Replaces the Pallas kernel vrod_tpu/ops/pallas_topk.py: fused_topk ->
// _fused_call_db -> _kernel_db (and _fused_call -> _kernel, the same math
// on the auto-pipelined grid for dims that are not a multiple of 128).
//
// What bounds it on an H100: at 1M x 768 and B = 256 a search must read
// 805 MB of int8 rows (0.24 ms at 3.35 TB/s) and do 2*B*N*D = 412 G integer
// operations (0.21 ms at the tensor cores' 1,979 TOP/s), so bytes bound it,
// with the operations close behind. The design: the dots run on the tensor
// cores (mma.sync s8, score.cuh); the query tiles of one row chunk run as
// neighbouring blocks, so L2 serves most of their re-reads of the chunk;
// and the (B, N) score matrix never reaches device memory: scores live in
// shared memory for one 512-row sub-chunk at a time, and only candidates
// that beat the running k-th score (or the sampled floor theta0) are
// written out.
//
// The TPU kernel walks the row blocks in order on one core and carries its
// top-k in VMEM. Blocks on a GPU run in parallel and in no order, so:
//   1. fused_topk_local: block (c, t) scores row chunk c against query tile
//      t and keeps, per query, the chunk's top-k as an unordered list in
//      global scratch. After each sub-chunk the new candidates (score >
//      max(theta0, list's k-th)) are appended and, once the list holds k or
//      more, cut back to exactly k by a counting select.
//   2. fused_topk_merge: one warp per query gathers the chunk lists, cuts
//      them to k, and ranks the survivors by (value desc, slot asc).
// The select is exact and independent of scheduling: the k-th key is found
// by radix lifting over order-isomorphic int32 keys (the method of
// distances.kth_largest_count), and ties at the k-th value are broken by
// the m-th smallest slot, found the same way. The result is the top-k of
// {slots with score > theta0} in (value desc, slot asc) order, with
// (-inf, -1) on empty ranks: the Pallas kernel's contract.

#include <algorithm>
#include <climits>
#include <cmath>

#include "score.cuh"

namespace vrod {
namespace {

constexpr int kSub = 512;                // rows scored between selections
// Score row stride: 520 = 8 (mod 32) keeps a warp's stores of one
// accumulator (eight queries x eight rows) to two-way bank conflicts; a
// stride of kSub would put all eight queries in one bank.
constexpr int kScSt = kSub + 8;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ unsigned lanemask_lt() {
  return (1u << (threadIdx.x & 31)) - 1u;
}

__device__ __forceinline__ float key_float(int key) {
  return __int_as_float(key ^ ((key >> 31) & 0x7fffffff));
}

__device__ int warp_count_ge(const float* v, int n, int key) {
  int c = 0;
  for (int e = threadIdx.x & 31; e < n; e += 32) c += float_key(v[e]) >= key;
  return __reduce_add_sync(kFull, c);
}

__device__ int warp_count_gt(const float* v, int n, int key) {
  int c = 0;
  for (int e = threadIdx.x & 31; e < n; e += 32) c += float_key(v[e]) > key;
  return __reduce_add_sync(kFull, c);
}

__device__ int warp_count_tie_le(const float* v, const int* ix, int n,
                                 int key, int bound) {
  int c = 0;
  for (int e = threadIdx.x & 31; e < n; e += 32) {
    c += float_key(v[e]) == key && ix[e] <= bound;
  }
  return __reduce_add_sync(kFull, c);
}

// Keep the k best of (v, ix)[0, n), n >= k, by (value desc, index asc),
// compacted in place into [0, k) in no particular order. Indices must be
// distinct and non-negative. Returns the key of the k-th best value. Called
// by a whole warp with warp-uniform arguments.
__device__ int warp_select(float* v, int* ix, int n, int k) {
  __syncwarp();
  int kth = warp_count_ge(v, n, 0) >= k ? 0 : INT_MIN;
  for (int i = 30; i >= 0; --i) {
    const int cand = kth + (1 << i);
    if (warp_count_ge(v, n, cand) >= k) kth = cand;
  }
  const int m = k - warp_count_gt(v, n, kth);  // ties to keep, >= 1
  int lim = -1;  // largest bound with fewer than m ties at or below it
  for (int i = 30; i >= 0; --i) {
    const int cand = lim + (1 << i);
    if (warp_count_tie_le(v, ix, n, kth, cand) < m) lim = cand;
  }
  lim += 1;  // the m-th smallest index among the ties
  int w = 0;
  for (int base = 0; base < n; base += 32) {
    const int e = base + (threadIdx.x & 31);
    float val = 0.0f;
    int id = 0;
    bool keep = false;
    if (e < n) {
      val = v[e];
      id = ix[e];
      const int kk = float_key(val);
      keep = kk > kth || (kk == kth && id <= lim);
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
  return kth;
}

__global__ void __launch_bounds__(kThreads) fused_topk_local(
    const int8_t* __restrict__ x, const float* __restrict__ aux,
    const float* __restrict__ mask, const int8_t* __restrict__ q,
    const float* __restrict__ theta0, int n, int d, int b, int k,
    int offset, int chunk_rows, int cap, bool vec16,
    float* __restrict__ cand_v, int* __restrict__ cand_i,
    int* __restrict__ cand_n) {
  __shared__ __align__(16) int qs[kQT * kSt];
  __shared__ __align__(16) int xs[kTR * kSt];
  __shared__ float tau[kQT];  // k-th score of a full list, else -inf
  __shared__ int len[kQT];
  extern __shared__ float sc[];  // kQT x kScSt scores of one sub-chunk

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int chunk = blockIdx.y;
  const int q0 = blockIdx.x * kQT;
  const int row_begin = chunk * chunk_rows;
  const int row_end = min(n, row_begin + chunk_rows);
  if (tid < kQT) {
    tau[tid] = -INFINITY;
    len[tid] = 0;
  }
  for (int s0 = row_begin; s0 < row_end; s0 += kSub) {
    const int sub_end = min(row_end, s0 + kSub);
    scan_dots(x, q, sub_end, b, d, s0, sub_end, q0, vec16, qs, xs,
              [&](int r0, const int (&acc)[kAcc]) {
#pragma unroll
                for (int i = 0; i < kAcc; ++i) {
                  const int gr = r0 + acc_row(i);
                  if (gr < sub_end) {
                    sc[acc_query(i) * kScSt + (gr - s0)] =
                        score_epilogue(acc[i], aux[gr], mask[gr]);
                  }
                }
              });
    __syncthreads();
    const int sub_n = sub_end - s0;
    for (int ql = warp; ql < kQT; ql += kWarps) {
      const int qq = q0 + ql;
      if (qq >= b) break;  // warp-uniform
      const float thr = fmaxf(theta0[qq], tau[ql]);
      const size_t list = ((size_t)chunk * b + qq) * cap;
      float* lv = cand_v + list;
      int* li = cand_i + list;
      const int len0 = len[ql];
      int L = len0;
      for (int base = 0; base < sub_n; base += 32) {
        const int e = base + lane;
        const float s = e < sub_n ? sc[ql * kScSt + e] : -INFINITY;
        const bool take = s > thr;
        const unsigned msk = __ballot_sync(kFull, take);
        if (take) {
          const int p = L + __popc(msk & lanemask_lt());
          lv[p] = s;
          li[p] = s0 + e + offset;
        }
        L += __popc(msk);
      }
      if (L > len0 && L >= k) {
        const int kth = warp_select(lv, li, L, k);
        L = k;
        if (lane == 0) tau[ql] = key_float(kth);
      }
      if (lane == 0) len[ql] = L;
      __syncwarp();
    }
    __syncthreads();  // sc, tau and len are read again below or next round
  }
  if (tid < kQT && q0 + tid < b) {
    cand_n[(size_t)chunk * b + q0 + tid] = len[tid];
  }
}

__global__ void __launch_bounds__(kThreads) fused_topk_merge(
    const float* __restrict__ cand_v, const int* __restrict__ cand_i,
    const int* __restrict__ cand_n, int nchunks, int cap, int b, int k,
    float* __restrict__ merge_v, int* __restrict__ merge_i,
    float* __restrict__ out_v, int* __restrict__ out_i) {
  const int lane = threadIdx.x & 31;
  const int qq = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (qq >= b) return;  // whole warp
  float* gv = merge_v + (size_t)qq * nchunks * k;
  int* gi = merge_i + (size_t)qq * nchunks * k;
  int n = 0;
  for (int c = 0; c < nchunks; ++c) {
    const int L = cand_n[(size_t)c * b + qq];
    const size_t list = ((size_t)c * b + qq) * cap;
    for (int e = lane; e < L; e += 32) {
      gv[n + e] = cand_v[list + e];
      gi[n + e] = cand_i[list + e];
    }
    n += L;
  }
  if (n > k) {
    warp_select(gv, gi, n, k);
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

// Chunking for n rows, b queries, top-k: out = {nchunks, chunk_rows, cap}.
// About four local blocks per SM (two fit at once), whole row tiles per
// chunk, and a list capacity of k plus one sub-chunk of new candidates.
extern "C" int vrod_fused_topk_plan(int n, int b, int k, int* out) {
  int dev = 0;
  int sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int qtiles = (b + kQT - 1) / kQT;
  const int target = std::max(1, 4 * sms / qtiles);
  int nchunks = std::min(target, std::max(1, (n + kSub - 1) / kSub));
  int chunk_rows = (n + nchunks - 1) / nchunks;
  chunk_rows = std::max(kTR, (chunk_rows + kTR - 1) / kTR * kTR);
  nchunks = std::max(1, (n + chunk_rows - 1) / chunk_rows);
  out[0] = nchunks;
  out[1] = chunk_rows;
  out[2] = k + kSub;
  return 0;
}

extern "C" int vrod_fused_topk_i8(
    const void* x, const void* aux, const void* mask, const void* q,
    const void* theta0, int n, int d, int b, int k, int offset, int nchunks,
    int chunk_rows, int cap, void* cand_v, void* cand_i, void* cand_n,
    void* merge_v, void* merge_i, void* out_v, void* out_i, void* stream) {
  const int smem = (int)(sizeof(float) * kQT * kScSt);
  cudaError_t e = cudaFuncSetAttribute(
      fused_topk_local, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const bool vec16 = d % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(q) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // The query tiles of a chunk are neighbouring blocks (x varies fastest).
  fused_topk_local<<<dim3((b + kQT - 1) / kQT, nchunks), kThreads, smem, s>>>(
      static_cast<const int8_t*>(x), static_cast<const float*>(aux),
      static_cast<const float*>(mask), static_cast<const int8_t*>(q),
      static_cast<const float*>(theta0), n, d, b, k, offset, chunk_rows, cap,
      vec16, static_cast<float*>(cand_v), static_cast<int*>(cand_i),
      static_cast<int*>(cand_n));
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  fused_topk_merge<<<(b + kWarps - 1) / kWarps, kThreads, 0, s>>>(
      static_cast<const float*>(cand_v), static_cast<const int*>(cand_i),
      static_cast<const int*>(cand_n), nchunks, cap, b, k,
      static_cast<float*>(merge_v), static_cast<int*>(merge_i),
      static_cast<float*>(out_v), static_cast<int*>(out_i));
  return (int)cudaGetLastError();
}
