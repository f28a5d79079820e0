// X8 and X6 (fused_theta.cuh): the entry point, and the int8, int4,
// bfloat16 and TF32 legs; the f32x3 legs are built in fused_theta_f32x3.cu.

#include "fused_theta.cuh"

// The f32x3 legs (fused_theta_f32x3.cu), with vrod_fused_theta's
// arguments but elem.
extern "C" int vrod_fused_theta_f32x3(
    int epi, int granule, const void* x, const void* aux, const void* mask,
    const void* q, const void* qs2, const void* margin, int n,
    int row_bytes, int b, int k, int offset, int groups, int parts, int cap,
    int on_chip, int ring, int sample_tiles, int blk_tiles, int iters,
    int skip, void* sub_keys, void* bmax, void* theta0, void* cand_v,
    void* cand_i, void* cand_n, void* merge_v, void* merge_i, void* out_v,
    void* out_i, void* stream);

// elem, epi, granule, x, aux, mask, q, qs2, row_bytes, offset, groups,
// parts, cap, on_chip, ring and the candidate and merge buffers as for
// vrod_fused_topk (the lists (parts, b, k) when on chip, else (parts, b,
// cap); f32x3: q is (b, 2 * dim), the query's TF32 big parts then its
// small parts). margin (b,): theta0 = floor - margin. The sample is rows
// [0, sample_tiles * 128) in blocks of blk_tiles tiles (ops/cuda_floor.py:
// theta_plan); iters bisection steps; skip: skip_sample_dots. Scratch
// sub_keys (b, 128 * sample_tiles / blk_tiles) int32 and bmax (b,
// sample_tiles / blk_tiles); theta0 (b,) is written.
extern "C" int vrod_fused_theta(
    int elem, int epi, int granule, const void* x, const void* aux,
    const void* mask, const void* q, const void* qs2, const void* margin,
    int n, int row_bytes, int b, int k, int offset, int groups, int parts,
    int cap, int on_chip, int ring, int sample_tiles, int blk_tiles,
    int iters, int skip, void* sub_keys,
    void* bmax, void* theta0, void* cand_v, void* cand_i, void* cand_n,
    void* merge_v, void* merge_i, void* out_v, void* out_i, void* stream) {
  if (elem == vrod::kF32X3) {
    return vrod_fused_theta_f32x3(
        epi, granule, x, aux, mask, q, qs2, margin, n, row_bytes, b, k,
        offset, groups, parts, cap, on_chip, ring, sample_tiles, blk_tiles,
        iters, skip, sub_keys, bmax, theta0, cand_v, cand_i, cand_n, merge_v,
        merge_i, out_v, out_i, stream);
  }
  return vrod::dispatch_leg<vrod::LaunchTheta>(
      elem, epi, granule == 16, x, aux, mask, q, qs2, row_bytes, margin, n,
      b, k, offset, groups, parts, vrod::Layout{ring, cap, on_chip},
      sample_tiles, blk_tiles,
      iters, skip, sub_keys, bmax, theta0, cand_v, cand_i, cand_n, merge_v,
      merge_i, out_v, out_i, granule, static_cast<cudaStream_t>(stream));
}
