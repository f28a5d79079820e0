// X8 and X6 (fused_theta.cuh) at f32x3: float32 rows at the precisions
// "high" and "exact" (score.cuh's F32X3, the Pallas kernels' HIGH/HIGHEST),
// in a source of their own so that nvcc compiles them beside
// fused_theta.cu's other legs. vrod_fused_theta calls this for elem
// kF32X3; its arguments are vrod_fused_theta's but elem.

#include "fused_theta.cuh"

extern "C" int vrod_fused_theta_f32x3(
    int epi, int granule, const void* x, const void* aux, const void* mask,
    const void* q, const void* qs2, const void* margin, int n,
    int row_bytes, int b, int k, int offset, int groups, int parts, int cap,
    int on_chip, int ring, int sample_tiles, int blk_tiles, int iters,
    int skip, void* sub_keys, void* bmax, void* theta0, void* cand_v,
    void* cand_i, void* cand_n, void* merge_v, void* merge_i, void* out_v,
    void* out_i, void* stream) {
  return vrod::dispatch_split<vrod::LaunchTheta>(
      epi, granule == 16, x, aux, mask, q, qs2, row_bytes, margin, n, b, k,
      offset, groups, parts, vrod::Layout{ring, cap, on_chip},
      sample_tiles, blk_tiles, iters, skip, sub_keys, bmax, theta0, cand_v,
      cand_i, cand_n, merge_v, merge_i, out_v, out_i, granule,
      static_cast<cudaStream_t>(stream));
}
