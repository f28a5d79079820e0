// X2: experiments/kexp2.py, make_call(tiles=), which carries each query
// tile's running top-k as loop values through one while loop per tile and
// counts the loop's iterations (KEXP_COUNT=1). Here each query's running
// top-k of exactly k (value, slot) pairs is carried sorted, in shared
// memory beside a 3-stage ring when 256 x k x 8 bytes fit (k <= 33), else
// in global memory beside a 4-stage ring (L2 holds it); a passing score is
// inserted in place by a whole warp. With `count` one part per query group walks the rows
// in order and writes, per whole block and query, the carry entries that
// block holds after it; ops/cuda_extract.py turns those into kexp2's count.
// The mode: extract.cuh (kXCarry). Bound: K1's.

#include "extract.cuh"

extern "C" int vrod_extract_carry(VROD_EXTRACT_PARAMS) {
  (void)variant;
  const vrod::XArgs a = VROD_EXTRACT_XARGS;
  return vrod::run_extract<vrod::kXCarry, 1, false>(elem, epi, a, merge_v,
                                                     merge_i, out_v, out_i,
                                                     stream);
}
