// X2: experiments/kexp2.py, make_call(tiles=), which carries each query
// tile's running top-k as loop values through one while loop per tile and
// counts the loop's iterations (KEXP_COUNT=1). Here each query's running
// top-k of exactly k (value, slot) pairs is carried sorted in shared
// memory (query groups of 64: ops/cuda_extract.py, carry_plan),
// updated in place with no lock: per tile the scores above the carried
// k-th are staged per query, and the warp that owns the query merges its
// stage into the carry. With `count` one part per query group walks the
// rows in order and writes, per whole block and query, the carry entries
// that block holds after it; ops/cuda_extract.py turns those into kexp2's
// count. The mode: extract.cuh (kXCarry). Bound: K1's, the rows once.

#include "extract.cuh"

extern "C" int vrod_extract_carry(VROD_EXTRACT_PARAMS) {
  (void)variant;
  const vrod::XArgs a = VROD_EXTRACT_XARGS;
  return vrod::run_extract<vrod::kXCarry, 1, false>(elem, epi, a, merge_v,
                                                     merge_i, out_v, out_i,
                                                     stream);
}

// X2's whole shared memory a block at top-k with `stage` places a query,
// the carry on chip or not (bytes; -1 if the card cannot say).
extern "C" int vrod_extract_carry_smem(int k, int stage, int on_chip) {
  vrod::XArgs a{};
  a.k = k;
  a.stage = stage;
  a.on_chip = on_chip;
  return vrod::narrow_need<vrod::kXCarry>(a);
}
