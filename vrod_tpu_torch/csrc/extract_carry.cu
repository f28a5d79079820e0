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
// count. The mode: extract.cuh (kXCarry). Bound: K1's, the rows once. This
// file builds the TMA producer; rows TMA cannot load go to the copying
// build, extract_carry_copy.cu.

#include "extract.cuh"

VROD_EXTRACT_ENTRY(vrod_extract_carry, vrod::kXCarry, false, true)

// X2's whole shared memory a block at top-k with `stage` places a query,
// the carry on chip or not, in the TMA build (bytes; -1 if the card cannot
// say; the copying build's: vrod_extract_carry_copy_smem).
extern "C" int vrod_extract_carry_smem(int k, int stage, int on_chip,
                                       int split) {
  return vrod::extract_smem<vrod::kXCarry, true>(k, stage, 0, on_chip,
                                                 split);
}
