// X1's store variants: experiments/kexp.py, make_call("base") and
// make_call("maxref") -> build_kernel, which store the scored block to
// scratch and extract from it while the block's max beats the carried
// k-th. Here every score of a tile is stored to a score tile in shared
// memory, and each query's warp reads the query's stored scores and
// appends only those above its running k-th to its list, which is cut to
// k only when full (query groups of 64: ops/cuda_extract.py,
// store_plan). The mode and its design: extract.cuh (kXStore). Bound:
// K1's, the rows once.
// This file builds the TMA producer; rows TMA cannot load go to the
// copying build, extract_store_copy.cu.

#include "extract.cuh"

VROD_EXTRACT_ENTRY(vrod_extract_store, vrod::kXStore, false, true)

// The store's whole shared memory a block with lists of `cap`, on chip
// or not, in the TMA build (bytes; -1 if the card cannot say; the copying
// build's: vrod_extract_store_copy_smem).
extern "C" int vrod_extract_store_smem(int cap, int on_chip, int split) {
  return vrod::extract_smem<vrod::kXStore, true>(0, 0, cap, on_chip, split);
}
