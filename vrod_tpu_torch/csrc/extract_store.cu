// X1's store variants: experiments/kexp.py, make_call("base") and
// make_call("maxref") -> build_kernel, which store the scored block to
// scratch and extract from it while the block's max beats the carried
// k-th. Here every score of a tile is stored to a score tile in shared
// memory, and each query's warp reads the query's stored scores and
// appends only those above its running k-th to its list, which is cut to
// k only when full (query groups of 64: ops/cuda_extract.py,
// store_plan). The mode and its design: extract.cuh (kXStore). Bound:
// K1's, the rows once.

#include "extract.cuh"

extern "C" int vrod_extract_store(VROD_EXTRACT_PARAMS) {
  (void)variant;
  const vrod::XArgs a = VROD_EXTRACT_XARGS;
  return vrod::run_extract<vrod::kXStore, 1, false>(elem, epi, a, merge_v,
                                                     merge_i, out_v, out_i,
                                                     stream);
}

// The store's whole shared memory a block with lists of `cap`, on chip
// or not (bytes; -1 if the card cannot say).
extern "C" int vrod_extract_store_smem(int cap, int on_chip) {
  vrod::XArgs a{};
  a.cap = cap;
  a.on_chip = on_chip;
  return vrod::narrow_need<vrod::kXStore>(a);
}
