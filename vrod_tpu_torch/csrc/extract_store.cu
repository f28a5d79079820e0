// X1's store variants: experiments/kexp.py, make_call("base") and
// make_call("maxref") -> build_kernel, which store the scored block and
// extract from it. Here: no register gate; every finite score of a tile is
// appended to its query's list, and the lists are cut back to k after each
// tile. The mode and its design: extract.cuh (kXStore). Bound: K1's.

#include "extract.cuh"

extern "C" int vrod_extract_store(VROD_EXTRACT_PARAMS) {
  (void)variant;
  const vrod::XArgs a = VROD_EXTRACT_XARGS;
  return vrod::run_extract<vrod::kXStore, 1, false>(elem, epi, a, merge_v,
                                                     merge_i, out_v, out_i,
                                                     stream);
}
