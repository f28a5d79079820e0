// X1's floor variant: experiments/kexp.py, make_call("floor") ->
// build_kernel, the dots, the epilogue and each query's running max with
// no extraction. Every rank of a query returns its max over the whole
// blocks (-inf when it has no finite score), every id -1. The mode and its
// design: extract.cuh (kXFloor). Bound: K1's, the rows once.

#include "extract.cuh"

extern "C" int vrod_extract_floor(VROD_EXTRACT_PARAMS) {
  (void)variant;
  const vrod::XArgs a = VROD_EXTRACT_XARGS;
  return vrod::run_extract<vrod::kXFloor, 1, false>(elem, epi, a, merge_v,
                                                     merge_i, out_v, out_i,
                                                     stream);
}
