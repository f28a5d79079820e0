// X1's floor variant: experiments/kexp.py, make_call("floor") ->
// build_kernel, the dots, the epilogue and each query's running max with
// no extraction. Every rank of a query returns its max over the whole
// blocks (-inf when it has no finite score), every id -1. The mode and its
// design: extract.cuh (kXFloor). Bound: K1's, the rows once. This file
// builds the TMA producer; rows TMA cannot load go to the copying build,
// extract_floor_copy.cu.

#include "extract.cuh"

VROD_EXTRACT_ENTRY(vrod_extract_floor, vrod::kXFloor, false, true)
