// X4's copying build (extract_unroll.cu): the same kernels (kE = 2, 4)
// with the producer warpgroup copying each stage, for rows TMA cannot load
// (row bytes not a multiple of 16, unaligned bases). The mode: extract.cuh
// (kXGate, kE = variant).

#include "extract.cuh"

VROD_EXTRACT_ENTRY(vrod_extract_unroll_copy, vrod::kXGate, true, false)
