// X1 floor's copying build (extract_floor.cu): the same kernel with the
// producer warpgroup copying each stage (a 256-query box), for rows TMA
// cannot load (row bytes not a multiple of 16, unaligned bases). The mode:
// extract.cuh (kXFloor).

#include "extract.cuh"

VROD_EXTRACT_ENTRY(vrod_extract_floor_copy, vrod::kXFloor, false, false)
