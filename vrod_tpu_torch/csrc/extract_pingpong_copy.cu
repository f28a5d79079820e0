// X3's copying build (extract_pingpong.cu): the same kernel with the
// producer warpgroup copying each stage, in the ring's order, for rows TMA
// cannot load (row bytes not a multiple of 16, unaligned bases). The
// mode: extract.cuh (kXPingPong).

#include "extract.cuh"

VROD_EXTRACT_ENTRY(vrod_extract_pingpong_copy, vrod::kXPingPong, false, false)
