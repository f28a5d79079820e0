// X2's copying build (extract_carry.cu): the same kernel with the producer
// warpgroup copying each stage, for rows TMA cannot load (row bytes not a
// multiple of 16, unaligned bases). The mode: extract.cuh (kXCarry).

#include "extract.cuh"

VROD_EXTRACT_ENTRY(vrod_extract_carry_copy, vrod::kXCarry, false, false)

extern "C" int vrod_extract_carry_copy_smem(int k, int stage, int on_chip,
                                            int split) {
  return vrod::extract_smem<vrod::kXCarry, false>(k, stage, 0, on_chip,
                                                  split);
}
