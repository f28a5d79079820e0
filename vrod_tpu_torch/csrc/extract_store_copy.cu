// X1 store's copying build (extract_store.cu): the same kernel with the
// producer warpgroup copying each stage, for rows TMA cannot load (row
// bytes not a multiple of 16, unaligned bases). The mode: extract.cuh
// (kXStore).

#include "extract.cuh"

VROD_EXTRACT_ENTRY(vrod_extract_store_copy, vrod::kXStore, false, false)

extern "C" int vrod_extract_store_copy_smem(int cap, int on_chip,
                                          int split) {
  return vrod::extract_smem<vrod::kXStore, false>(0, 0, cap, on_chip, split);
}
