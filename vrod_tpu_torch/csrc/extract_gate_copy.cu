// X1 gate's copying build (extract_gate.cu, which X4's nostore shares):
// the same kernel with the producer warpgroup copying each stage, for rows
// TMA cannot load (row bytes not a multiple of 16, unaligned bases). The
// mode: extract.cuh (kXGate, kE = 1).

#include "extract.cuh"

VROD_EXTRACT_ENTRY(vrod_extract_gate_copy, vrod::kXGate, false, false)

extern "C" int vrod_extract_gate_copy_smem(int cap, int on_chip,
                                          int split) {
  return vrod::extract_smem<vrod::kXGate, false>(0, 0, cap, on_chip, split);
}
