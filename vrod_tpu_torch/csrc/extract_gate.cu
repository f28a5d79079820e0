// X1's gated variants, experiments/kexp.py make_call("gate", "nostore",
// "argmax", "subdot") -> build_kernel, and X4's nostore,
// experiments/kexp5.py make_call("nostore"). On the TPU those names differ
// in whether Mosaic stores the scores and how it finds the argmax; on the
// H100 every score stays in the register that holds its dot, so they share
// this build. Query groups of 64 (wgmma n64); each score is held against
// its query's k-th (the value the last cut of its list left, in
// registers) and the passing ones are appended, by warp-aggregated counts,
// to the query's list in shared memory beside the ring (ops/cuda_extract.py:
// gate_plan; global memory past the k where the lists no longer fit). One
// vote barrier a tile; a list is cut, by the warp that owns its query, only
// when a tile's passing scores found it full. The mode: extract.cuh
// (kXGate, kE = 1). Bound: K1's, the rows once.
// This file builds the TMA producer; rows TMA cannot load go to the
// copying build, extract_gate_copy.cu.

#include "extract.cuh"

VROD_EXTRACT_ENTRY(vrod_extract_gate, vrod::kXGate, false, true)

// The gated modes' whole shared memory a block with lists of `cap`, on
// chip or not, in the TMA build (bytes; -1 if the card cannot say; the
// copying build's: vrod_extract_gate_copy_smem). X3 and X4 declare the
// same shared arrays.
extern "C" int vrod_extract_gate_smem(int cap, int on_chip, int split) {
  return vrod::extract_smem<vrod::kXGate, true>(0, 0, cap, on_chip, split);
}
