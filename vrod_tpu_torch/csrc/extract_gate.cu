// X1's gated variants, experiments/kexp.py make_call("gate", "nostore",
// "argmax", "subdot") -> build_kernel, and X4's nostore,
// experiments/kexp5.py make_call("nostore"): K1's gate from theta0 = -inf,
// one divergent branch per query pair. On the TPU those names differ in
// whether Mosaic stores the scores and how it finds the argmax; on the H100
// every score stays in its register, so they share this build. The mode:
// extract.cuh (kXGate, kE = 1): K1's own consume_all and gate_tile
// (topk.cuh), compiled here for the experiments' epilogues. Bound: K1's.

#include "extract.cuh"

extern "C" int vrod_extract_gate(VROD_EXTRACT_PARAMS) {
  (void)variant;
  const vrod::XArgs a = VROD_EXTRACT_XARGS;
  return vrod::run_extract<vrod::kXGate, 1, false>(elem, epi, a, merge_v,
                                                    merge_i, out_v, out_i,
                                                    stream);
}
