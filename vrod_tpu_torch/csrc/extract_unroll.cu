// X4's unrolled extraction: experiments/kexp5.py, make_call("unroll2") and
// make_call("unroll4") -> build_kernel, 2 or 4 extractions per while
// iteration. Here: K1's gate with one divergent branch per `variant` = 2 or
// 4 query pairs (8 or 16 scores), the appends inside predicated per score:
// fewer branch points for more wasted tests, as the TPU traded loop
// plumbing for overshoot. kexp5's only epilogue is cosine. The mode:
// extract.cuh (kXGate, kE = variant: K1's consume_all and gate_tile with
// kE query pairs a branch). Bound: K1's.

#include "extract.cuh"

extern "C" int vrod_extract_unroll(VROD_EXTRACT_PARAMS) {
  const vrod::XArgs a = VROD_EXTRACT_XARGS;
  if (variant == 2) {
    return vrod::run_extract<vrod::kXGate, 2, true>(elem, epi, a, merge_v,
                                                     merge_i, out_v, out_i,
                                                     stream);
  }
  if (variant == 4) {
    return vrod::run_extract<vrod::kXGate, 4, true>(elem, epi, a, merge_v,
                                                     merge_i, out_v, out_i,
                                                     stream);
  }
  return (int)cudaErrorInvalidValue;
}
