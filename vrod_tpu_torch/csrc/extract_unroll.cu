// X4's unrolled extraction: experiments/kexp5.py, make_call("unroll2") and
// make_call("unroll4") -> build_kernel, 2 or 4 extractions per while
// iteration. Here: X1's gate (extract_gate.cu) with one warp-uniform branch
// per `variant` = 2 or 4 query pairs (8 or 16 scores), the ballots and
// appends inside predicated per score: fewer branch points for more wasted
// tests, as the TPU traded loop plumbing for overshoot. kexp5's only
// epilogue is cosine. The mode: extract.cuh (kXGate, kE = variant). Bound:
// K1's. This file builds the TMA producer; rows TMA cannot load go to the
// copying build, extract_unroll_copy.cu.

#include "extract.cuh"

VROD_EXTRACT_ENTRY(vrod_extract_unroll, vrod::kXGate, true, true)
