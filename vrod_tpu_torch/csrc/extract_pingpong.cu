// X3: experiments/kexp3.py, make_call, which scores block j + 1 into the
// other score buffer before it extracts block j, so the MXU and the VPU
// overlap. Here: X1's gate (its lists, test, rounds and cuts: extract.cuh,
// kXGate) with the gate of tile t under the wgmmas of tile t + 1: each
// consumer warpgroup issues the next tile's stages into a second set of
// accumulators and gates a share of this tile's scores between the
// issues. The mode: extract.cuh (kXPingPong). Bound: K1's.

#include "extract.cuh"

extern "C" int vrod_extract_pingpong(VROD_EXTRACT_PARAMS) {
  (void)variant;
  const vrod::XArgs a = VROD_EXTRACT_XARGS;
  return vrod::run_extract<vrod::kXPingPong, 1, false>(
      elem, epi, a, merge_v, merge_i, out_v, out_i, stream);
}
