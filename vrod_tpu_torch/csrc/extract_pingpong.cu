// X3: experiments/kexp3.py, make_call, which scores block j + 1 into the
// other score buffer before it extracts block j, so the MXU and the VPU
// overlap. Here the two consumer warpgroups (64 rows of each tile apiece)
// stagger by half a tile through ordered named barriers, so one
// warpgroup's gate runs while the other's wgmmas run; a stage is released
// once both halves are consumed, and the list cuts every 4 tiles stay the
// only points where both wait for each other. The mode: extract.cuh
// (kXPingPong: K1's consume_all and gate_tile with the PingPong dots).
// Bound: K1's.

#include "extract.cuh"

extern "C" int vrod_extract_pingpong(VROD_EXTRACT_PARAMS) {
  (void)variant;
  const vrod::XArgs a = VROD_EXTRACT_XARGS;
  return vrod::run_extract<vrod::kXPingPong, 1, false>(
      elem, epi, a, merge_v, merge_i, out_v, out_i, stream);
}
