// X3: experiments/kexp3.py, make_call, which scores block j + 1 into the
// other score buffer before it extracts block j, so the MXU and the VPU
// overlap. Here: X1's gate (its lists, test, rounds and cuts: extract.cuh,
// kXGate) with the gate of tile t under the wgmmas of tile t + 1: each
// consumer warpgroup issues the next tile's stages into a second set of
// accumulators and gates a share of this tile's scores between the
// issues. The mode: extract.cuh (kXPingPong). Bound: K1's. This file
// builds the TMA producer; rows TMA cannot load go to the copying build,
// extract_pingpong_copy.cu.

#include "extract.cuh"

VROD_EXTRACT_ENTRY(vrod_extract_pingpong, vrod::kXPingPong, false, true)
