#!/usr/bin/env python3
"""Where the gated extraction kernels' time goes: X1's gate and X3
(``ops/cuda_extract.py``) built with probe defines, on the card.

    python3 tools/kexp_probe.py [--defines D1,D2] [--counts] [--rows 1048576]
        [--dim 768] [--batch 256] [--iters 20] [--seed 0]

Per dtype (int8 at k_scan 28 and 112, bfloat16 at 108; cosine rows and
queries from ``tools/kexp_extract.py``'s ``make_state``, blocks of 2048),
the gate and X3 by CUDA events (mean of ``--iters`` calls back to back),
from the library
built with ``--defines`` (``-D`` each):
- ``VROD_PROBE_NO_GATE``: the n64 scan, its vote barrier a tile, no
  test, no lists;
- ``VROD_PROBE_TEST_ONLY``: the test and its warp vote, no appends;
these builds (the switches of topk.cuh's gated core, K1's too) return
wrong results by design and are timed only. With ``--counts`` (which adds
``VROD_PROBE_COUNT``) each kernel instead counts, per call: the warp-level
appends (a warp's query pair or group of kE pairs with a passing score),
cuts, rounds and its blocks' tiles, and the int8 results are held EQUAL
to the plain twin. One JSON line per (dtype, k_scan, kernel), with the
card.
Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from kernel_ab import card_line, events_ms  # noqa: E402
import kexp_extract as ke  # noqa: E402

SHAPES = (("int8", (28, 112)), ("bf16", (108,)))
COUNTS = ("warp_appends", "cuts", "rounds", "tiles")


def launch(lib, kernel, call, k, cnt):
    """One launch of ``kernel`` from ``lib`` (``cuda_extract._launch``'s
    arguments) with ``cnt`` as its counters; (values, slots)."""
    import torch
    from vrod_tpu_torch.ops import cuda_extract as X
    from vrod_tpu_torch.ops import cuda_topk as K
    dev = call.device
    mode, variant = X.KERNELS[kernel]
    plan = X.extract_plan(mode, call.n_scan, call.b, k, K._sms(dev),
                          split=call.split)
    size = X.scratch_sizes("gate", plan, call.b, k, call.nblocks)
    f32, i32 = torch.float32, torch.int32
    out_v = torch.empty((call.b, k), dtype=f32, device=dev)
    out_i = torch.empty((call.b, k), dtype=i32, device=dev)
    t = [torch.empty(size[n], dtype=d, device=dev) for n, d in
         (("cand_v", f32), ("cand_i", i32), ("cand_n", i32), ("merge", f32),
          ("merge", i32))]
    rc = X.entry(lib, mode, call.tma)(
        call.elem, call.epi, variant, call.x.data_ptr(), call.aux.data_ptr(),
        call.mask.data_ptr(), call.q.data_ptr(), call.offset.data_ptr(),
        call.n_scan, call.row_bytes, call.b, k, plan.groups, plan.parts,
        plan.cap, call.block_rows, 0, int(plan.on_chip), 0, call.granule,
        t[0].data_ptr(), t[1].data_ptr(), t[2].data_ptr(), cnt.data_ptr(),
        t[3].data_ptr(), t[4].data_ptr(), out_v.data_ptr(), out_i.data_ptr(),
        K._stream(dev))
    K._ok(rc, f"extract_{mode} launch")
    return out_v, out_i


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--defines", default="")
    p.add_argument("--counts", action="store_true")
    p.add_argument("--rows", type=int, default=1 << 20)
    p.add_argument("--dim", type=int, default=768)
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("kexp_probe: no CUDA device", file=sys.stderr)
        return 2
    from vrod_tpu_torch.ops import _build
    from vrod_tpu_torch.ops import cuda_extract as X
    defines = tuple(d for d in args.defines.split(",") if d)
    if args.counts:
        defines += ("VROD_PROBE_COUNT",)
    lib = _build.load(defines)
    dev = torch.device("cuda", 0)
    card = card_line()
    kernels = ["gate", "pingpong"]
    for dtype, ks in SHAPES:
        state = ke.make_state(dtype, args.rows, args.dim, args.batch,
                              args.seed, dev)
        xa = ke.experiment_args(state)
        for k in ks:
            call = X._XCall(*xa, k=k, metric="cosine", block_rows=2048,
                            precision_name="fast")
            for kern in kernels:
                rec = {"defines": defines, "dtype": dtype, "k_scan": k,
                       "kernel": kern, "card": card}
                scratch = torch.zeros(8, dtype=torch.int32, device=dev)
                if args.counts:
                    v, i = launch(lib, kern, call, k, scratch)
                    want = X.kexp_plain("gate", *xa, k=k, metric="cosine",
                                        block_rows=2048,
                                        precision_name="fast")
                    torch.cuda.synchronize()
                    rec.update(zip(COUNTS, scratch.tolist()))
                    if dtype == "int8":
                        rec["equal"] = bool(torch.equal(v, want[0]) and
                                            torch.equal(i, want[1]))
                rec["ms"] = events_ms(
                    lambda: launch(lib, kern, call, k, scratch), args.iters)
                print(json.dumps(rec), flush=True)
        del state, xa
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
