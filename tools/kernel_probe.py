#!/usr/bin/env python3
"""Where K1's time goes: K1 at the 1M-row phases' shapes built whole and
with parts of its scan switched off, on one GPU.

    python tools/kernel_probe.py [--small] [--out FILE]

Builds the kernels once per variant (compile-time switches of csrc/; the
builds live beside the normal one under csrc/build/, and the port never
loads them):
- ``whole``;
- ``test_only`` (``VROD_PROBE_TEST_ONLY``): the dots and each score's
  test, no appends and so no cuts;
- ``no_gate`` (``VROD_PROBE_NO_GATE``): the dots and the scan's barriers,
  no test;
- ``no_barriers`` (``VROD_PROBE_NO_GATE`` with
  ``VROD_PROBE_NO_CUT_BARRIERS``): the dots alone, without the barriers
  that the scan's list cuts (or its vote) hold both warpgroups at;
- ``ring_alone`` (``VROD_PROBE_NO_GATE`` with ``VROD_PROBE_NO_MMA``): the
  TMA ring and ldmatrix only.
Then times ``fused_topk`` with CUDA events (mean of 20 after a warm-up) on
the main path's inputs (int8 cosine, k_scan 28) and (iii)'s (bf16 cosine,
k_scan 108) at 1M x 768, b256, with the floor from K3 as a search gives
it, and with no floor (theta0 None), in turns: the variants in order, then
in reverse. With the floor the calls take K1's scan from a floor
(``csrc/fused_topk_floor.cu``), which knows ``VROD_PROBE_NO_GATE``,
``VROD_PROBE_NO_CUT_BARRIERS`` and ``VROD_PROBE_NO_MMA`` (its
``test_only`` build is its whole scan); without, the gated core
(``csrc/fused_topk.cu``), which knows them all. The switched builds return
meaningless results; only their times are printed. Last, a
``VROD_PROBE_COUNT`` build counts per call the scores appended, the lists
cut, the cut rounds (a block's vote rounds) and the tiles walked
(``vrod_probe_counts``: the gated core's; the scan from a floor counts
nothing), at the same inputs. Prints one JSON object per line and writes
them to ``--out``.

``--small``: instead, K3 on the int8 headline's sample (32,768 x 768 in
blocks of 16,384, b256) and on a bf16 sample (131,072 x 768), and K1's
small scan at 8,192 x 96, b256, k 28 (int8 and bf16, no floor) and at
32,768 x 768 (int8), each by torch.profiler's device time a call, whole,
without the MMAs (``VROD_PROBE_NO_MMA``: the ring, the loads and for K1
the gate), without K1's gate and with the ring alone.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
VARIANTS = {"whole": (), "test_only": ("VROD_PROBE_TEST_ONLY",),
            "no_gate": ("VROD_PROBE_NO_GATE",),
            "no_barriers": ("VROD_PROBE_NO_GATE",
                            "VROD_PROBE_NO_CUT_BARRIERS"),
            "ring_alone": ("VROD_PROBE_NO_GATE", "VROD_PROBE_NO_MMA")}
CASES = (("main path", "int8-cosine", 16), ("(iii)", "bf16-cosine", 100))
COUNTS = ("appends", "cuts", "cut_rounds", "tiles")


SMALL_VARIANTS = {v: VARIANTS[v] for v in ("whole", "no_gate",
                                           "ring_alone")}
SMALL_VARIANTS["no_mma"] = ("VROD_PROBE_NO_MMA",)
SMALL_CASES = (("K3", "int8-cosine", 32768, 768, 16384),
               ("K3", "bf16-cosine", 131072, 768, 16384),
               ("K1", "int8-cosine", 8192, 96, 0),
               ("K1", "bf16-cosine", 8192, 96, 0),
               ("K1", "int8-cosine", 32768, 768, 0))


def small_probe():
    """The ``--small`` records: K3 and K1's small scan by device time."""
    import numpy as np
    import torch
    from vrod_tpu_torch.ops import _build
    from vrod_tpu_torch.ops import cuda_topk as K
    spec = importlib.util.spec_from_file_location("smoke",
                                                  ROOT / "chip_smoke.py")
    sm = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sm)
    dev = torch.device("cuda", 0)
    card = sm.card_line()
    libs = {v: _build.load(d) for v, d in SMALL_VARIANTS.items()}
    rng = np.random.default_rng(3)
    for kind, leg, n, d, blk in SMALL_CASES:
        x = torch.from_numpy(rng.standard_normal((n, d), dtype=np.float32))
        q = torch.from_numpy(rng.standard_normal((256, d), dtype=np.float32))
        args, kw = sm.kernel_inputs(x, q, leg, dev, dead_every=5)
        call = K._Call(*args, leg.split("-")[1], kw.get("row_bias"),
                       kw.get("q_scale"), kw["packed"])
        rec = {"kernel": kind, "leg": leg, "rows": n, "dim": d,
               "card": card}
        for variant, lib in libs.items():
            fn = (lambda lib=lib: K._submax_cuda(lib, call, blk)) \
                if kind == "K3" else \
                (lambda lib=lib: K._topk_cuda(lib, call, 28, 0, None))
            rec[variant] = sm.device_time(fn)[0]
        yield rec


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--small", action="store_true")
    p.add_argument("--out", default="chiprun_out/kernel_probe.jsonl")
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("kernel_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    if args.small:
        lines = []
        for rec in small_probe():
            lines.append(json.dumps(rec))
            print(lines[-1], flush=True)
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(lines) + "\n")
        return 0
    from vrod_tpu_torch.ops import _build
    from vrod_tpu_torch.ops import cuda_topk as K
    spec = importlib.util.spec_from_file_location(
        "kernel_ab", Path(__file__).with_name("kernel_ab.py"))
    kab = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(kab)
    torch.backends.cuda.matmul.allow_tf32 = False
    # Every variant's build at once (each runs one nvcc a source).
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor() as ex:
        list(ex.map(_build.build, list(VARIANTS.values())
                    + [("VROD_PROBE_COUNT",)]))
    dev = torch.device("cuda", 0)
    card = kab.card_line()
    inputs = {}
    for i, (name, leg, top_k) in enumerate(CASES):
        eng = kab.make_engine(leg, 1_000_000, 300 + i, dev)
        q = torch.randn(kab.BATCH, kab.DIM, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(i))
        a1, kw1, _, _, _ = kab.kernel_inputs(eng, q, eng.scan_widths(top_k)[1])
        kw = dict(kw1)
        call = K._Call(*a1, kw.pop("metric"), kw.pop("row_bias", None),
                       kw.pop("q_scale", None), kw.pop("packed"))
        inputs[name] = (eng, call, kw["k"], kw["theta0"])
    order = list(VARIANTS) + list(reversed(VARIANTS))
    lines = []
    for variant in order:
        lib = _build.load(VARIANTS[variant])
        rec = {"variant": variant, "card": card}
        for name, (_, call, k, theta0) in inputs.items():
            for floor, t0 in (("", theta0), (" no floor", None)):
                rec[name + floor] = kab.events_ms(
                    lambda: K._topk_cuda(lib, call, k, 0, t0))
        lines.append(json.dumps(rec))
        print(lines[-1], flush=True)
    import ctypes
    lib = _build.load(("VROD_PROBE_COUNT",))
    lib.vrod_probe_counts.restype = ctypes.c_int
    lib.vrod_probe_counts.argtypes = [ctypes.c_void_p]
    buf = (ctypes.c_int * 8)()
    for name, (_, call, k, theta0) in inputs.items():
        for floor, t0 in (("", theta0), (" no floor", None)):
            K._ok(lib.vrod_probe_counts(buf), "probe counts")  # zero them
            K._topk_cuda(lib, call, k, 0, t0)
            torch.cuda.synchronize()
            K._ok(lib.vrod_probe_counts(buf), "probe counts")
            rec = {"variant": "counts", "case": name + floor, "k_scan": k,
                   "card": card, **dict(zip(COUNTS, list(buf)))}
            lines.append(json.dumps(rec))
            print(lines[-1], flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
