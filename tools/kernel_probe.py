#!/usr/bin/env python3
"""Where K1's time goes: K1 at the 1M-row phases' shapes built whole, without
its gate, and with the ring alone, on one GPU.

    python tools/kernel_probe.py [--small] [--out FILE]

Builds the kernels three times (compile-time switches of csrc/; the builds
live beside the normal one under csrc/build/, and the port never loads
them): whole; ``VROD_PROBE_NO_GATE`` (the dots but no gate, appends or list
traffic); and ``VROD_PROBE_NO_GATE`` with ``VROD_PROBE_NO_MMA`` (the TMA
ring and ldmatrix only). Then times
``fused_topk`` with CUDA events (mean of 20 after a warm-up) on the main
path's inputs (int8 cosine), (iii)'s (bf16 cosine) and (iv)'s (f32 dot) at
1M x 768, b256, with the floor from K3 as a search gives it, in turns:
whole, no gate, ring alone, ring alone, no gate, whole. The switched builds
return meaningless results; only their times are printed. Prints one JSON
object per line and writes them to ``--out``.

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
VARIANTS = {"whole": (), "no_gate": ("VROD_PROBE_NO_GATE",),
            "ring_alone": ("VROD_PROBE_NO_GATE", "VROD_PROBE_NO_MMA")}
CASES = (("main path", "int8-cosine", 16), ("(iii)", "bf16-cosine", 100),
         ("(iv)", "f32-dot", 100))


SMALL_VARIANTS = dict(VARIANTS, no_mma=("VROD_PROBE_NO_MMA",))
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
            rec[name] = kab.events_ms(
                lambda: K._topk_cuda(lib, call, k, 0, theta0))
        lines.append(json.dumps(rec))
        print(lines[-1], flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
