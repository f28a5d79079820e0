#!/usr/bin/env python3
"""Split K3's and K1's time on one GPU into device work and host work, at
the shapes of K3 on the headline's sample and of K1's small scans (the
TPU's K2), for one or more trees of the port, in turns.

    python tools/launch_cost.py TREE [TREE ...] [--rows-sweep] [--out FILE]

Each TREE is the root of a checkout that holds ``vrod_tpu_torch/`` (an
unpacked ``git archive`` of the parent under ``.local/``, and ``.``); each
runs in a process of its own, in the order given (``PARENT . . PARENT``
for an A/B). Per case, through the wrappers' public calls:

- ``events_ms``: 20 calls back to back between two CUDA events, after a
  warm-up (``chip_smoke.cuda_time_ms``: what the kernel table reports);
- ``device_ms`` and ``launches``: torch.profiler's CUDA time per call and
  its count of device operations per call (kernels, fills and copies the
  wrapper enqueues), over 5 warm calls;
- ``host_ms``: the host's enqueue time per call (``perf_counter`` around
  20 calls issued after a sync, before the next sync);
- ``bound_ms`` and ``library_ms``: ``chip_smoke.bound_of`` and the
  two-call yardstick (the leg's GEMM, then the group max or the top-k),
  from the checkout that holds this file.

Cases: K3 on the sample of the headline's engine (1,000,000 x 768 int8
cosine rows in a 1,048,576-slot engine, b256, k_scan 28, the engine's own
sample and block; bf16 cosine at top-100 beside it); K1 at 8,192 x 96,
b256, k 28 (int8 and bf16 cosine, every fifth slot dead, offset 77: the
smoke's case (d)); and K1 at the headline (1M rows, the floor from K3).
``--rows-sweep``: K1 int8 and bf16 at 96 and 768 dims over 8,192-262,144
rows, where the small-scan path and the long one meet.

Prints one JSON object per line, each with the card's name and power
limit, and writes them all to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
BATCH, ITERS = 256, 20


def smoke():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_lc", HERE.parent / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kernel_ab():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "kernel_ab_lc", HERE / "kernel_ab.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def host_ms(fn, iters=ITERS) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / iters


def measure(sm, ab, fn, bound, library=None) -> dict:
    dev_ms, per_call = ab.device_ms(fn)
    return {"events_ms": sm.cuda_time_ms(fn), "device_ms": dev_ms,
            "launches": per_call, "host_ms": host_ms(fn),
            "bound_ms": bound[0], "bound_by": bound[1],
            "library_ms": library and sm.cuda_time_ms(library, iters=5)}


def k1_small_cases(sm, ab, dev, rng, legs, rows_dims):
    import numpy as np
    import torch
    from vrod_tpu_torch.ops import cuda_topk as K
    for leg in legs:
        for rows, d in rows_dims:
            x = torch.from_numpy(rng.standard_normal((rows, d),
                                                     dtype=np.float32))
            q = torch.from_numpy(rng.standard_normal((BATCH, d),
                                                     dtype=np.float32))
            args, kw = sm.kernel_inputs(x, q, leg, dev, dead_every=5)
            kk = dict(k=28, metric=leg.split("-")[1], index_offset=77, **kw)
            gemm = sm.library_gemm(leg, args[0], args[3])
            extra = [v for v in kw.values() if torch.is_tensor(v)]
            rec = measure(
                sm, ab, lambda: K.fused_topk(*args, **kk),
                sm.bound_of(args + extra, BATCH * 28 * 8,
                            2 * BATCH * rows * d, leg.split("-")[0]),
                lambda: gemm().topk(28, dim=1))
            yield {"case": "K1", "leg": leg, "rows": rows, "dim": d,
                   "k": 28, **rec}


def headline_cases(sm, ab, dev):
    import numpy as np
    import torch
    from vrod_tpu_torch.ops import cuda_topk as K
    for leg, top_k in (("int8-cosine", 16), ("bf16-cosine", 100)):
        eng = ab.make_engine(leg, 1_000_000, 100, dev)
        q = torch.from_numpy(np.random.default_rng(200).standard_normal(
            (BATCH, ab.DIM), dtype=np.float32)).to(dev)
        k_scan = eng.scan_widths(top_k)[1]
        a1, kw1, a3, kw3, (ns, blk) = ab.kernel_inputs(eng, q, k_scan)
        dtype = leg.split("-")[0]
        ex3 = [v for v in kw3.values() if torch.is_tensor(v)]
        ex1 = [v for v in kw1.values() if torch.is_tensor(v)]
        lib = sm.library_times(leg, a1, k_scan, a3, blk)
        rec = measure(sm, ab, lambda: K.sampled_submax(*a3, **kw3),
                      sm.bound_of(
                          a3 + ex3, BATCH * 128 * (ns // blk) * 4,
                          2 * BATCH * ns * ab.DIM, dtype))
        rec["library_ms"] = lib["sampled_submax_library"]
        yield {"case": "K3", "leg": leg, "rows": ns, "block_rows": blk,
               "dim": ab.DIM, **rec}
        rec = measure(sm, ab, lambda: K.fused_topk(*a1, **kw1),
                      sm.bound_of(
                          a1 + ex1, BATCH * k_scan * 8,
                          2 * BATCH * eng.capacity * ab.DIM, dtype))
        rec["library_ms"] = lib["fused_topk_library"]
        yield {"case": "K1", "leg": leg, "rows": eng.capacity,
               "dim": ab.DIM, "k": k_scan, **rec}
        del eng, a1, a3
        torch.cuda.empty_cache()


def run_tree(tree: str, sweep: bool) -> None:
    sm, ab = smoke(), kernel_ab()
    sys.path.insert(0, str(Path(tree).resolve()))
    import numpy as np
    import torch
    from vrod_tpu_torch.ops import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = sm.card_line()
    t0 = time.perf_counter()
    _build.load()
    print(json.dumps({"tree": tree, "build_s": time.perf_counter() - t0,
                      "card": card}), flush=True)
    rng = np.random.default_rng(5)
    cases = list(k1_small_cases(sm, ab, dev, rng,
                                ("int8-cosine", "bf16-cosine"),
                                [(8192, 96)]))
    cases += list(headline_cases(sm, ab, dev))
    if sweep:
        cases += list(k1_small_cases(
            sm, ab, dev, rng, ("int8-cosine", "bf16-cosine"),
            [(r, d) for d in (96, 768)
             for r in (16384, 32768, 65536, 131072, 262144)]))
    for rec in cases:
        print(json.dumps({"tree": tree, **rec, "card": card}), flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("trees", nargs="*")
    p.add_argument("--one", help=argparse.SUPPRESS)
    p.add_argument("--rows-sweep", action="store_true")
    p.add_argument("--out", default="chiprun_out/launch_cost.jsonl")
    args = p.parse_args(argv)
    if args.one:
        run_tree(args.one, args.rows_sweep)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("launch_cost: no CUDA device", file=sys.stderr)
        return 2
    lines = []
    for tree in args.trees:
        cmd = [sys.executable, __file__, "--one", tree]
        cmd += ["--rows-sweep"] if args.rows_sweep else []
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=1800)
        sys.stderr.write(res.stderr[-4000:])
        if res.returncode != 0:
            print(f"launch_cost: {tree} failed ({res.returncode})",
                  file=sys.stderr)
            return 1
        for line in res.stdout.splitlines():
            if line.startswith("{"):
                lines.append(line)
                print(line, flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
