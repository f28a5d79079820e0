#!/usr/bin/env python3
"""Same-card A/B of the port's floor and gate kernels against the engine's
stock floor composition: the port's counterpart of the JAX experiments
kexp17 (X6), kexp18 (X7), kexp20 (X8) and kexp22 (X9).

    python3 tools/kexp_floor.py [--rows 1048576] [--dim 768] [--batch 256]
        [--dtypes int8,bf16,f32] [--precision fast|high|exact]
        [--kscans 28,112] [--legs x6,x7,x8,x9] [--frac F --block-rows R]
        [--iters 20] [--out FILE]

Per dtype (cosine rows and queries, random normal from --seed, made on the
card) and k_scan, on the same tensors, every kernel at ``--precision``
(the experiments' ``precision_name``: float32 rows at "high" or "exact"
take the f32x3 leg, three TF32 products, in K3, K1 and X6/X8 alike; the
other rows score alike at every precision):
- stock: the engine's floor composition (``DeviceEngine._scan``):
  ``floor_gate`` -> ``sampled_submax`` (K3) -> ``floor_threshold`` (the
  count threshold) -> ``fused_topk`` (K1);
- x8: ``cuda_floor.fused_theta`` (margin 0), ``skip_sample_dots`` off and
  on; x6: the same with a margin of ``engine.THETA0_MARGIN`` per query;
- x7: K1 from the stock floor against K1 with no floor (theta0 None): the
  gate's worth, which kexp18 measured;
- x9: ``cuda_floor.fused_intgate`` against K1, both from the stock floor
  (int8 only).
The variants' sample is the engine gate's (its rows and block) unless
``--frac``/``--block-rows`` give kexp20's (rows / frac in blocks of
block-rows, at least 2 k_scan sub-maxima). Each pair must return equal
(values, slots); then both are timed warm: CUDA events (mean of
``--iters`` calls), the card's kernel time and kernel count per call
(torch.profiler over 5 calls), the host's enqueue time per call
(``launch_cost.host_ms``) and the variant's device time, 20 calls captured
in a CUDA graph and replayed (``chip_smoke.graph_ms``). One JSON record per (dtype, k_scan, leg,
variant) is printed and written to ``--out``; a k_scan at which the
engine's floor gate is closed (float rows below 64) is reported and
skipped. Needs one CUDA device; there is no CPU mode.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from chip_smoke import graph_ms  # noqa: E402
from kernel_ab import card_line, device_ms, events_ms  # noqa: E402
from launch_cost import host_ms  # noqa: E402

DTYPES = {"int8": "int8", "bf16": "bf16", "bfloat16": "bf16", "f32": "f32",
          "float32": "f32"}
LEGS = ("x6", "x7", "x8", "x9")


def make_state(dtype, rows, dim, batch, seed, dev):
    """Cosine rows (as the engine stores them), all live, and the
    kernel-ready query batch, made on ``dev`` from ``seed``."""
    import numpy as np
    import torch
    from vrod_tpu_torch.ops import distances as D
    kind = {"int8": torch.int8, "bf16": torch.bfloat16,
            "f32": torch.float32}[dtype]
    x = torch.empty((rows, dim), dtype=kind, device=dev)
    aux = torch.empty(rows, dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    for lo in range(0, rows, 65536):
        hi = min(rows, lo + 65536)
        v = torch.randn((hi - lo, dim), generator=gen, device=dev)
        x[lo:hi], aux[lo:hi] = D.prepare_rows(v, metric="cosine", dtype=kind)
    valid = torch.ones(rows, dtype=torch.bool, device=dev)
    qf = np.random.default_rng(seed + 1).standard_normal(
        (batch, dim), dtype=np.float32)
    q = D.prepare_queries(torch.from_numpy(qf).to(dev), metric="cosine",
                          quantize=dtype == "int8")
    return [x, aux, valid, q]


def gate_open(args, k_scan) -> bool:
    import torch
    from vrod_tpu_torch.engine import FloorSettings, floor_gate
    x = args[0]
    return floor_gate(x.shape[0], k_scan, x.shape[1], x.element_size(),
                      x.dtype == torch.int8, FloorSettings.from_env())[0]


def stock_floor(args, k_scan, metric="cosine", precision="fast"):
    """The engine's floor for kernel inputs ``args`` (x, aux, valid, q):
    (theta0 (B, 1), (n_sample, block_rows)), as ``DeviceEngine._scan``
    computes it (K3 at ``precision``, then the count threshold)."""
    import torch
    from vrod_tpu_torch.engine import FloorSettings, floor_gate, \
        floor_threshold
    from vrod_tpu_torch.ops import cuda_topk as K
    x, aux, valid, q = args
    quant = x.dtype == torch.int8
    fs = FloorSettings.from_env()
    ok, ns, blk = floor_gate(x.shape[0], k_scan, x.shape[1],
                             x.element_size(), quant, fs)
    if not ok:
        raise ValueError(f"the engine's floor gate is closed at k_scan "
                         f"{k_scan} on {x.shape[0]} rows")
    sub = K.sampled_submax(x[:ns], aux[:ns], valid[:ns], q, metric=metric,
                           block_rows=blk, precision=precision)
    return floor_threshold(sub, k_scan, q, aux, valid, metric=metric,
                           quant=quant, dim=x.shape[1], fs=fs), (ns, blk)


def variant_sample(n, k_scan, gate_sample, frac, block_rows):
    """(block_rows, s_blocks) of the variants' sample: the engine gate's,
    or kexp20's rows / frac in blocks of ``block_rows``."""
    ns, blk = gate_sample
    if not frac:
        return blk, ns // blk
    return block_rows, max((n // frac) // block_rows, -(-2 * k_scan // 128))


def pairs(args, k_scan, legs, frac=0, block_rows=0, metric="cosine",
          precision="fast"):
    """The A/B pairs at one k_scan: (leg, variant, stock fn, variant fn,
    sample) tuples on the kernel inputs ``args``, every kernel at
    ``precision``."""
    import torch
    from vrod_tpu_torch import engine
    from vrod_tpu_torch.ops import cuda_floor as F
    from vrod_tpu_torch.ops import cuda_topk as K
    x, aux, valid, q = args
    theta0, gate_sample = stock_floor(args, k_scan, metric, precision)
    blk, s_blocks = variant_sample(x.shape[0], k_scan, gate_sample, frac,
                                   block_rows)
    kw = dict(k=k_scan, metric=metric, precision=precision)
    th = dict(kw, block_rows=blk, s_blocks=s_blocks)

    def stock():
        return K.fused_topk(*args, theta0=stock_floor(
            args, k_scan, metric, precision)[0], **kw)

    def k1_floor():
        return K.fused_topk(*args, theta0=theta0, **kw)

    # X6's margin per query, on the card (kexp17 takes a (B, 1) margin).
    x6_margin = torch.full((q.shape[0], 1), engine.THETA0_MARGIN,
                           device=x.device)
    out = []
    for leg in legs:
        if leg in ("x6", "x8"):
            margin = x6_margin if leg == "x6" else None
            for skip in (False, True):
                out.append((leg, "skip" if skip else "plain", stock,
                            lambda m=margin, s=skip: F.fused_theta(
                                *args, margin=m, skip_sample_dots=s, **th)))
        elif leg == "x7":
            out.append((leg, "no floor", k1_floor,
                        lambda: K.fused_topk(*args, **kw)))
        elif leg == "x9" and x.dtype == torch.int8:
            out.append((leg, "intgate", k1_floor,
                        lambda: F.fused_intgate(*args, theta0=theta0,
                                                k=k_scan, metric=metric)))
    return out, (blk, s_blocks)


def run_pairs(args, dtype, k_scans, legs, *, frac=0, block_rows=0, iters=20,
              card="", metric="cosine", precision="fast"):
    """Every pair at every k_scan, under ``metric`` at ``precision``: equal
    results asserted, then timed. Returns the records."""
    import torch
    from vrod_tpu_torch.ops import cuda_topk as K
    recs = []
    kernel_leg = K.leg_name(args[0], metric, precision=precision)
    for k_scan in k_scans:
        todo, (blk, s_blocks) = pairs(args, k_scan, legs, frac, block_rows,
                                      metric, precision)
        for leg, variant, stock, fn in todo:
            sv, si = stock()
            vv, vi = fn()
            torch.cuda.synchronize()
            if not (torch.equal(sv, vv) and torch.equal(si, vi)):
                raise AssertionError(f"{kernel_leg} k_scan {k_scan} {leg} "
                                     f"{variant}: results differ from stock")
            s_dev, s_n = device_ms(stock)
            v_dev, v_n = device_ms(fn)
            rec = {"exp": "kexp_floor", "dtype": dtype,
                   "kernel_leg": kernel_leg, "precision": precision,
                   "k_scan": k_scan,
                   "leg": leg, "variant": variant, "rows": args[0].shape[0],
                   "dim": args[0].shape[1], "batch": args[3].shape[0],
                   "sample_rows": blk * s_blocks, "block_rows": blk,
                   "stock_ms": events_ms(stock, iters),
                   "variant_ms": events_ms(fn, iters),
                   "stock_device_ms": s_dev, "variant_device_ms": v_dev,
                   "stock_kernels_per_call": s_n,
                   "variant_kernels_per_call": v_n,
                   "stock_host_ms": host_ms(stock, iters),
                   "variant_host_ms": host_ms(fn, iters),
                   "variant_graph_ms": graph_ms(fn), "equal": True,
                   "card": card}
            recs.append(rec)
            print(json.dumps(rec), flush=True)
    return recs


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--rows", type=int, default=1 << 20)
    p.add_argument("--dim", type=int, default=768)
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--dtypes", default="int8,bf16")
    p.add_argument("--precision", default="fast",
                   choices=("fast", "high", "exact"),
                   help="the experiments' precision_name: float32 rows at "
                   "high/exact take the f32x3 leg")
    p.add_argument("--kscans", default="28,112")
    p.add_argument("--legs", default=",".join(LEGS))
    p.add_argument("--frac", type=int, default=0,
                   help="variants' sample: rows / frac (kexp20: 8); 0 = the "
                   "engine gate's sample")
    p.add_argument("--block-rows", type=int, default=2048,
                   help="variants' sample block with --frac (kexp20: 2048)")
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=".local/kexp_floor.jsonl")
    args = p.parse_args(argv)
    legs = [leg for leg in args.legs.split(",") if leg]
    if set(legs) - set(LEGS):
        p.error(f"legs are {LEGS}")
    import torch
    if not torch.cuda.is_available():
        print("kexp_floor: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    print(card, flush=True)
    recs = []
    for i, dt in enumerate(args.dtypes.split(",")):
        dtype = DTYPES[dt]
        state = make_state(dtype, args.rows, args.dim, args.batch,
                           args.seed + 10 * i, dev)
        kscans = []
        for k in (int(k) for k in args.kscans.split(",")):
            if gate_open(state, k):
                kscans.append(k)
            else:  # the engine runs no floor there: no stock to hold to
                print(json.dumps({"exp": "kexp_floor", "dtype": dtype,
                                  "k_scan": k, "skipped": "the engine's "
                                  "floor gate is closed"}), flush=True)
        recs += run_pairs(state, dtype, kscans, legs, frac=args.frac,
                          block_rows=args.block_rows, iters=args.iters,
                          card=card, precision=args.precision)
        del state
        torch.cuda.empty_cache()
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text("".join(json.dumps(r) + "\n" for r in recs))
    return 0


if __name__ == "__main__":
    sys.exit(main())
