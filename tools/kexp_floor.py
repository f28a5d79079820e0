#!/usr/bin/env python3
"""Same-card A/B of the port's floor and gate kernels against the engine's
stock floor composition: the port's counterpart of the JAX experiments
kexp17 (X6), kexp18 (X7), kexp20 (X8) and kexp22 (X9).

    python3 tools/kexp_floor.py [--rows 1048576] [--dim 768] [--batch 256]
        [--dtypes int8,bf16] [--kscans 28,112] [--legs x6,x7,x8,x9]
        [--frac F --block-rows R] [--iters 20] [--out FILE]

Per dtype (cosine rows and queries, random normal from --seed, made on the
card) and k_scan, on the same tensors:
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
``--iters`` calls) and the card's kernel time and kernel count per call
(torch.profiler over 5 calls). One JSON record per (dtype, k_scan, leg,
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

from kernel_ab import card_line, device_ms, events_ms  # noqa: E402

DTYPES = {"int8": "int8", "bf16": "bf16", "bfloat16": "bf16"}
LEGS = ("x6", "x7", "x8", "x9")


def make_state(dtype, rows, dim, batch, seed, dev):
    """Cosine rows (as the engine stores them), all live, and the
    kernel-ready query batch, made on ``dev`` from ``seed``."""
    import numpy as np
    import torch
    from vrod_tpu_torch.ops import distances as D
    kind = torch.int8 if dtype == "int8" else torch.bfloat16
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


def stock_floor(args, k_scan, metric="cosine"):
    """The engine's floor for kernel inputs ``args`` (x, aux, valid, q):
    (theta0 (B, 1), (n_sample, block_rows)), as ``DeviceEngine._scan``
    computes it (K3, then the count threshold)."""
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
                           block_rows=blk)
    return floor_threshold(sub, k_scan, q, aux, valid, metric=metric,
                           quant=quant, dim=x.shape[1], fs=fs), (ns, blk)


def variant_sample(n, k_scan, gate_sample, frac, block_rows):
    """(block_rows, s_blocks) of the variants' sample: the engine gate's,
    or kexp20's rows / frac in blocks of ``block_rows``."""
    ns, blk = gate_sample
    if not frac:
        return blk, ns // blk
    return block_rows, max((n // frac) // block_rows, -(-2 * k_scan // 128))


def pairs(args, k_scan, legs, frac=0, block_rows=0, metric="cosine"):
    """The A/B pairs at one k_scan: (leg, variant, stock fn, variant fn,
    sample) tuples on the kernel inputs ``args``."""
    import torch
    from vrod_tpu_torch import engine
    from vrod_tpu_torch.ops import cuda_floor as F
    from vrod_tpu_torch.ops import cuda_topk as K
    x, aux, valid, q = args
    theta0, gate_sample = stock_floor(args, k_scan, metric)
    blk, s_blocks = variant_sample(x.shape[0], k_scan, gate_sample, frac,
                                   block_rows)
    kw = dict(k=k_scan, metric=metric)
    th = dict(kw, block_rows=blk, s_blocks=s_blocks)

    def stock():
        return K.fused_topk(*args, theta0=stock_floor(args, k_scan,
                                                      metric)[0], **kw)

    def k1_floor():
        return K.fused_topk(*args, theta0=theta0, **kw)

    out = []
    for leg in legs:
        if leg in ("x6", "x8"):
            margin = engine.THETA0_MARGIN if leg == "x6" else None
            for skip in (False, True):
                out.append((leg, "skip" if skip else "plain", stock,
                            lambda m=margin, s=skip: F.fused_theta(
                                *args, margin=m, skip_sample_dots=s, **th)))
        elif leg == "x7":
            out.append((leg, "no floor", k1_floor,
                        lambda: K.fused_topk(*args, **kw)))
        elif leg == "x9" and x.dtype == torch.int8:
            out.append((leg, "intgate", k1_floor,
                        lambda: F.fused_intgate(*args, theta0=theta0, **kw)))
    return out, (blk, s_blocks)


def run_pairs(args, dtype, k_scans, legs, *, frac=0, block_rows=0, iters=20,
              card=""):
    """Every pair at every k_scan: equal results asserted, then timed.
    Returns the records."""
    import torch
    recs = []
    for k_scan in k_scans:
        todo, (blk, s_blocks) = pairs(args, k_scan, legs, frac, block_rows)
        for leg, variant, stock, fn in todo:
            sv, si = stock()
            vv, vi = fn()
            torch.cuda.synchronize()
            if not (torch.equal(sv, vv) and torch.equal(si, vi)):
                raise AssertionError(f"{dtype} k_scan {k_scan} {leg} "
                                     f"{variant}: results differ from stock")
            s_dev, s_n = device_ms(stock)
            v_dev, v_n = device_ms(fn)
            rec = {"exp": "kexp_floor", "dtype": dtype, "k_scan": k_scan,
                   "leg": leg, "variant": variant, "rows": args[0].shape[0],
                   "dim": args[0].shape[1], "batch": args[3].shape[0],
                   "sample_rows": blk * s_blocks, "block_rows": blk,
                   "stock_ms": events_ms(stock, iters),
                   "variant_ms": events_ms(fn, iters),
                   "stock_device_ms": s_dev, "variant_device_ms": v_dev,
                   "stock_kernels_per_call": s_n,
                   "variant_kernels_per_call": v_n, "equal": True,
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
                          card=card)
        del state
        torch.cuda.empty_cache()
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text("".join(json.dumps(r) + "\n" for r in recs))
    return 0


if __name__ == "__main__":
    sys.exit(main())
