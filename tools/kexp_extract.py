#!/usr/bin/env python3
"""Same-card A/B of the port's extraction experiments against K1 with no
floor: the port's counterpart of the JAX experiments' harnesses kexp (X1),
kexp2 (X2), kexp3 (X3) and kexp5 (X4).

    python3 tools/kexp_extract.py [--rows 1048576] [--dim 768] [--batch 256]
        [--dtypes int8,bf16,f32] [--precision fast|high|exact]
        [--kscans 28,112] [--experiments x1,x2,x3,x4] [--block-rows 2048]
        [--iters 20] [--count] [--seed 0] [--out FILE]

Per dtype (cosine rows and queries, random normal from --seed, made on the
card; the rows a multiple of the block, so none is dropped) and k_scan, on
the same tensors, each variant of ``ops/cuda_extract.py`` against K1
(``cuda_topk.fused_topk``, theta0 None) on the whole blocks, both at
``--precision`` (the experiments' ``--precision``: float32 rows at "high"
or "exact" take the f32x3 leg, three TF32 products; the other rows score
alike at every precision):
- x1: ``kexp_call`` for every variant name (floor, base, maxref, gate,
  nostore, argmax, subdot); ``floor`` is no top-k and is held against its
  plain version instead of K1;
- x2: ``kexp2_call`` (tiles 1, count off); x3: ``kexp3_call``; x4:
  ``kexp5_call`` (nostore, unroll2, unroll4).
Each pair must agree (int8: equal values and slots; bfloat16/float32: the
score bound of ``cuda_topk.topk_disagreement`` at the leg's precision). Variant names that share a
build (``cuda_extract.KERNELS``) are timed once, by the first of them; the
timing is warm: CUDA events (mean of ``--iters`` calls back to back), the
card's kernel time and kernels per call (torch.profiler over 5 calls), the
device time of ``--iters`` calls captured in a CUDA graph and replayed
(``chip_smoke.graph_ms``; not for the plain floor reference) and the
host's enqueue time per call (``perf_counter`` around ``--iters`` calls,
no synchronize), K1 once per k_scan. Beside them, once per k_scan:
the bound (``chip_smoke.bound_of``: the inputs read and the outputs
written once at the HBM rate, against 2 B N D operations at the type's
dense peak) and the library call that computes the same top-k
(``chip_smoke.library_gemm``'s GEMM, then ``torch.topk(k_scan)``; by
events). One JSON record per (dtype, k_scan, experiment, variant), with
its ``kernel`` and either its times or ``timed_as``, is printed and written
to ``--out``;
with ``--count`` one more per (dtype, k_scan): X2's ``cnt`` (tiles 1, 2
and 4), which must equal its plain version's closed form. Needs one CUDA
device; there is no CPU mode (the pairs themselves run anywhere, which the
CPU tests use).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from chip_smoke import bound_of, graph_ms, library_gemm  # noqa: E402
from kernel_ab import card_line, device_ms, events_ms  # noqa: E402
from launch_cost import host_ms  # noqa: E402

DTYPES = {"int8": "int8", "bf16": "bf16", "bfloat16": "bf16", "f32": "f32",
          "float32": "f32"}
EXPERIMENTS = ("x1", "x2", "x3", "x4")


def make_state(dtype, rows, dim, batch, seed, dev):
    """Cosine rows (as the engine stores them), all live, and the
    kernel-ready query batch, made on ``dev`` from ``seed``: K1's inputs
    (x, aux, valid, q)."""
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


def experiment_args(args):
    """K1's inputs (x, aux, valid, q) as the experiments take them: (x,
    aux2d, mask2d, q, offset 0)."""
    import torch
    x, aux, valid, q = args
    n = x.shape[0]
    mask = torch.zeros(n, dtype=torch.float32, device=x.device) \
        .masked_fill_(~valid, float("-inf"))
    return [x, aux.reshape(1, n), mask.reshape(1, n), q,
            torch.zeros(1, dtype=torch.int32, device=x.device)]


def pairs(args, k_scan, experiments, block_rows=2048, metric="cosine",
          precision="fast"):
    """The A/B pairs at one k_scan: (experiment, variant, kernel, reference
    fn, variant fn) on K1's inputs ``args`` under ``metric`` at
    ``precision``; ``kernel`` names the build of ``cuda_extract.KERNELS``
    the variant runs. The reference is K1 with no floor over the whole
    blocks, or for X1's floor its plain version. X4 takes cosine only: at
    another metric its pairs are left out."""
    from vrod_tpu_torch.ops import cuda_extract as X
    from vrod_tpu_torch.ops import cuda_topk as K
    xa = experiment_args(args)
    ns = args[0].shape[0] // block_rows * block_rows
    head = [a[:ns] for a in args[:3]] + [args[3]]
    kw = dict(k=k_scan, metric=metric, block_rows=block_rows,
              precision_name=precision)

    def k1():
        return K.fused_topk(*head, k=k_scan, metric=metric,
                            precision=precision)

    out = []
    for exp in experiments:
        if exp == "x1":
            for v, kern in X.KEXP_VARIANTS.items():
                ref = (lambda: X.kexp_plain("floor", *xa, **kw)) \
                    if v == "floor" else k1
                out.append((exp, v, kern, ref,
                            lambda v=v: X.kexp_call(v, *xa, **kw)))
        elif exp == "x2":
            out.append((exp, "tiles1", "carry", k1,
                        lambda: X.kexp2_call(*xa, **kw)[:2]))
        elif exp == "x3":
            out.append((exp, "pingpong", "pingpong", k1,
                        lambda: X.kexp3_call(*xa, **kw)))
        elif exp == "x4" and metric == "cosine":
            kw5 = dict(kw)
            del kw5["metric"]
            for v, kern in X.KEXP5_VARIANTS.items():
                out.append((exp, v, kern, k1,
                            lambda v=v: X.kexp5_call(v, *xa, **kw5)))
    return out


def count_of(args, k_scan, block_rows=2048, tiles=1, metric="cosine",
             precision="fast"):
    """X2 with ``count``: (values, slots, cnt); cnt must equal the plain
    version's closed form, else this raises."""
    import torch
    from vrod_tpu_torch.ops import cuda_extract as X
    xa = experiment_args(args)
    kw = dict(k=k_scan, metric=metric, block_rows=block_rows,
              precision_name=precision, tiles=tiles, count=True)
    got = X.kexp2_call(*xa, **kw)
    want = X.kexp2_plain(*xa, **kw)
    if not torch.equal(got[2].cpu(), want[2].cpu()):
        raise AssertionError(f"kexp2 count at k_scan {k_scan} tiles {tiles}: "
                             f"{int(got[2][0])} against the closed form's "
                             f"{int(want[2][0])}")
    return got


def yardsticks(args, leg, k_scan, block_rows=2048, iters=5):
    """(bound_ms, bound_by, library_ms) of one k_scan over the whole blocks
    of K1's inputs ``args`` on ``leg``: the bound of the experiments' inputs
    and (B, k) outputs at the leg's operations (f32x3: three TF32
    products), and the library's GEMM (``chip_smoke.library_gemm``; f32x3:
    float32 with TF32 off) + ``torch.topk(k_scan)`` by events."""
    xa = experiment_args(args)
    n, d = args[0].shape
    ns = n // block_rows * block_rows
    whole = [xa[0][:ns], xa[1][:, :ns], xa[2][:, :ns], xa[3], xa[4]]
    b = args[3].shape[0]
    bound_ms, bound_by = bound_of(whole, b * k_scan * 8, 2 * b * ns * d,
                                  leg.split("-")[0])
    gemm = library_gemm(leg, whole[0], args[3])
    lib = events_ms(lambda: gemm().topk(k_scan, dim=1), iters)
    return bound_ms, bound_by, lib


def agree(args, got, want, what, metric="cosine", precision="fast"):
    """Raise unless ``got`` agrees with ``want`` (int8 rows: equal; float
    rows: within the score bound, slots outside near-ties)."""
    import torch
    from vrod_tpu_torch.ops import cuda_topk as K
    x, aux, valid, q = args
    if x.dtype == torch.int8:
        if all(torch.equal(g, w) for g, w in zip(got, want)):
            return
        raise AssertionError(f"{what}: results differ")
    bound = K.score_error_bound(x, aux, valid, q, metric=metric,
                                precision=precision)
    msg = K.topk_disagreement(*got, *want, bound)
    if msg:
        raise AssertionError(f"{what}: {msg}")


def run_pairs(args, dtype, k_scans, experiments, *, block_rows=2048,
              iters=20, count=False, card="", metric="cosine",
              precision="fast"):
    """Every pair at every k_scan under ``metric`` at ``precision``:
    agreement asserted; the first variant name of each build timed against
    its reference (K1 timed once per k_scan), the others recorded with
    ``timed_as`` that name; with ``count`` X2's count too. Returns the
    records."""
    import time
    import torch
    from vrod_tpu_torch.ops import cuda_topk as K
    recs = []
    leg = K.leg_name(args[0], metric, precision=precision)
    base = {"exp": "kexp_extract", "dtype": dtype, "leg": leg,
            "precision": precision, "rows": args[0].shape[0],
            "dim": args[0].shape[1], "batch": args[3].shape[0],
            "block_rows": block_rows, "card": card}

    def timed(f, graph=True):
        dev_ms, per_call = device_ms(f)
        return (events_ms(f, iters), dev_ms, per_call, host_ms(f, iters),
                graph_ms(f, iters) if graph else None)

    for k_scan in k_scans:
        first, k1 = {}, None
        bound_ms, bound_by, lib_ms = yardsticks(args, leg, k_scan,
                                                block_rows)
        for exp, variant, kern, ref, fn in pairs(args, k_scan, experiments,
                                                 block_rows, metric,
                                                 precision):
            want, got = ref(), fn()
            torch.cuda.synchronize()
            agree(args, got, want, f"{leg} k_scan {k_scan} {exp} "
                  f"{variant}", metric, precision)
            rec = dict(base, k_scan=k_scan, experiment=exp, variant=variant,
                       kernel=kern,
                       reference="plain" if variant == "floor" else "K1",
                       agree=True)
            if kern in first:
                rec["timed_as"] = first[kern]
            else:
                first[kern] = f"{exp} {variant}"
                if variant == "floor":
                    r = timed(ref, graph=False)  # the plain version
                else:
                    k1 = k1 or timed(ref)
                    r = k1
                v = timed(fn)
                rec.update(reference_ms=r[0], reference_device_ms=r[1],
                           reference_kernels_per_call=r[2],
                           reference_host_ms=r[3],
                           reference_graph_ms=r[4],
                           variant_ms=v[0], variant_device_ms=v[1],
                           variant_kernels_per_call=v[2], variant_host_ms=v[3],
                           variant_graph_ms=v[4],
                           bound_ms=bound_ms, bound_by=bound_by,
                           library_ms=lib_ms)
            recs.append(rec)
            print(json.dumps(rec), flush=True)
        if count:
            for tiles in (1, 2, 4):
                t0 = time.perf_counter()
                cnt = int(count_of(args, k_scan, block_rows, tiles, metric,
                                   precision)[2][0])
                rec = dict(base, k_scan=k_scan, experiment="x2",
                           variant=f"count tiles{tiles}", kernel="carry",
                           cnt=cnt, equals_closed_form=True,
                           wall_s=time.perf_counter() - t0)
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
    p.add_argument("--experiments", default=",".join(EXPERIMENTS))
    p.add_argument("--block-rows", type=int, default=2048)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--count", action="store_true",
                   help="also X2's while-iteration count (one part per "
                   "query group: a slow, untimed run)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=".local/kexp_extract.jsonl")
    args = p.parse_args(argv)
    exps = [e for e in args.experiments.split(",") if e]
    if set(exps) - set(EXPERIMENTS):
        p.error(f"experiments are {EXPERIMENTS}")
    import torch
    if not torch.cuda.is_available():
        print("kexp_extract: no CUDA device", file=sys.stderr)
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
        recs += run_pairs(state, dtype,
                          [int(k) for k in args.kscans.split(",")], exps,
                          block_rows=args.block_rows, iters=args.iters,
                          count=args.count, card=card,
                          precision=args.precision)
        del state
        torch.cuda.empty_cache()
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text("".join(json.dumps(r) + "\n" for r in recs))
    return 0


if __name__ == "__main__":
    sys.exit(main())
