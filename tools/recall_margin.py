#!/usr/bin/env python3
"""Measure the rescore margins of the port's search on the card: the port
of ``experiments/recall_margin.py``.

    python3 tools/recall_margin.py [--rows 1048576] [--dim 768]
        [--dtypes int8,int4,bfloat16,float32] [--metrics cosine,dot,l2]
        [--ks 10,16,100] [--batches 4] [--batch 256]
        [--margins 0,4,...] [--no-known] [--out tools/recall_results_h100.jsonl]

For each dtype and metric a one-shard ``DeviceEngine`` on ``cuda:0`` is
filled with ``--rows`` random normal rows, drawn on the card from a seeded
``torch.Generator`` in 1M-row chunks and stored through ``write``. Each of
``--batches`` query batches (its own seed) is probed at every k and margin
as ``bench.device_recall_probe`` does: the production search
``eng.search(q, k, margin=m)`` (K3, the floor and K1 at precision "fast",
then the exact rescore of k_scan = k_out + m candidates) against the exact
scan ``eng.search(q, k, impl="scan", precision="exact", rescore=False)``:
a returned score counts as a hit when it is at least the oracle's k-th
(at most, for l2) within 1e-5 relative, and every row's ids must be
unique. The oracle is computed once per batch at the largest k. Every
probe is a JSON line in ``--out`` with the card's name and power limit.

The known case: int8 cosine top-100 on the 131,072 x 768 rows and the
first 256-query batch that the smoke's every-leg phase once drew from
numpy seed 15 (``tests/test_torch_engine.py``: query 119 loses row 121939
at k_scan 112), probed at every margin, with whether that row was found.

Margins: the JAX tool's lists, (0, 4, 8, 16, 32, 64) and, for int8,
(8, 32, 64, 128, 192, 256), both for every dtype, plus 12, 16 and 24.
The engine's policy (``DeviceEngine.scan_widths``) is set from these
records (PERF.md). Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

OUT = Path(__file__).resolve().parent / "recall_results_h100.jsonl"
MARGINS = (0, 4, 8, 12, 16, 24, 32, 64, 128, 192, 256)
FILL_CHUNK = 1 << 20
EPS = 1e-5
KNOWN_QUERY, KNOWN_ROW = 119, 121939


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def probe(eng, q, k, margin, kth):
    """(hits, ids) of the production search at ``margin`` against the
    oracle's k-th scores ``kth`` (B,), tie-aware; asserts unique ids."""
    import torch
    vals, idx = eng.search(q, k, margin=margin, as_numpy=False)
    for row in idx.cpu().numpy():
        live = row[row >= 0]
        assert np.unique(live).size == live.size, \
            f"duplicate slots in a top-{k} row: {row}"
    kth = kth[:, None]
    tol = EPS * torch.clamp(kth.abs(), min=1.0)
    hits = vals <= kth + tol if eng.cfg.metric == "l2" \
        else vals >= kth - tol
    return hits, idx


def oracle(eng, q, k_max):
    vals, _ = eng.search(q, k_max, impl="scan", precision="exact",
                         rescore=False, as_numpy=False)
    return vals


def sweep(args, card, dev, out):
    import torch
    from vrod_tpu_torch.config import CollectionConfig
    from vrod_tpu_torch.engine import DeviceEngine
    ks = [int(k) for k in args.ks.split(",")]
    margins = [int(m) for m in args.margins.split(",")]
    for dtype in args.dtypes.split(","):
        for metric in args.metrics.split(","):
            t0 = time.perf_counter()
            cfg = CollectionConfig(name="recall", dim=args.dim,
                                   metric=metric, dtype=dtype,
                                   segment_rows=65536, shards=1)
            eng = DeviceEngine(cfg, device=dev)
            eng.ensure_capacity(args.rows)
            g = torch.Generator(device=dev)
            g.manual_seed(args.seed)
            for lo in range(0, args.rows, FILL_CHUNK):
                n = min(FILL_CHUNK, args.rows - lo)
                rows = torch.randn((n, args.dim), generator=g, device=dev)
                eng.write(np.arange(lo, lo + n), rows.cpu().numpy())
                del rows
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            fill_s = time.perf_counter() - t0
            for b in range(args.batches):
                gq = torch.Generator(device=dev)
                gq.manual_seed(args.seed + 1000 + b)
                q = torch.randn((args.batch, args.dim), generator=gq,
                                device=dev)
                ovals = oracle(eng, q, max(ks))
                for k in ks:
                    kth = ovals[:, k - 1]
                    for m in margins:
                        hits, _ = probe(eng, q, k, m, kth)
                        rec = {"dtype": dtype, "metric": metric,
                               "rows": args.rows, "dim": args.dim, "k": k,
                               "k_scan": eng.scan_widths(k, m)[1],
                               "margin": m, "batch": b,
                               "queries": args.batch,
                               "recall": float(hits.float().mean()),
                               "misses": int((~hits).sum()),
                               "policy_k_scan": eng.scan_widths(k)[1],
                               "card": card}
                        out.write(json.dumps(rec) + "\n")
                        out.flush()
            print(f"{dtype} {metric}: {args.rows} x {args.dim} filled in "
                  f"{fill_s:.1f} s, swept in "
                  f"{time.perf_counter() - t0 - fill_s:.1f} s [{card}]",
                  flush=True)
            del eng
            if dev.type == "cuda":
                torch.cuda.empty_cache()


def known_case(card, dev, out, margins):
    """int8 cosine top-100 on the smoke's seed-15 rows (see the module
    docstring): recall of the first batch and whether query 119 finds row
    121939, at every margin."""
    import torch
    from vrod_tpu_torch.config import CollectionConfig
    from vrod_tpu_torch.engine import DeviceEngine
    src = np.random.default_rng(15)
    qb = [src.standard_normal((256, 768), dtype=np.float32)
          for _ in range(3)][0]
    rows = np.concatenate([src.standard_normal((65536, 768),
                                               dtype=np.float32)
                           for _ in range(2)])
    cfg = CollectionConfig(name="known", dim=768, metric="cosine",
                           dtype="int8", segment_rows=65536, shards=1)
    eng = DeviceEngine(cfg, device=dev)
    eng.ensure_capacity(rows.shape[0])
    eng.write(np.arange(rows.shape[0]), rows)
    q = torch.from_numpy(qb).to(dev)
    kth = oracle(eng, q, 100)[:, 99]
    for m in margins:
        hits, idx = probe(eng, q, 100, m, kth)
        found = bool((idx[KNOWN_QUERY] == KNOWN_ROW).any())
        rec = {"dtype": "int8", "metric": "cosine", "rows": rows.shape[0],
               "dim": 768, "k": 100, "k_scan": eng.scan_widths(100, m)[1],
               "margin": m, "batch": "seed15", "queries": 256,
               "recall": float(hits.float().mean()),
               "misses": int((~hits).sum()),
               "policy_k_scan": eng.scan_widths(100)[1],
               "known_row_found": found, "card": card}
        out.write(json.dumps(rec) + "\n")
        out.flush()
        print(json.dumps(rec), flush=True)


def least_margins(path) -> dict:
    """{(dtype, metric, k): the least swept margin from which every larger
    one held recall 1.0 on every batch} over the sweep's records."""
    recs = [json.loads(line) for line in open(path)]
    held: dict = {}
    for r in recs:
        if r["batch"] == "seed15":
            continue
        key = (r["dtype"], r["metric"], r["k"], r["margin"])
        held[key] = held.get(key, True) and r["misses"] == 0
    out = {}
    for (dtype, metric, k) in sorted({kk[:3] for kk in held}):
        ms = sorted(m for (d, mt, kk, m) in held
                    if (d, mt, kk) == (dtype, metric, k))
        least = None
        for m in reversed(ms):
            if not held[(dtype, metric, k, m)]:
                break
            least = m
        out[(dtype, metric, k)] = least
    return out


def summarize(path) -> None:
    """Per dtype and k: the least margin that held on every batch, by
    metric, and 1.5 x the largest of them rounded up (the policy rule)."""
    least = least_margins(path)
    for dtype in sorted({d for d, _, _ in least}):
        for k in sorted({k for d, _, k in least if d == dtype}):
            by = {mt: least[(d, mt, kk)] for (d, mt, kk) in least
                  if d == dtype and kk == k}
            worst = None if None in by.values() else max(by.values())
            rule = None if worst is None else -(-3 * worst // 2)
            print(json.dumps({"dtype": dtype, "k": k, "least": by,
                              "x1.5": rule}))
    for line in open(path):
        r = json.loads(line)
        if r["batch"] == "seed15":
            print(json.dumps({k: r[k] for k in (
                "margin", "k_scan", "recall", "misses",
                "known_row_found")}))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=1 << 20)
    ap.add_argument("--dim", type=int, default=768)
    ap.add_argument("--dtypes", default="int8,int4,bfloat16,float32")
    ap.add_argument("--metrics", default="cosine,dot,l2")
    ap.add_argument("--ks", default="10,16,100")
    ap.add_argument("--batches", type=int, default=4)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--margins", default=",".join(map(str, MARGINS)))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-known", action="store_true",
                    help="skip the known int8 top-100 case")
    ap.add_argument("--out", default=str(OUT))
    ap.add_argument("--device", default="cuda:0",
                    help="torch device (cpu: a dry run of the harness)")
    ap.add_argument("--summary", action="store_true",
                    help="print the margin table of --out and exit")
    args = ap.parse_args(argv)
    if args.summary:
        summarize(args.out)
        return 0
    import torch
    from vrod_tpu_torch.runtime import resolve_device
    dev = resolve_device(args.device)
    # The oracle's products in exact float32: no TF32 outside the kernels.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line() if dev.type == "cuda" else "cpu"
    print(card, flush=True)
    with open(args.out, "a") as out:
        if not args.no_known:
            known_case(card, dev, out,
                       [int(m) for m in args.margins.split(",")])
        sweep(args, card, dev, out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
