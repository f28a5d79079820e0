#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py [--rows 1000000] [--seed 0]

Phases (any failure exits non-zero; nothing is caught and ignored):
1. Setup: a CUDA device must exist; print the card's name and power limit
   (nvidia-smi) and build the kernels from ``vrod_tpu_torch/csrc``.
2. Kernels vs plain on the card: K1 (``fused_topk``) and K3
   (``sampled_submax``) against their plain PyTorch versions on the same
   CUDA tensors. int8 scores are exact integer dots times one float32
   multiply, so values and slots must be EXACTLY equal (tolerance 0).
3. Main path through the entry points: ``Database.new`` ->
   ``create_collection`` (dim 768, cosine, int8) -> ``bulk_insert`` of
   ``--rows`` seeded rows in 65,536-row chunks (WAL first, fsync) -> 20 x
   ``search_similar`` at batch 256, top-16, each checked against an exact
   float32 full scan of the stored rows on the card (tie-aware recall 1.0,
   unique ids) -> ``snapshot``, delete 1,000 ids, close, ``Database.load``
   (snapshot restore + WAL replay) -> the same queries again: deleted ids
   are gone and every other result is unchanged. The kernels' launch
   counters must rise with every search. Then K1 and K3 are compared with
   their plain versions, and timed, at the shapes this path gave them.

The last two lines of standard output are one JSON object per line: the
kernels' account, then ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

DIM, BATCH, TOP_K, SEARCHES = 768, 256, 16, 20
INGEST_CHUNK = 65536
N_DELETE = 1000
RECALL_EPS = 1e-5  # tie tolerance of the recall check (bench.py's)


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_time_ms(fn, iters=20, warmup=3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def make_int8_state(rng, n, d, b, dev, dead_every=0, ties=False):
    import torch
    from vrod_tpu_torch.ops import distances as D
    x = torch.from_numpy(rng.standard_normal((n, d), dtype=np.float32))
    if ties:
        x[1000:1100] = x[7]
        x[5000:5040] = x[9000]
    rows, aux = D.prepare_rows(x.to(dev), metric="cosine", dtype=torch.int8)
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    if dead_every:
        valid[::dead_every] = False
    q = torch.from_numpy(rng.standard_normal((b, d), dtype=np.float32))
    if ties:
        q[0] = x[7]
    q8 = D.prepare_queries(q.to(dev), metric="cosine", quantize=True)
    return rows, aux, valid, q8


class Compare:
    """Kernel-vs-plain comparisons; tolerance 0 (exact equality)."""

    def __init__(self):
        self.max_err = {"fused_topk": 0.0, "sampled_submax": 0.0}

    def check(self, name, got, want, what):
        import torch
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            if g.shape != w.shape or g.dtype != w.dtype:
                raise AssertionError(f"{what}: {name} gave {g.shape} "
                                     f"{g.dtype}, plain {w.shape} {w.dtype}")
            if g.dtype == torch.float32:
                both = torch.isfinite(g) & torch.isfinite(w)
                if not torch.equal(torch.isfinite(g), torch.isfinite(w)):
                    raise AssertionError(f"{what}: {name} -inf ranks differ")
                err = float((g[both] - w[both]).abs().max()) \
                    if both.any() else 0.0
                self.max_err[name] = max(self.max_err[name], err)
            if not torch.equal(g, w):
                raise AssertionError(f"{what}: {name} differs from plain")

    def submax(self, x, aux, valid, q8, blk, what):
        from vrod_tpu_torch.ops import cuda_topk as K
        got = K.sampled_submax(x, aux, valid, q8, metric="cosine",
                               block_rows=blk)
        want = K.sampled_submax_plain(x, aux, valid, q8, metric="cosine",
                                      block_rows=blk)
        self.check("sampled_submax", [got], [want], what)
        return got

    def topk(self, x, aux, valid, q8, k, what, offset=0, theta0=None):
        from vrod_tpu_torch.ops import cuda_topk as K
        kw = dict(k=k, metric="cosine", index_offset=offset, theta0=theta0)
        got = K.fused_topk(x, aux, valid, q8, **kw)
        want = K.fused_topk_plain(x, aux, valid, q8, **kw)
        self.check("fused_topk", got, want, what)
        return got


def kernel_cases(cmp, rng, dev):
    """Shape (a) and its variants; returns the times at shape (a)."""
    import torch
    from vrod_tpu_torch.ops import cuda_topk as K
    from vrod_tpu_torch.ops import distances as D
    n = 65536
    x, aux, valid, q8 = make_int8_state(rng, n, DIM, BATCH, dev,
                                        dead_every=7)
    sub = cmp.submax(x[:32768], aux[:32768], valid[:32768], q8, 16384,
                     "(a) K3 32768 rows, blk 16384")
    theta0 = D.threshold_from_submax(sub, 28, method="count")
    cmp.topk(x, aux, valid, q8, 28, "(a) k 28, floor, offset", 12345, theta0)
    cmp.topk(x, aux, valid, q8, 28, "(b) k 28, no floor")
    sub = cmp.submax(x[:32768], aux[:32768], valid[:32768], q8, 1024,
                     "(c) K3 blk 1024")
    cmp.topk(x, aux, valid, q8, 112, "(c) k 112, floor", 0,
             D.threshold_from_submax(sub, 112, method="count"))
    cmp.topk(x, aux, valid, q8, 1280, "(c) k 1280")
    for d in (96, 30):
        xd, ad, vd, qd = make_int8_state(rng, 8192, d, BATCH, dev,
                                         dead_every=5)
        cmp.submax(xd, ad, vd, qd, 4096, f"(d) K3 dim {d}")
        cmp.topk(xd, ad, vd, qd, 28, f"(d) dim {d}", 77)
    xt, at, vt, qt = make_int8_state(rng, 16384, DIM, BATCH, dev, ties=True)
    v, i = cmp.topk(xt, at, vt, qt, 112, "(e) ties")
    if i[0, :101].tolist() != [7] + list(range(1000, 1100)):
        raise AssertionError("(e) ties: copies of row 7 not lowest slot first")
    dead = torch.zeros_like(valid)
    v, i = cmp.topk(x, aux, dead, q8, 28, "(f) all dead")
    if not bool((i == -1).all()) or not bool(torch.isneginf(v).all()):
        raise AssertionError("(f) all dead: results not (-inf, -1)")
    few = torch.zeros_like(valid)
    few[[3, 700, 4000, 50000, 65535]] = True
    v, i = cmp.topk(x, aux, few, q8, 28, "(f) k > live")
    if not bool(((i >= 0).sum(dim=1) == 5).all()):
        raise AssertionError("(f) k > live: wrong number of results")
    times = {
        "fused_topk": cuda_time_ms(lambda: K.fused_topk(
            x, aux, valid, q8, k=28, metric="cosine", theta0=theta0)),
        "fused_topk_plain": cuda_time_ms(lambda: K.fused_topk_plain(
            x, aux, valid, q8, k=28, metric="cosine", theta0=theta0)),
        "sampled_submax": cuda_time_ms(lambda: K.sampled_submax(
            x[:32768], aux[:32768], valid[:32768], q8, metric="cosine",
            block_rows=16384)),
        "sampled_submax_plain": cuda_time_ms(lambda: K.sampled_submax_plain(
            x[:32768], aux[:32768], valid[:32768], q8, metric="cosine",
            block_rows=16384)),
    }
    return times


def oracle_kth(eng, q):
    """Exact float32 full scan of the stored rows on the card: the k-th
    best score per query (the plain blockwise scan, no quantized query)."""
    from vrod_tpu_torch.ops import distances as D
    import torch
    qp = D.prepare_queries(torch.from_numpy(q).to(eng.device),
                           metric="cosine")
    blk = 65536 if eng.capacity % 65536 == 0 else eng.capacity
    vals, _ = D.blockwise_topk(eng.x, eng.aux, eng.valid, qp, k=TOP_K,
                               metric="cosine", precision="exact",
                               block_rows=blk, nblocks=eng.capacity // blk)
    return vals[:, TOP_K - 1].cpu().numpy()


def check_hits(hits, kth, what):
    for b, hs in enumerate(hits):
        ids = [h.record_id for h in hs]
        if len(ids) != TOP_K or len(set(ids)) != TOP_K:
            raise AssertionError(f"{what}: query {b} got ids {ids}")
        scores = np.array([h.score for h in hs], np.float64)
        floor = kth[b] - RECALL_EPS * max(abs(kth[b]), 1.0)
        if not (scores >= floor).all():
            raise AssertionError(
                f"{what}: query {b} recall < 1 (scores {scores}, exact "
                f"k-th {kth[b]})")


def main_path(args, dev, card):
    import torch
    from vrod_tpu_torch import Database
    from vrod_tpu_torch.ops import cuda_topk as K

    rng = np.random.default_rng(args.seed)
    queries = [rng.standard_normal((BATCH, DIM), dtype=np.float32)
               for _ in range(SEARCHES)]
    tmp = Path(tempfile.mkdtemp(prefix="vrod_smoke_"))
    try:
        torch.cuda.reset_peak_memory_stats(dev)
        K.reset_launches()
        db = Database.new(tmp, "smoke", device=dev)
        col = db.create_collection("docs", dim=DIM, metric="cosine",
                                   dtype="int8")
        ingest_s, ids = 0.0, []
        for start in range(0, args.rows, INGEST_CHUNK):
            rows = rng.standard_normal(
                (min(INGEST_CHUNK, args.rows - start), DIM),
                dtype=np.float32)
            t0 = time.perf_counter()
            ids.append(col.bulk_insert(rows))
            torch.cuda.synchronize(dev)
            ingest_s += time.perf_counter() - t0
        ids = np.concatenate(ids)
        log(f"ingest: {args.rows} rows in {ingest_s:.3f} s = "
            f"{args.rows / ingest_s:.1f} rows/s [{card}]")

        col.search_similar(queries[0], TOP_K)  # warm-up, not timed
        lat, before = [], []
        for b, q in enumerate(queries):
            n0 = dict(K.launches)
            t0 = time.perf_counter()
            hits = col.search_similar(q, TOP_K)
            lat.append(time.perf_counter() - t0)
            for name in K.launches:
                if K.launches[name] <= n0[name]:
                    raise AssertionError(f"search {b} launched no {name}")
            check_hits(hits, oracle_kth(col.engine, q), f"search {b}")
            before.append([[(h.record_id, h.score) for h in hs]
                           for hs in hits])
        lat_ms = np.array(lat) * 1e3
        log(f"search b{BATCH} top-{TOP_K}: p50 {np.percentile(lat_ms, 50):.3f}"
            f" ms, p99 {np.percentile(lat_ms, 99):.3f} ms, "
            f"{SEARCHES * BATCH / sum(lat):.1f} QPS over {SEARCHES} batches "
            f"after one warm-up [{card}]")

        col.snapshot()
        top1 = [bq[j][0][0] for bq in before for j in range(0, BATCH, 4)]
        extra = rng.choice(ids, N_DELETE, replace=False).tolist()
        gone = list(dict.fromkeys(top1[:N_DELETE // 2] + extra))[:N_DELETE]
        if col.delete_many(gone) != len(gone):
            raise AssertionError("delete_many deleted fewer ids")
        db.close()
        db = Database.load(tmp / "smoke", device=dev)
        col = db.collection("docs")
        if col.count != args.rows - len(gone):
            raise AssertionError(f"count after reopen {col.count}")
        gone_set = set(gone)
        for b, q in enumerate(queries):
            n0 = dict(K.launches)
            hits = col.search_similar(q, TOP_K)
            for name in K.launches:
                if K.launches[name] <= n0[name]:
                    raise AssertionError(f"reopened search {b} launched "
                                         f"no {name}")
            check_hits(hits, oracle_kth(col.engine, q), f"reopened {b}")
            for j, hs in enumerate(hits):
                got = [(h.record_id, h.score) for h in hs]
                if any(r in gone_set for r, _ in got):
                    raise AssertionError("a deleted id came back")
                kept = [p for p in before[b][j] if p[0] not in gone_set]
                if got[:len(kept)] != kept:
                    raise AssertionError(
                        f"reopened {b}/{j}: {got} vs kept {kept}")
        torch.cuda.synchronize(dev)
        launches = dict(K.launches)
        peak = torch.cuda.max_memory_allocated(dev)
        log(f"kernel launches on the main path: {launches}")
        log(f"peak device memory: {peak} bytes [{card}]")

        # The kernels at the shapes this path gave them (not counted).
        from vrod_tpu_torch.engine import floor_gate
        from vrod_tpu_torch.ops import distances as D
        eng = col.engine
        q8 = D.prepare_queries(torch.from_numpy(queries[0]).to(dev),
                               metric="cosine", quantize=True)
        ok, ns, blk = floor_gate(eng.capacity, TOP_K + 12, DIM)
        if not ok:
            raise AssertionError("floor gate closed on the main path")
        cmp = Compare()
        sub = cmp.submax(eng.x[:ns], eng.aux[:ns], eng.valid[:ns], q8, blk,
                         f"main path K3 {ns} rows")
        theta0 = D.threshold_from_submax(sub, TOP_K + 12,
                                            method="count")
        cmp.topk(eng.x, eng.aux, eng.valid, q8, TOP_K + 12,
                 f"main path K1 {eng.capacity} rows", theta0=theta0)
        # Split of the search: the engine alone (device program and the
        # copy of the results to the host) vs search_similar above.
        eng_lat = []
        for q in queries:
            t0 = time.perf_counter()
            eng.search(q, TOP_K)
            eng_lat.append(time.perf_counter() - t0)
        log(f"engine.search b{BATCH} top-{TOP_K}: p50 "
            f"{np.percentile(np.array(eng_lat) * 1e3, 50):.3f} ms "
            f"[{card}]")
        kw1 = dict(k=TOP_K + 12, metric="cosine", theta0=theta0)
        kw3 = dict(metric="cosine", block_rows=blk)
        a3 = (eng.x[:ns], eng.aux[:ns], eng.valid[:ns], q8)
        a1 = (eng.x, eng.aux, eng.valid, q8)
        times = {
            "fused_topk_plain": cuda_time_ms(
                lambda: K.fused_topk_plain(*a1, **kw1), iters=5),
            "fused_topk": cuda_time_ms(lambda: K.fused_topk(*a1, **kw1)),
            "sampled_submax": cuda_time_ms(
                lambda: K.sampled_submax(*a3, **kw3)),
            "sampled_submax_plain": cuda_time_ms(
                lambda: K.sampled_submax_plain(*a3, **kw3), iters=5),
        }
        log(f"kernels at the main path's shapes ({eng.capacity} rows, "
            f"sample {ns}, b{BATCH}, k_scan {TOP_K + 12}), ms: "
            f"{json.dumps(times)} [{card}]")
        db.close()
        return launches, cmp.max_err, times
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--rows", type=int, default=1_000_000,
                   help="rows to ingest on the main path (default 1M)")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    if args.rows < 262144:
        p.error("--rows below 262,144 closes the sampled floor's gate, so "
                "K3 would not run on the main path")

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from vrod_tpu_torch.ops import _build

    # Exact float32 oracle products: no TF32 anywhere.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    lib = _build.build()
    _build.load()
    log(f"kernels built in {time.perf_counter() - t0:.3f} s: {lib.name}")
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log("  ptxas:", line.strip())

    cmp = Compare()
    times_a = kernel_cases(cmp, np.random.default_rng(args.seed + 1), dev)
    log(f"kernel cases (a)-(f) equal to plain; shape (a) 65536 x {DIM}, "
        f"b{BATCH}, k 28, ms: {json.dumps(times_a)} [{card}]")

    launches, err_main, times = main_path(args, dev, card)
    for name, n in launches.items():
        if n < 2 * SEARCHES:
            raise AssertionError(f"{name} launched {n} times on the main "
                                 f"path, expected >= {2 * SEARCHES}")
    src = {"fused_topk": ("vrod_tpu_torch/csrc/fused_topk.cu",
                          "vrod_tpu/ops/pallas_topk.py:251"),
           "sampled_submax": ("vrod_tpu_torch/csrc/sampled_submax.cu",
                              "vrod_tpu/ops/pallas_topk.py:468")}
    kernels = [{
        "name": name, "route": "cuda", "source": src[name][0],
        "replaces": src[name][1], "launches": launches[name],
        "max_abs_err": max(cmp.max_err[name], err_main[name]),
        "ms": times[name], "plain_ms": times[name + "_plain"],
    } for name in ("fused_topk", "sampled_submax")]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
