#!/usr/bin/env python3
"""Long-run serving soak of the PyTorch/CUDA port: ``experiments/soak_serve.py``
over ``vrod_tpu_torch``. Concurrent searches + mutations +
auto-maintenance against one ``VrodServer``, watching for leaks and errors
that the (seconds-long) suite stress tests cannot surface: unbounded
memory growth (leaked futures/masks/snapshots), fd leaks, lock-ordering
stalls, and counter drift.

Closed-loop search clients + one mutator client (batch inserts/deletes
that cross the auto-snapshot WAL budget and the auto-compact live fraction
repeatedly), sampled every ``--seconds-per-sample`` (default 15 s): RSS,
fds, the counts, and on a CUDA device ``torch.cuda.memory_allocated()`` and
``memory_reserved()`` of this process (the server runs in it).

Pass criteria, printed as ONE JSON line and reflected in the exit code:
  errors == 0,
  fd count bounded (final <= start + 16),
  plateau: final <= 1.35x the 2-minute mark, for RSS and, on the card,
  for allocated device memory (the rows, masks and candidate buffers that
  the JAX soak's CPU-backend RSS held live in device memory here). Before
  the 2-minute mark there is no plateau to judge (``plateau_judged``).

Runs on ``cuda:0``; ``VROD_PLATFORM=cpu`` runs it on the CPU.

Usage: python tools/soak_serve.py [--minutes 30] [--clients 4]
       [--dim 64] [--rows 20000] [--seconds-per-sample 15]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np

PLATEAU_AT_S = 120
PLATEAU_RATIO = 1.35
FD_SLACK = 16


def rss_mb() -> float:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 1024.0
    return -1.0


def fd_count() -> int:
    return len(os.listdir("/proc/self/fd"))


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--minutes", type=float, default=30.0)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--rows", type=int, default=20000)
    ap.add_argument("--seconds-per-sample", type=float, default=15.0)
    args = ap.parse_args(argv)

    import torch
    from vrod_tpu_torch.client import VrodClient
    from vrod_tpu_torch.database import Database
    from vrod_tpu_torch.ops import cuda_topk as K
    from vrod_tpu_torch.server import VrodServer

    rng = np.random.default_rng(0)
    tmp = Path(tempfile.mkdtemp(prefix="vrod_soak_"))
    db = Database.new(tmp, "soak")
    # Budgets sized so the mutator crosses them every few minutes:
    # auto-snapshot + auto-compact run MANY times over the soak.
    db.create_collection(
        "c", dim=args.dim, metric="cosine", dtype="int8",
        segment_rows=8192, auto_snapshot_wal_bytes=8 << 20,
        auto_compact_fraction=0.5)
    col = db.collection("c")
    dev = col.engine.device
    card = card_line() if dev.type == "cuda" else None
    base = rng.standard_normal((args.rows, args.dim)).astype(np.float32)
    col.bulk_insert(base, [f"p{i}" for i in range(args.rows)])
    K.reset_launches()

    addr = f"unix:{tmp}/soak.sock"
    stop = threading.Event()
    counts = {"searches": 0, "mutations": 0, "errors": 0}
    errors: list[str] = []
    lock = threading.Lock()

    def searcher(i: int) -> None:
        r = np.random.default_rng(100 + i)
        with VrodClient(addr) as c:
            while not stop.is_set():
                try:
                    q = r.standard_normal(args.dim).astype(np.float32)
                    hits = c.search_similar("c", q, k=10)
                    assert hits, "empty result from a non-empty collection"
                    with lock:
                        counts["searches"] += 1
                except Exception as e:  # noqa: BLE001 - soak records all
                    with lock:
                        counts["errors"] += 1
                        errors.append(f"searcher: {type(e).__name__}: {e}")
                    return

    def mutator() -> None:
        r = np.random.default_rng(999)
        inserted: list[int] = []
        with VrodClient(addr) as c:
            while not stop.is_set():
                try:
                    vecs = r.standard_normal((32, args.dim)) \
                        .astype(np.float32)
                    ids = c.bulk_insert("c", vecs)
                    inserted.extend(ids)
                    # STEADY-STATE churn: once warm, delete as many as
                    # each round inserts (oldest first). Live rows must
                    # stay ~flat or the plateau check below would flag
                    # DATA growth as a leak; WAL bytes and slot churn still
                    # cross the auto-snapshot/auto-compact budgets
                    # continuously.
                    if len(inserted) >= 512:
                        victims = inserted[:32]
                        del inserted[:32]
                        c.delete("c", victims)
                    with lock:
                        counts["mutations"] += 1
                except Exception as e:  # noqa: BLE001
                    with lock:
                        counts["errors"] += 1
                        errors.append(f"mutator: {type(e).__name__}: {e}")
                    return
                time.sleep(0.05)

    def device_mb() -> dict:
        if dev.type != "cuda":
            return {}
        return {"dev_alloc_mb": torch.cuda.memory_allocated(dev) / 2 ** 20,
                "dev_reserved_mb": torch.cuda.memory_reserved(dev) / 2 ** 20}

    samples = []
    fd0 = fd_count()
    mark = None  # the sample at the 2-minute mark
    # __enter__ alone binds but does not serve (the CLI serves on the
    # calling thread via serve_forever): .start() spawns the serve thread.
    with VrodServer(db, addr).start():
        threads = [threading.Thread(target=searcher, args=(i,), daemon=True)
                   for i in range(args.clients)]
        threads.append(threading.Thread(target=mutator, daemon=True))
        for t in threads:
            t.start()
        t0 = time.time()
        deadline = t0 + args.minutes * 60
        while time.time() < deadline and not stop.is_set():
            time.sleep(args.seconds_per_sample)
            with lock:
                snap = dict(counts)
            samples.append({"t": round(time.time() - t0, 1),
                            "rss_mb": round(rss_mb(), 1),
                            "fds": fd_count(), **device_mb(), **snap})
            if mark is None and time.time() - t0 >= PLATEAU_AT_S:
                mark = samples[-1]
            if snap["errors"]:
                break
            print(json.dumps(samples[-1]), file=sys.stderr, flush=True)
        stop.set()
        for t in threads:
            t.join(timeout=60)
    db.close()

    last = samples[-1] if samples else {"t": 0, "rss_mb": rss_mb(),
                                        **device_mb()}
    wall = last["t"]
    fd_end = fd_count()
    grew = {}
    if mark is not None:
        for key in ("rss_mb", "dev_alloc_mb"):
            if key in mark:
                grew[key] = last[key] > PLATEAU_RATIO * mark[key]
    fd_leak = fd_end > fd0 + FD_SLACK
    ok = counts["errors"] == 0 and not any(grew.values()) and not fd_leak
    summary = {
        "exp": "soak_serve", "ok": ok, "wall_s": wall,
        "searches": counts["searches"], "mutations": counts["mutations"],
        "qps": counts["searches"] / max(wall, 1),
        "errors": counts["errors"], "first_error": errors[0] if errors
        else None,
        "plateau_judged": mark is not None, "leaked": grew,
        "rss_2min_mb": mark and mark["rss_mb"],
        "rss_peak_mb": max((s["rss_mb"] for s in samples),
                           default=last["rss_mb"]),
        "rss_end_mb": last["rss_mb"], "fd_start": fd0, "fd_end": fd_end,
        "samples": len(samples),
        "launches": {n: c for n, c in K.launches.items() if c},
        "device": str(dev), "card": card}
    if dev.type == "cuda":
        summary.update({
            "dev_alloc_2min_mb": mark and mark["dev_alloc_mb"],
            "dev_alloc_peak_mb": max(s["dev_alloc_mb"] for s in samples)
            if samples else last["dev_alloc_mb"],
            "dev_alloc_end_mb": last["dev_alloc_mb"],
            "dev_reserved_end_mb": last["dev_reserved_mb"],
            "dev_max_alloc_mb": torch.cuda.max_memory_allocated(dev)
            / 2 ** 20})
    print(json.dumps(summary), flush=True)
    shutil.rmtree(tmp, ignore_errors=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
