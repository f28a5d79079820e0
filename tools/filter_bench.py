#!/usr/bin/env python3
"""Filtered-search overhead of the PyTorch/CUDA port at 1M x 768, at engine
level (no host hit objects): ``experiments/filter_bench.py`` over
``vrod_tpu_torch``.

    python tools/filter_bench.py [--rows 1048576] [--dtype bfloat16|int8]
        [--dim 768] [--batch 256] [--iters 40]

Rows are drawn on the device from a seeded ``torch.Generator`` and stored
by the port's own quantizer (``distances.prepare_rows``) straight into the
engine's one shard (cosine). It measures the mask build (host slot list ->
device bool mask, ``engine.filter_mask_from_slots``: the first build, and
the mean of 10 more) and the search with a reused mask, the steady state
in which callers keep the mask for repeated queries: unfiltered, excluding
100,000 slots, and within 10,000 (at most a quarter and a sixteenth of the
rows), each over ``--iters`` searches of one batch, back to back
(``latency_ms``: the window's mean, ``torch.cuda.synchronize`` at both
ends) and one at a time (``p50_ms``, synchronized after each). It asserts
that no excluded slot comes back and that every slot returned lies in the
allowlist, and prints ONE JSON line, with the card's name and power limit
(nvidia-smi) and the search kernels' launches on the CUDA device.

Runs on ``cuda:0``; ``VROD_PLATFORM=cpu`` runs it on the CPU with the
kernels' plain versions (then no time in it is a device time).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

FILL_CHUNK = 131072
TOP_K = 16
SEED = 0


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


def sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def fill(eng, n_rows, dim):
    """Seeded random normal rows, made and stored on the engine's device."""
    import torch
    from vrod_tpu_torch.ops import distances as D
    g = torch.Generator(device=eng.device)
    g.manual_seed(SEED)
    dtype = eng.cfg.dtype
    for start in range(0, n_rows, FILL_CHUNK):
        n = min(FILL_CHUNK, n_rows - start)
        rows_f = torch.randn((n, dim), generator=g, device=eng.device)
        rows, aux = D.prepare_rows(rows_f, metric=eng.cfg.metric,
                                   dtype=dtype)
        eng.x[start:start + n] = rows
        eng.aux[start:start + n] = aux
        eng.valid[start:start + n] = True
    eng.rebuild_norms()
    sync(eng.device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=1 << 20)
    ap.add_argument("--dim", type=int, default=768)
    ap.add_argument("--dtype", default="bfloat16",
                    choices=("bfloat16", "int8"))
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--iters", type=int, default=40)
    args = ap.parse_args(argv)

    import torch
    from vrod_tpu_torch.config import CollectionConfig
    from vrod_tpu_torch.engine import DeviceEngine
    from vrod_tpu_torch.ops import cuda_topk as K

    n_rows, dim, B, k = args.rows, args.dim, args.batch, TOP_K
    cfg = CollectionConfig(name="fb", dim=dim, metric="cosine",
                           dtype=args.dtype, segment_rows=65536)
    eng = DeviceEngine(cfg)
    dev = eng.device
    card = card_line() if dev.type == "cuda" else None
    if card:
        torch.backends.cuda.matmul.allow_tf32 = False
    eng.ensure_capacity(n_rows)
    fill(eng, n_rows, dim)

    rng = np.random.default_rng(SEED + 1)
    q = torch.from_numpy(
        rng.standard_normal((B, dim)).astype(np.float32)).to(dev)
    K.reset_launches()

    def timed(fmask):
        """(queries/s and mean ms of the back-to-back window, p50 ms of
        single synchronized searches, the window's last slots)."""
        for _ in range(5):
            v, i = eng.search(q, k, as_numpy=False, filter_mask=fmask)
        sync(dev)
        t0 = time.perf_counter()
        for _ in range(args.iters):
            v, i = eng.search(q, k, as_numpy=False, filter_mask=fmask)
        sync(dev)
        dt = (time.perf_counter() - t0) / args.iters
        lat = []
        for _ in range(args.iters):
            t1 = time.perf_counter()
            eng.search(q, k, as_numpy=False, filter_mask=fmask)
            sync(dev)
            lat.append(time.perf_counter() - t1)
        return B / dt, dt * 1e3, float(np.median(lat)) * 1e3, i.cpu().numpy()

    qps0, lat0, p50_0, _ = timed(None)

    n_deny = min(100_000, n_rows // 4)
    n_allow = min(10_000, n_rows // 16)
    deny = rng.choice(n_rows, size=n_deny, replace=False).astype(np.int64)
    t0 = time.perf_counter()
    mask = eng.filter_mask_from_slots(deny, mode="exclude")
    sync(dev)
    build_cold_ms = (time.perf_counter() - t0) * 1e3
    deny2 = rng.choice(n_rows, size=n_deny, replace=False).astype(np.int64)
    t0 = time.perf_counter()
    for _ in range(10):
        eng.filter_mask_from_slots(deny2, mode="exclude")
    sync(dev)
    build_ms = (time.perf_counter() - t0) * 1e2  # warm, per build
    qps1, lat1, p50_1, i1 = timed(mask)
    assert not np.isin(i1.ravel(), deny).any(), "excluded slots leaked"

    allow = rng.choice(n_rows, size=n_allow, replace=False).astype(np.int64)
    mask2 = eng.filter_mask_from_slots(allow, mode="within")
    qps2, lat2, p50_2, i2 = timed(mask2)
    assert np.isin(i2.ravel(), allow).all(), "allowlist violated"

    rec = {"variant": "filtered_search", "ok": True, "rows": n_rows,
           "dim": dim, "batch": B, "k": k, "dtype": args.dtype,
           "excluded": n_deny, "within": n_allow,
           "unfiltered_qps": qps0, "exclude_qps": qps1, "within_qps": qps2,
           "mask_build_ms": build_ms, "mask_build_cold_ms": build_cold_ms,
           "latency_ms": [lat0, lat1, lat2], "p50_ms": [p50_0, p50_1, p50_2],
           "launches": {n: c for n, c in K.launches.items() if c},
           "device": str(dev), "card": card, "tag": "filter-bench"}
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
