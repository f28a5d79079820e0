#!/usr/bin/env python3
"""The PyTorch/CUDA port's bench: ``bench.py``'s six workloads over
``vrod_tpu_torch`` on ``cuda:0``, with its flags, defaults and one JSON
line.

    python3 bench_torch.py [--quick] [--workload search|mixed|batch-sweep|
        scaling|serve|serve-batch] [--metric cosine|l2|dot] [--dtype D]
        [--rows N] [--batch B] [--dim D] [--k K] [--iters N] [--impl I]
        [--precision P] [--shards S] [--margin M] [--clients C]

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "extra"},
``bench.py``'s metric strings and ``extra`` keys, and two more in every
``extra``: ``card`` (the card's name and power limit, as ``nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader`` prints them; null on
the CPU) and ``launches`` (the non-zero counts of
``ops.cuda_topk.launches``, set to 0 before each timed region and summed
over the workload's regions; empty on the CPU, where the wrappers run their
plain versions). The headline (``--workload search`` at its defaults) is
int8 cosine top-16 over 1,000,000 x 768 at batch 256; ``value`` is
queries/s on the card and ``vs_baseline`` that over the NumPy brute force
of ``cpu_qps`` (whatever BLAS threads numpy has, as in ``bench.py``).

It runs on ``cuda:0``; ``VROD_PLATFORM=cpu`` runs it on the CPU with the
kernels' plain versions (then no time in it is a device time). With no
card and no ``VROD_PLATFORM=cpu`` it prints the failed line and exits 1;
a crash prints the failed line with ``error`` and exits 2. The kernels
build at their first use, inside the warm-up (``ops/_build.py``, the
counterpart of ``bench.py``'s compilation cache).

It imports torch, numpy and ``vrod_tpu_torch`` only: each function below
is the counterpart of the ``bench.py`` function its docstring names.
"""

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent


def wait_for_backend(attempts=None, probe_timeout_s=None, backoff_s=None):
    """``bench.py:25-61``: block until the device answers, with bounded
    retries. Each probe runs in a killable subprocess with a timeout (a
    hung driver cannot hang the bench): it resolves the port's device
    (``runtime.default_device()``: ``cuda:0``, or the CPU under
    ``VROD_PLATFORM=cpu``) and runs one small op there. Returns None on
    success, else the last error string."""
    attempts = attempts or int(os.environ.get("VROD_PROBE_ATTEMPTS", "5"))
    probe_timeout_s = probe_timeout_s or float(
        os.environ.get("VROD_PROBE_TIMEOUT_S", "45"))
    backoff_s = backoff_s or float(
        os.environ.get("VROD_PROBE_BACKOFF_S", "15"))
    probe = ("import torch; from vrod_tpu_torch.runtime import "
             "default_device, default_devices; d = default_device(); "
             "torch.ones(8, device=d).sum().item(); "
             "print('VROD_BACKEND_OK', len(default_devices()), d.type)")
    last_err = "backend probe never ran"
    for attempt in range(attempts):
        if attempt:
            time.sleep(backoff_s)
        try:
            r = subprocess.run(
                [sys.executable, "-c", probe], capture_output=True,
                text=True, timeout=probe_timeout_s, cwd=ROOT)
        except subprocess.TimeoutExpired:
            last_err = f"backend probe hung >{probe_timeout_s}s"
            continue
        if r.returncode == 0 and "VROD_BACKEND_OK" in r.stdout:
            return None
        tail = (r.stderr or r.stdout).strip().splitlines()
        last_err = tail[-1] if tail else f"probe rc={r.returncode}"
    return f"backend unavailable after {attempts} attempts: {last_err}"


def fail_json(workload, error, code=1):
    """``bench.py:64-70``: on failure, still ONE parseable JSON line."""
    print(json.dumps({
        "metric": f"bench {workload} (failed)", "value": None,
        "unit": "queries/s", "vs_baseline": None, "error": str(error)[:2000],
    }))
    sys.exit(code)


def card_line():
    """The card's name and power limit (nvidia-smi), or None on the CPU."""
    from vrod_tpu_torch.runtime import default_device
    if default_device().type != "cuda":
        return None
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


def launched():
    """The non-zero counts of the search kernels' launches."""
    from vrod_tpu_torch.ops import cuda_topk
    return {n: c for n, c in cuda_topk.launches.items() if c}


def fill_direct(eng, n_rows, chunk=1 << 20):
    """``bench.py:94-128``: seeded random normal rows, drawn, prepared and
    stored on the engine's device in chunks of at most ``chunk`` rows
    (streaming 3 GB of float32 through the host would time the host, not
    the engine). Each chunk draws from a ``torch.Generator`` seeded with
    its first slot, is prepared by the port's own quantizer
    (``prepare_rows``) and is scattered into the shard lanes that hold its
    slots (``_owned``, ``_scatter``), which marks them live and writes
    their int8/int4 + l2 norms lane: the lane that ``bench.py:124-127``
    rebuilds after its fill (its recall probe read 0.195 when it was
    missing), so no ``rebuild_norms()`` follows."""
    from vrod_tpu_torch.ops import distances as D
    dim, metric = eng.cfg.dim, eng.cfg.metric
    dtype = "int4" if eng.packed else eng.dtype
    g = torch.Generator(device=eng.device)
    for start in range(0, n_rows, chunk):
        n = min(chunk, n_rows - start)
        g.manual_seed(start)
        rows_f = torch.randn((n, dim), generator=g, device=eng.device)
        rows, aux = D.prepare_rows(rows_f, metric=metric, dtype=dtype)
        del rows_f
        slots = np.arange(start, start + n, dtype=np.int64)
        for j, pos, loc in eng._owned(slots):
            lo, hi = int(pos[0]), int(pos[-1]) + 1  # contiguous
            eng._scatter(j, loc, rows[lo:hi], aux[lo:hi])
    sync(eng.device)


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build_engine(n_rows, dim, metric, dtype, shards=1):
    """``bench.py:73-92``: a ``DeviceEngine`` of ``n_rows`` x ``dim`` rows
    (segments of 65,536 rows), filled on its device by ``fill_direct``."""
    from vrod_tpu_torch.config import CollectionConfig
    from vrod_tpu_torch.engine import DeviceEngine
    cfg = CollectionConfig(name="bench", dim=dim, metric=metric, dtype=dtype,
                           segment_rows=65536, shards=shards)
    eng = DeviceEngine(cfg)
    eng.ensure_capacity(n_rows)
    fill_direct(eng, n_rows)
    return eng


def staged_queries(batch, dim, device):
    """``bench.py:130-138``: the query batch from ``default_rng(42)``,
    staged on the device (the bench times the engine, not the host link)."""
    rng = np.random.default_rng(42)
    q = torch.from_numpy(rng.standard_normal((batch, dim)).astype(np.float32))
    q = q.to(device)
    sync(device)
    return q


def device_qps(n_rows, dim, batch, k, iters, metric="cosine",
               dtype="float32", impl=None, precision=None, shards=1,
               rescore_margin=None, percentiles=False):
    """``bench.py:73-187`` (``tpu_qps``): queries/s of ``engine.search`` at
    batch ``batch``, top-``k``, over ``n_rows`` x ``dim`` rows filled on
    the device. The port's engine takes ``impl`` and ``precision`` at each
    search (the JAX engine's attributes); ``margin`` is the search's own
    override, not ``cfg.rescore_margin``. Queries come from
    ``default_rng(42)``, staged on the device first. Warm-up: one search,
    then 5 with ``as_numpy=False``. Then three loops of ``iters`` searches
    with ``as_numpy=False``, each synced once by reading its last slots
    back (the stream runs the searches in order); the best loop is kept.
    With ``percentiles``, p50/p95/p99 of 50 searches, each synced by a
    one-slot readback. Returns (queries/s, batch latency s, the recall
    probe's recall@k, the percentiles or None, the kernels' launches in
    the timed loops and percentiles)."""
    from vrod_tpu_torch.ops import cuda_topk

    eng = build_engine(n_rows, dim, metric, dtype, shards)

    def search(q, **kw):
        return eng.search(q, k, impl=impl, precision=precision,
                          margin=rescore_margin, **kw)

    q = staged_queries(batch, dim, eng.device)

    search(q)
    for _ in range(5):
        v_w, i_w = search(q, as_numpy=False)
    i_w[0, :1].cpu()

    cuda_topk.reset_launches()
    dt = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for i in range(iters):
            vals_d, idx_d = search(q, as_numpy=False)
        idx_d.cpu()
        dt = min(dt, time.perf_counter() - t0)
    qps = batch * iters / dt

    pcts = None
    if percentiles:
        samples = []
        for i in range(50):
            t1 = time.perf_counter()
            v, ix = search(q, as_numpy=False)
            ix[0, :1].cpu()  # a one-slot readback waits for the search
            samples.append(time.perf_counter() - t1)
        a = np.array(samples)
        pcts = {"p50_ms": round(float(np.percentile(a, 50)) * 1e3, 3),
                "p95_ms": round(float(np.percentile(a, 95)) * 1e3, 3),
                "p99_ms": round(float(np.percentile(a, 99)) * 1e3, 3)}
    counts = launched()

    recall = device_recall_probe(eng, q[:8], k, margin=rescore_margin,
                                 impl=impl, precision=precision)
    return qps, dt / iters, recall, pcts, counts


def device_recall_probe(eng, q, k, eps=1e-5, margin=None, impl=None,
                        precision=None):
    """``bench.py:190-213``: recall@k of the production search (``impl``,
    ``precision`` and ``margin`` as the bench ran it) against the exact
    full-N oracle, the plain float32 scan with TF32 off
    (``impl="scan"``, ``precision="exact"``, no rescore), on the device:
    one scalar and the slots cross to the host. Tie-aware: a hit is a
    value within ``eps`` (relative, at least absolute) of the oracle's
    k-th, on the better side (l2: lower is better). Raises if a row of the
    answer holds a slot twice (a masking fault could return one slot k
    times with valid-looking scores)."""
    vals_e, idx_e = eng.search(q, k, as_numpy=False, margin=margin,
                               impl=impl, precision=precision)
    vals_o, _ = eng.search(q, k, impl="scan", precision="exact",
                           rescore=False, as_numpy=False)
    ih = idx_e.cpu().numpy()
    for b in range(ih.shape[0]):
        live = ih[b][ih[b] >= 0]
        assert np.unique(live).size == live.size, \
            f"duplicate slots in top-k row {b}: {ih[b]}"
    kth = vals_o[:, k - 1:k]
    scale = torch.clamp(kth.abs(), min=1.0)
    if eng.cfg.metric == "l2":
        hits = vals_e <= kth + eps * scale
    else:
        hits = vals_e >= kth - eps * scale
    return float(hits.float().mean())


def cpu_qps(n_rows, dim, batch, k, subset, metric="cosine"):
    """Single-CPU NumPy brute force AT THE REQUESTED METRIC, measured on
    `subset` rows and scaled linearly to n_rows (brute-force cost is
    linear in N) — the vs_baseline comparator must run the same workload.
    (``bench.py:216-242``, verbatim.)"""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((subset, dim)).astype(np.float32)
    q = rng.standard_normal((batch, dim)).astype(np.float32)
    if metric == "cosine":
        x = x / np.linalg.norm(x, axis=1, keepdims=True)
        q = q / np.linalg.norm(q, axis=1, keepdims=True)

    def scan(qq):
        if metric == "l2":
            s = (np.sum(qq * qq, axis=1, keepdims=True)
                 - 2.0 * (qq @ x.T) + np.sum(x * x, axis=1)[None, :])
            return np.argpartition(s, k, axis=1)[:, :k]
        s = qq @ x.T  # cosine (pre-normalized) and dot
        return np.argpartition(-s, k, axis=1)[:, :k]

    scan(q[:8])  # warm-up, then best-of-3 (single-core baseline is noisy)
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        scan(q)
        best = min(best, time.perf_counter() - t0)
    dt_scaled = best * (n_rows / subset)
    return batch / dt_scaled


def mixed_workload(n_rows, dim, iters, dtype="float32"):
    """``bench.py:245-301``: mixed insert/delete/search with a compaction
    (REINDEX, timed apart) and a WAL-backed restore; ops/s over the loop.
    The same operations in the same order from the same ``default_rng(3)``
    stream. One difference: ``bench.py:275`` rebuilds the set of the 128
    dead ids once for every live id (262,144 sets an iteration at the
    default size), inside the timed loop; here the set is built once an
    iteration. The live ids, and so the ops, are the same, but the two
    benches' ``mixed`` ops/s are not comparable. Returns (ops/s, restore s, final count, reindex s, the
    kernels' launches in the loop)."""
    import gc
    import tempfile
    from vrod_tpu_torch.database import Database
    from vrod_tpu_torch.ops import cuda_topk

    rng = np.random.default_rng(3)
    with tempfile.TemporaryDirectory() as tmp:
        db = Database.new(tmp, "benchdb", wal_sync=False)
        col = db.create_collection("m", dim=dim, segment_rows=65536,
                                   dtype=dtype)
        base = rng.standard_normal((n_rows, dim)).astype(np.float32)
        col.bulk_insert(base)
        # Warm every shape the loop uses (insert 256, delete 128, search
        # 64) and build the kernels, so the loop measures steady state.
        warm_ids = col.bulk_insert(base[:256])
        col.delete_many(warm_ids[:128])
        col.delete_many(warm_ids[128:])
        col.search_similar(base[:64], k=10)
        cuda_topk.reset_launches()
        ops_done = 0
        reindex_s = 0.0
        t0 = time.perf_counter()
        live_ids = list(range(1, n_rows + 1))
        for i in range(iters):
            ins = rng.standard_normal((256, dim)).astype(np.float32)
            new_ids = col.bulk_insert(ins)
            ops_done += 256
            dead = rng.choice(live_ids, size=128, replace=False)
            col.delete_many(dead)
            dead_set = set(dead.tolist())
            live_ids = [x for x in live_ids if x not in dead_set]
            live_ids.extend(new_ids.tolist())
            ops_done += 128
            col.search_similar(ins[:64], k=10)
            ops_done += 64
            if i == iters // 2:
                # The compaction writes a full snapshot (device -> host
                # gather + disk): a maintenance event, reported apart.
                tr = time.perf_counter()
                col.reindex()
                reindex_s = time.perf_counter() - tr
        dt = time.perf_counter() - t0 - reindex_s
        counts = launched()
        # The restore: free the first copy's device state before loading
        # the second.
        t1 = time.perf_counter()
        db.close()
        del col, db
        gc.collect()
        db2 = Database.load(f"{tmp}/benchdb", wal_sync=False)
        col2 = db2.collection("m")
        restore_s = time.perf_counter() - t1
        count = col2.count
        db2.close()
        return ops_done / dt, restore_s, count, reindex_s, counts


def serve_workload(n_rows, dim, k, n_clients, per_client, dtype,
                   req_batch=1):
    """``bench.py:304-409``: end-to-end serving. A ``VrodServer`` on a unix
    socket over a temporary database, ``n_clients`` concurrent
    ``VrodClient`` connections (threads of this process), each issuing
    single-query searches that the server's batcher packs into shared
    batches; every query is a stored vector whose top-1 must be itself.
    ``req_batch > 1`` sends batched requests instead
    (``search_similar_batch``: one engine call a request, packed binary
    responses). Returns (client-observed queries/s, queries per batch,
    client p50 s, client p99 s, the server's ``server.request``
    quantiles, the kernels' launches while the clients ran)."""
    import tempfile
    import threading
    from vrod_tpu_torch import metrics
    from vrod_tpu_torch.client import VrodClient
    from vrod_tpu_torch.database import Database
    from vrod_tpu_torch.engine import BATCH_BUCKETS, _bucket
    from vrod_tpu_torch.ops import cuda_topk
    from vrod_tpu_torch.server import VrodServer

    rng = np.random.default_rng(5)
    with tempfile.TemporaryDirectory() as tmp:
        db = Database.new(tmp, "servedb", wal_sync=False)
        col = db.create_collection("s", dim=dim, dtype=dtype,
                                   segment_rows=min(n_rows, 262144))
        vecs = rng.standard_normal((n_rows, dim)).astype(np.float32)
        for i in range(0, n_rows, 65536):  # bounded WAL frames / host RAM
            col.bulk_insert(vecs[i:i + 65536])
        # Warm every batch bucket the batcher can produce with N clients,
        # the covering bucket included when N is not a bucket itself.
        cover = _bucket(min(n_clients if req_batch == 1 else req_batch,
                            256), BATCH_BUCKETS)
        buckets = sorted(
            {b for b in BATCH_BUCKETS if b <= cover} | {1, cover})
        for b in buckets:
            col.search_similar(vecs[:b], k)
        with VrodServer(db, f"unix:{tmp}/bench.sock",
                        max_wait_ms=2.0) as server:
            server.start()
            errors = []
            start = threading.Barrier(n_clients + 1)
            lat = [[] for _ in range(n_clients)]

            def worker(tid):
                try:
                    with VrodClient(server.address) as c:
                        start.wait(timeout=120)
                        if req_batch > 1:
                            for _ in range(per_client):
                                idx = rng.integers(0, n_rows,
                                                   size=req_batch)
                                t0 = time.perf_counter()
                                bat = c.search_similar_batch(
                                    "s", vecs[idx], k=k)
                                lat[tid].append(time.perf_counter() - t0)
                                for j, i in enumerate(idx):
                                    if bat[j][0].record_id != int(i) + 1:
                                        raise AssertionError(
                                            f"row {j} of query batch: "
                                            f"top-1 {bat[j][0].record_id}"
                                            f" want {int(i) + 1}")
                            return
                        idx = rng.integers(0, n_rows, size=per_client)
                        for i in idx:
                            t0 = time.perf_counter()
                            hits = c.search_similar("s", vecs[i], k=k)
                            lat[tid].append(time.perf_counter() - t0)
                            if hits[0].record_id != int(i) + 1:
                                raise AssertionError(
                                    f"query {i}: top-1 {hits[0].record_id}")
                except Exception as e:
                    errors.append(e)
                    start.abort()

            before = metrics.counters.snapshot()
            cuda_topk.reset_launches()
            threads = [threading.Thread(target=worker, args=(t,))
                       for t in range(n_clients)]
            for t in threads:
                t.start()
            try:
                start.wait(timeout=120)
            except threading.BrokenBarrierError:
                for t in threads:
                    t.join(timeout=10)
                raise (errors[0] if errors
                       else RuntimeError("client barrier broke"))
            t0 = time.perf_counter()
            for t in threads:
                t.join()
            dt = time.perf_counter() - t0
            if errors:
                raise errors[0]
            after = metrics.counters.snapshot()
            counts = launched()
        db.close()
        queries = n_clients * per_client * req_batch
        batches = (after.get("frontend.batch", 0)
                   - before.get("frontend.batch", 0))
        all_lat = sorted(x for per in lat for x in per)
        p50 = all_lat[len(all_lat) // 2]
        p99 = all_lat[min(len(all_lat) - 1, int(len(all_lat) * 0.99))]
        # The server's own view (no client codec or socket).
        srv = metrics.latencies.quantiles("server.request")
        return (queries / dt, queries / max(batches, 1), p50, p99, srv,
                counts)


def add_counts(total, counts):
    for name, c in counts.items():
        total[name] = total.get(name, 0) + c
    return total


def parse_args(argv=None):
    """``bench.py:415-454``: the same flags, choices and defaults."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="small config for smoke runs")
    ap.add_argument("--rows", type=int, default=None)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--dim", type=int, default=768,
                    help="vector dimension (search workload; config 1 uses "
                    "128)")
    ap.add_argument("--k", type=int, default=16)
    ap.add_argument("--iters", type=int, default=None)
    # int8 storage is the headline default; bf16/f32/int4 via --dtype.
    # (Resolved after parsing: int8 falls back to bfloat16 where int8 + l2
    # is unsupported, dim > 1040.)
    ap.add_argument("--dtype", default=None)
    ap.add_argument("--impl", default=None)
    ap.add_argument("--precision", default=None)
    ap.add_argument("--workload", default="search",
                    choices=["search", "mixed", "batch-sweep", "scaling",
                             "serve", "serve-batch"])
    ap.add_argument("--clients", type=int, default=32,
                    help="concurrent connections for --workload serve")
    ap.add_argument("--shards", type=int, default=1)
    ap.add_argument("--metric", default="cosine",
                    choices=["cosine", "l2", "dot"])
    ap.add_argument("--margin", type=int, default=None,
                    help="override rescore candidate margin (k_scan = "
                    "k_out + margin)")
    args = ap.parse_args(argv)
    if args.dtype is None:
        # int8 everywhere but int8 + l2 above dim 1040 (the config's cap:
        # |q8|^2 exact in float32), which falls back to bfloat16 so the
        # one-JSON-line contract holds.
        args.dtype = ("bfloat16" if args.metric == "l2" and args.dim > 1040
                      else "int8")
    return args


def main(args):
    """``bench.py:412-600``: run the workload ``args`` name and print its
    line."""
    err = wait_for_backend()
    if err:
        fail_json(args.workload, err)
    # Exact float32 oracle products: no TF32 outside the kernels.
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()

    if args.workload == "batch-sweep":
        # BASELINE config 3: top-100 over a large collection, batch sweep.
        n_rows = args.rows or (131072 if args.quick else 1_000_000)
        iters = args.iters or (3 if args.quick else 60)
        curve, counts = {}, {}
        for b in (1, 16, 64, 256, 1024):
            qps, lat, recall, _, c = device_qps(n_rows, 768, b, 100, iters,
                                                dtype=args.dtype,
                                                shards=args.shards)
            add_counts(counts, c)
            curve[str(b)] = {"qps": round(qps, 1),
                             "batch_latency_ms": round(lat * 1e3, 3),
                             "recall_full_scan@k": recall}
        best = max(v["qps"] for v in curve.values())
        print(json.dumps({
            "metric": f"exact cosine top-100 QPS/chip, {n_rows}x768, "
                      "batch sweep",
            "value": best, "unit": "queries/s", "vs_baseline": None,
            "extra": {"curve": curve, "card": card, "launches": counts},
        }))
        return

    if args.workload == "scaling":
        # BASELINE config 5: rows sharded over the cards, merged.
        from vrod_tpu_torch.runtime import default_devices
        n_dev = len(default_devices())
        n_rows = args.rows or (131072 if args.quick else 1_000_000)
        iters = args.iters or (3 if args.quick else 10)
        curve, counts = {}, {}
        shards_list = [s for s in (1, 2, 4, 8) if s <= n_dev]
        recall = None
        for s in shards_list:
            qps, lat, recall, _, c = device_qps(n_rows, 768, args.batch,
                                                args.k, iters,
                                                dtype=args.dtype, shards=s)
            add_counts(counts, c)
            curve[str(s)] = round(qps, 1)
        base = curve[str(shards_list[0])]
        print(json.dumps({
            "metric": f"exact cosine top-{args.k} QPS scaling, {n_rows}x768",
            "value": curve[str(shards_list[-1])], "unit": "queries/s",
            "vs_baseline": round(curve[str(shards_list[-1])] / base, 2),
            "extra": {"qps_by_shards": curve, "devices_available": n_dev,
                      "recall_full_scan@k": recall, "card": card,
                      "launches": counts},
        }))
        return

    if args.workload == "serve":
        # Concurrent batch-1 clients through the socket server; the
        # frontend's cross-client batching is what this measures.
        n_rows = args.rows or (32768 if args.quick else 262144)
        per_client = args.iters or (4 if args.quick else 40)
        qps, batch_ratio, p50, p99, srv, counts = serve_workload(
            n_rows, args.dim, args.k, args.clients, per_client,
            dtype=args.dtype)
        print(json.dumps({
            "metric": f"end-to-end served QPS, {n_rows}x{args.dim}, "
                      f"{args.clients} batch-1 clients",
            "value": round(qps, 1),
            "unit": "queries/s",
            "vs_baseline": None,
            "extra": {"avg_queries_per_tile": round(batch_ratio, 1),
                      "client_p50_ms": round(p50 * 1e3, 2),
                      "client_p99_ms": round(p99 * 1e3, 2),
                      "server_request": srv,
                      "recall_spotcheck": 1.0, "card": card,
                      "launches": counts},
        }))
        return

    if args.workload == "serve-batch":
        # Few clients, big batched requests (binary vectors in, raw packed
        # hits out): one engine call a request, so scan + wire codec.
        n_rows = args.rows or (32768 if args.quick else 262144)
        per_client = args.iters or (3 if args.quick else 20)
        n_clients = min(args.clients, 4) if args.clients == 32 \
            else args.clients
        qps, _, p50, p99, srv, counts = serve_workload(
            n_rows, args.dim, args.k, n_clients, per_client,
            dtype=args.dtype, req_batch=args.batch)
        print(json.dumps({
            "metric": f"served batched QPS, {n_rows}x{args.dim}, "
                      f"{n_clients} clients x batch {args.batch} "
                      f"top-{args.k}",
            "value": round(qps, 1),
            "unit": "queries/s",
            "vs_baseline": None,
            "extra": {"request_p50_ms": round(p50 * 1e3, 2),
                      "request_p99_ms": round(p99 * 1e3, 2),
                      "server_request": srv,
                      "recall_spotcheck": 1.0, "card": card,
                      "launches": counts},
        }))
        return

    if args.workload == "mixed":
        n_rows = args.rows or (65536 if args.quick else 262144)
        ops_s, restore_s, count, reindex_s, counts = mixed_workload(
            n_rows, 768, args.iters or (3 if args.quick else 10),
            dtype=args.dtype)
        print(json.dumps({
            "metric": f"mixed insert/delete/search ops/s, base {n_rows}x768",
            "value": round(ops_s, 1),
            "unit": "ops/s",
            "vs_baseline": None,
            "extra": {"restore_seconds": round(restore_s, 2),
                      "reindex_seconds": round(reindex_s, 2),
                      "final_count": count, "card": card,
                      "launches": counts},
        }))
        return

    n_rows = args.rows or (131072 if args.quick else 1_000_000)
    iters = args.iters or (5 if args.quick else 240)
    dim, batch, k = args.dim, args.batch, args.k

    qps, lat, recall, pcts, counts = device_qps(
        n_rows, dim, batch, k, iters, metric=args.metric, dtype=args.dtype,
        impl=args.impl, precision=args.precision,
        rescore_margin=args.margin, percentiles=True)
    cpu = cpu_qps(n_rows, dim, batch, k, metric=args.metric,
                  subset=min(n_rows, 65536 if args.quick else 131072))

    print(json.dumps({
        "metric": f"exact {args.metric} top-{k} QPS/chip, {n_rows}x{dim}, "
                  f"batch {batch}",
        "value": round(qps, 1),
        "unit": "queries/s",
        "vs_baseline": round(qps / cpu, 2),
        "extra": {
            "batch_latency_ms": round(lat * 1e3, 3),
            "latency_percentiles": pcts,
            "recall_full_scan@k": recall,
            "cpu_brute_force_qps": round(cpu, 2),
            "dtype": args.dtype,
            "card": card,
            "launches": counts,
        },
    }))


if __name__ == "__main__":
    _args = parse_args()
    try:
        main(_args)
    except Exception as e:
        # A crash mid-run still leaves one parseable JSON line.
        import traceback
        traceback.print_exc(file=sys.stderr)
        fail_json(_args.workload, f"{type(e).__name__}: {e}", code=2)
