"""Serving-path example: concurrent clients through the QueryBatcher with
filters, mutations, and budget-triggered auto-snapshots — the production
shape of the frontend. The program of ``examples/serving.py``, over the
PyTorch/CUDA port ``vrod_tpu_torch``. Runs on the GPU (``cuda:0``), or on
the CPU with ``VROD_PLATFORM=cpu``:

    python examples/torch_serving.py
"""

import tempfile
import threading
import time

import numpy as np

from vrod_tpu_torch import Database, metrics
from vrod_tpu_torch.frontend import QueryBatcher

import os

DIM, N_ROWS, N_CLIENTS = 64, 5000, 8
SECONDS = float(os.environ.get("VROD_EXAMPLE_SECONDS", "3.0"))


def main():
    rng = np.random.default_rng(0)
    with tempfile.TemporaryDirectory() as tmp:
        db = Database.new(tmp, "serving")
        col = db.create_collection(
            "items", dim=DIM, segment_rows=4096,
            auto_snapshot_wal_bytes=1 << 20,   # snapshot past 1 MB of WAL
            payload_store="memory")
        vecs = rng.standard_normal((N_ROWS, DIM)).astype(np.float32)
        ids = col.bulk_insert(vecs, payloads=[f"item-{i}" for i in range(N_ROWS)])
        premium = ids[: N_ROWS // 10]          # an id-filter a client might use

        stop = threading.Event()
        served = [0] * N_CLIENTS

        def client(cid: int, qb: QueryBatcher):
            r = np.random.default_rng(cid)
            while not stop.is_set():
                q = r.standard_normal(DIM).astype(np.float32)
                if cid % 3 == 0:               # this client only sees "premium"
                    hits = qb.search(q, k=5, within_ids=premium)
                    assert all(h.record_id in set(premium.tolist())
                               for h in hits)
                else:
                    hits = qb.search(q, k=5)
                served[cid] += 1

        def mutator():
            r = np.random.default_rng(99)
            while not stop.is_set():
                col.bulk_insert(
                    r.standard_normal((64, DIM)).astype(np.float32))
                time.sleep(0.05)

        with QueryBatcher(col, max_batch=256, max_wait_ms=2) as qb:
            threads = [threading.Thread(target=client, args=(i, qb))
                       for i in range(N_CLIENTS)]
            threads.append(threading.Thread(target=mutator))
            for t in threads:
                t.start()
            time.sleep(SECONDS)
            stop.set()
            for t in threads:
                t.join()

        c = metrics.counters.snapshot()
        print(f"served {sum(served)} queries from {N_CLIENTS} clients "
              f"in {SECONDS:.0f}s ({sum(served) / SECONDS:.0f} q/s, "
              f"{c.get('frontend.batch', 0)} packed batches)")
        print(f"auto-snapshots: {c.get('collection.auto_snapshots', 0)}, "
              f"inserts: {c.get('collection.inserts', 0)}")
        db.close()


if __name__ == "__main__":
    main()
