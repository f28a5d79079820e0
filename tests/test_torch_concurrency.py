"""Concurrent read/insert interleavings (SURVEY §5 race-detection row).

Mutations donate device buffers; the collection's RW lock must keep
concurrent searches off buffers a mutation is invalidating. These tests
hammer search+mutate from threads and assert (a) no crashes, (b) exact
results once quiesced.

``tests/test_concurrency.py`` (6 cases) over ``vrod_tpu_torch``, the same
cases and oracles, unchanged but for the package they import.
"""

import threading

import numpy as np
import pytest

from vrod_tpu_torch.utils.locks import RWLock


@pytest.fixture
def tmp_db(tmp_path):
    """The port's database (conftest's ``tmp_db`` is the JAX package's)."""
    from vrod_tpu_torch.database import Database
    db = Database.new(tmp_path, "testdb")
    yield db
    db.close()


def test_rwlock_basics():
    lk = RWLock()
    with lk.read():
        with lk.read():  # concurrent readers OK (different "threads" here same)
            pass
    with lk.write():
        pass


def test_rwlock_excludes():
    lk = RWLock()
    state = {"writers": 0, "readers": 0, "max_r_during_w": 0}
    stop = threading.Event()
    errors = []

    def reader():
        while not stop.is_set():
            with lk.read():
                state["readers"] += 1
                if state["writers"] > 0:
                    errors.append("reader saw writer")
                state["readers"] -= 1

    def writer():
        for _ in range(200):
            with lk.write():
                state["writers"] += 1
                if state["readers"] > 0:
                    errors.append("writer saw readers")
                state["writers"] -= 1

    rs = [threading.Thread(target=reader) for _ in range(4)]
    w = threading.Thread(target=writer)
    for t in rs:
        t.start()
    w.start()
    w.join()
    stop.set()
    for t in rs:
        t.join()
    assert not errors


def test_concurrent_search_and_mutate(tmp_db, rng):
    col = tmp_db.create_collection("cc", dim=16, segment_rows=64)
    base = rng.standard_normal((200, 16)).astype(np.float32)
    rids = col.bulk_insert(base, [f"p{i}" for i in range(200)])

    errors = []
    stop = threading.Event()

    def searcher(tid):
        try:
            while not stop.is_set():
                q = base[(tid * 13) % 200]
                hits = col.search_similar(q, k=3)
                assert len(hits) >= 1
        except Exception as e:  # pragma: no cover
            errors.append(e)

    def mutator():
        try:
            for i in range(60):
                v = rng.standard_normal(16).astype(np.float32)
                rid = col.insert(v, f"new{i}")
                if i % 3 == 0:
                    col.delete(rid)
                if i % 10 == 0:
                    col.reindex()
        except Exception as e:  # pragma: no cover
            errors.append(e)

    searchers = [threading.Thread(target=searcher, args=(t,)) for t in range(3)]
    for t in searchers:
        t.start()
    m = threading.Thread(target=mutator)
    m.start()
    m.join()
    stop.set()
    for t in searchers:
        t.join()
    assert not errors, errors

    # Quiesced state is exact.
    hits = col.search_similar(base[7], k=1)
    assert hits[0].record_id == rids[7]
    assert col.count == 200 + 40  # 60 inserts, 20 deleted


def test_batcher_during_mutations(tmp_db, rng):
    """QueryBatcher keeps serving exact results while a writer mutates."""
    from vrod_tpu_torch.frontend import QueryBatcher
    col = tmp_db.create_collection("qb", dim=16, segment_rows=64)
    base = rng.standard_normal((100, 16)).astype(np.float32)
    col.bulk_insert(base, [f"p{i}" for i in range(100)])
    with QueryBatcher(col, max_batch=32, max_wait_ms=5) as qb:
        futs = [qb.submit(base[i % 100], k=1) for i in range(40)]
        for i in range(30):
            col.insert(rng.standard_normal(16).astype(np.float32), f"n{i}")
        for i, f in enumerate(futs):
            hits = f.result(60)
            assert hits[0].payload == f"p{i % 100}"


def test_group_commit_shares_fsyncs(tmp_path, rng):
    """Concurrent single-record inserts must share fsyncs (group commit)
    while remaining durable-before-ack: every acked insert survives reload."""
    import threading
    from vrod_tpu_torch.collection import Collection
    from vrod_tpu_torch.config import CollectionConfig

    cfg = CollectionConfig(name="gc", dim=8, segment_rows=256)
    col = Collection.create(tmp_path / "gc", cfg, wal_sync=True)

    sync_calls = {"n": 0}
    real_sync = col.wal.sync

    def counting_sync():
        sync_calls["n"] += 1
        real_sync()

    col.wal.sync = counting_sync

    n_threads, per_thread = 8, 10
    errors = []

    def worker(t):
        try:
            for i in range(per_thread):
                col.insert(rng.standard_normal(8), f"t{t}i{i}")
        except Exception as e:  # pragma: no cover
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(t,))
               for t in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    total = n_threads * per_thread
    assert col.count == total
    # Sharing: strictly fewer fsyncs than inserts (in practice far fewer).
    assert sync_calls["n"] < total, (sync_calls, total)
    col.close()
    col2 = Collection.load(tmp_path / "gc")
    assert col2.count == total
    col2.close()


def test_group_commit_with_concurrent_snapshot(tmp_path, rng):
    """Snapshots (which rewrite the WAL file under the committer's
    exclusive lock) must not wedge or drop concurrent acked inserts."""
    import threading
    from vrod_tpu_torch.collection import Collection
    from vrod_tpu_torch.config import CollectionConfig

    cfg = CollectionConfig(name="gs", dim=8, segment_rows=256)
    col = Collection.create(tmp_path / "gs", cfg, wal_sync=True)
    stop = threading.Event()
    errors = []
    acked = []

    def inserter():
        try:
            while not stop.is_set():
                rid = col.insert(rng.standard_normal(8), "d")
                acked.append(rid)
        except Exception as e:  # pragma: no cover
            errors.append(e)

    threads = [threading.Thread(target=inserter) for _ in range(4)]
    for t in threads:
        t.start()
    try:
        for _ in range(5):
            col.snapshot()
    finally:
        stop.set()
        for t in threads:
            t.join()
    assert not errors, errors
    assert col.count == len(acked)
    col.close()
    col2 = Collection.load(tmp_path / "gs")
    assert col2.count == len(acked)
    col2.close()
