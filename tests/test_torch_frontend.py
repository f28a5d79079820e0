"""The port's batched query frontend (``vrod_tpu_torch.frontend``): the
cases of ``tests/test_frontend.py`` over the port's Collection on the CPU.
"""

import threading

import numpy as np
import pytest

from vrod_tpu_torch import metrics
from vrod_tpu_torch.database import Database
from vrod_tpu_torch.frontend import QueryBatcher


@pytest.fixture
def tmp_db(tmp_path):
    """The port's Database (conftest's ``tmp_db`` is the JAX package's)."""
    db = Database.new(tmp_path, "testdb")
    yield db
    db.close()


@pytest.fixture
def col(tmp_db, rng):
    c = tmp_db.create_collection("f", dim=16, segment_rows=64)
    vecs = rng.standard_normal((300, 16)).astype(np.float32)
    c.bulk_insert(vecs, [f"p{i}" for i in range(300)])
    c._test_vecs = vecs
    return c


def test_single_query(col):
    with QueryBatcher(col, max_wait_ms=1) as qb:
        hits = qb.search(col._test_vecs[42], k=3)
    assert hits[0].payload == "p42"


def test_concurrent_queries_batched(col):
    n_threads = 32
    results = [None] * n_threads
    with QueryBatcher(col, max_batch=64, max_wait_ms=20) as qb:
        def worker(i):
            results[i] = qb.search(col._test_vecs[i], k=1)
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    for i, hits in enumerate(results):
        assert hits[0].payload == f"p{i}", i


def test_mixed_k_groups(col):
    with QueryBatcher(col, max_wait_ms=20) as qb:
        f1 = qb.submit(col._test_vecs[1], k=1)
        f2 = qb.submit(col._test_vecs[2], k=5)
        assert f1.result(30)[0].payload == "p1"
        assert len(f2.result(30)) == 5


def test_closed_batcher_rejects(col):
    qb = QueryBatcher(col)
    qb.close()
    with pytest.raises(RuntimeError):
        qb.submit(col._test_vecs[0])


def test_error_propagates(col):
    with QueryBatcher(col, max_wait_ms=1) as qb:
        # Malformed per-client input fails fast at submit (it must not
        # poison the packed batch)...
        with pytest.raises(ValueError):
            qb.submit(np.zeros(7, dtype=np.float32))  # wrong dim
        # ...while an execution-time error still propagates via the Future.
        fut = qb.submit(col._test_vecs[0], k=0)  # engine rejects k < 1
        with pytest.raises(Exception):
            fut.result(30)


def test_counters_and_query_log(col):
    records = []
    metrics.query_log.configure(records.append)
    metrics.counters.reset()
    with QueryBatcher(col, max_wait_ms=1) as qb:
        qb.search(col._test_vecs[0], k=2)
    metrics.query_log.configure(None)
    assert metrics.counters.get("frontend.batch") == 1
    assert metrics.counters.get("collection.search") == 1
    events = {r["event"] for r in records}
    assert events == {"frontend.batch", "collection.search"}
    assert all(r["k"] == 2 and "latency_ms" in r for r in records)


def test_timed_context():
    metrics.counters.reset()
    with metrics.timed("custom.op", foo="bar"):
        pass
    assert metrics.counters.get("custom.op") == 1


def test_profile_context(tmp_path, col):
    from vrod_tpu_torch import metrics
    metrics_dir = tmp_path / "trace"
    with metrics.profile(str(metrics_dir)):
        col.search_similar(col._test_vecs[0], k=2)
    # torch.profiler writes a Chrome trace JSON
    assert any(metrics_dir.rglob("*.xplane.pb")) or any(metrics_dir.iterdir())


def test_batched_filters_grouped_and_isolated(col):
    """Queries with different filters in one micro-batch window each get
    their own filter; same-filter queries share one engine call."""
    import concurrent.futures as cf
    vec = col._test_vecs[42]
    with QueryBatcher(col, max_wait_ms=50) as qb:
        f_plain = qb.submit(vec, k=3)
        f_within = qb.submit(vec, k=3, within_ids=[10, 11, 12])
        f_within2 = qb.submit(vec, k=3, within_ids=[12, 11, 10])  # same group
        f_excl = qb.submit(vec, k=3, exclude_ids=[43])  # record 43 = vecs[42]
        plain, within, within2, excl = (
            f_plain.result(30), f_within.result(30), f_within2.result(30),
            f_excl.result(30))
    assert plain[0].record_id == 43  # query == stored vector 42 -> id 43
    assert {h.record_id for h in within} <= {10, 11, 12}
    assert [h.record_id for h in within] == [h.record_id for h in within2]
    assert 43 not in {h.record_id for h in excl}


def test_batcher_filter_validation(col):
    with QueryBatcher(col, max_wait_ms=1) as qb:
        import pytest
        with pytest.raises(ValueError, match="not both"):
            qb.submit(col._test_vecs[0], k=2, within_ids=[1], exclude_ids=[2])


def test_submit_dim_mismatch_raises_and_worker_survives(col):
    import numpy as np
    import pytest
    with QueryBatcher(col, max_wait_ms=1) as qb:
        with pytest.raises(ValueError, match="dim"):
            qb.submit(np.zeros(7, np.float32), k=2)
        # the worker is still alive and serving
        hits = qb.search(col._test_vecs[11], k=2)
        assert hits[0].payload == "p11"


def test_submit_rejects_misshaped_queries(tmp_db, rng):
    """A (2, dim/2) matrix or a (dim, 1) column has the right total size
    but must be rejected, not silently flattened and searched."""
    import pytest
    from vrod_tpu_torch.frontend import QueryBatcher

    col = tmp_db.create_collection("shape", dim=8, segment_rows=64)
    col.bulk_insert(rng.standard_normal((4, 8)).astype(np.float32))
    with QueryBatcher(col) as qb:
        with pytest.raises(ValueError, match="1-D"):
            qb.submit(np.zeros((2, 4), dtype=np.float32))
        with pytest.raises(ValueError, match="1-D"):
            qb.submit(np.zeros((8, 1), dtype=np.float32))
        hits = qb.search(np.zeros(8, dtype=np.float32), k=2)
        assert len(hits) == 2
        # (1, dim) — the common single-text embedding-library shape — is
        # unambiguous and accepted.
        hits = qb.search(np.zeros((1, 8), dtype=np.float32), k=2)
        assert len(hits) == 2
