"""Search correctness vs a NumPy brute-force oracle (exact recall = 1.0).

Covers: all three metrics, 1- and 8-shard meshes, both dtypes, deletes
masked out, k larger than the live set, batch queries, rescore on/off.

``tests/test_search.py`` (14 cases) over ``vrod_tpu_torch``, the same cases
and oracles. Rewritten to the port's device API: an 8-shard engine is
``DeviceEngine(cfg, devices=[cpu] * 8)`` (torch has one CPU device, JAX's
tests force 8), and the pre-staged device query of
``test_device_query_and_device_results`` is a torch tensor on the engine's
device, whose ``as_numpy=False`` results are torch tensors where JAX's are
``jax.Array``.
"""

import numpy as np
import pytest
import torch

from vrod_tpu_torch.config import CollectionConfig
from vrod_tpu_torch.engine import DeviceEngine

from conftest import numpy_topk_oracle


@pytest.fixture
def tmp_db(tmp_path):
    """The port's database (conftest's ``tmp_db`` is the JAX package's)."""
    from vrod_tpu_torch.database import Database
    db = Database.new(tmp_path, "testdb")
    yield db
    db.close()


def make_engine(metric="cosine", shards=1, dtype="float32", dim=48,
                segment_rows=128):
    cfg = CollectionConfig(name="t", dim=dim, metric=metric, dtype=dtype,
                           segment_rows=segment_rows, shards=shards)
    return DeviceEngine(cfg, devices=[torch.device("cpu")] * shards)


def fill(eng, rng, n, dim):
    vecs = rng.standard_normal((n, dim)).astype(np.float32)
    eng.ensure_capacity(n)
    eng.write(np.arange(n, dtype=np.uint64), vecs)
    return vecs


@pytest.mark.parametrize("metric", ["cosine", "l2", "dot"])
@pytest.mark.parametrize("shards", [1, 8])
def test_exact_recall(metric, shards, rng):
    eng = make_engine(metric=metric, shards=shards)
    n, dim, k = 1500, 48, 10
    vecs = fill(eng, rng, n, dim)
    q = rng.standard_normal((4, dim)).astype(np.float32)
    vals, idx = eng.search(q, k)
    oracle_idx, _ = numpy_topk_oracle(vecs, np.arange(n), q, k, metric)
    for b in range(q.shape[0]):
        assert set(idx[b]) == set(oracle_idx[b]), (metric, shards, b)


@pytest.mark.parametrize("metric", ["cosine", "l2", "dot"])
def test_deletes_never_returned(metric, rng):
    eng = make_engine(metric=metric)
    n, dim = 800, 48
    vecs = fill(eng, rng, n, dim)
    dead = np.arange(0, n, 3)
    eng.erase(dead)
    q = rng.standard_normal((2, dim)).astype(np.float32)
    vals, idx = eng.search(q, 20)
    assert not set(idx.ravel().tolist()) & set(dead.tolist())
    live = np.setdiff1d(np.arange(n), dead)
    oracle_idx, _ = numpy_topk_oracle(vecs, live, q, 20, metric)
    for b in range(2):
        assert set(idx[b]) == set(oracle_idx[b])


def test_k_exceeds_live_count(rng):
    eng = make_engine()
    vecs = fill(eng, rng, 5, 48)
    q = rng.standard_normal((1, 48)).astype(np.float32)
    vals, idx = eng.search(q, 50)
    valid = idx[0][idx[0] >= 0]
    assert len(valid) == 5
    assert set(valid.tolist()) == set(range(5))
    # the padding ranks are marked empty
    assert (idx[0][5:] == -1).all() or np.isneginf(vals[0][5:]).all()


def test_empty_collection(rng):
    eng = make_engine()
    q = rng.standard_normal((1, 48)).astype(np.float32)
    vals, idx = eng.search(q, 10)
    assert (idx == -1).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dtypes(dtype, rng):
    eng = make_engine(dtype=dtype)
    n, dim = 600, 48
    vecs = fill(eng, rng, n, dim)
    q = vecs[37:38]  # query equal to a stored vector: must return itself first
    vals, idx = eng.search(q, 5)
    assert idx[0, 0] == 37


def test_scores_match_oracle_values(rng):
    for metric in ("cosine", "l2", "dot"):
        eng = make_engine(metric=metric)
        n, dim = 400, 48
        vecs = fill(eng, rng, n, dim)
        q = rng.standard_normal((3, dim)).astype(np.float32)
        vals, idx = eng.search(q, 5)
        oracle_idx, oracle_scores = numpy_topk_oracle(
            vecs, np.arange(n), q, 5, metric)
        np.testing.assert_allclose(vals, oracle_scores, rtol=2e-4, atol=2e-4)


def test_batched_equals_single(rng):
    eng = make_engine()
    fill(eng, rng, 700, 48)
    q = rng.standard_normal((17, 48)).astype(np.float32)
    vals_b, idx_b = eng.search(q, 10)
    for b in [0, 7, 16]:
        vals_s, idx_s = eng.search(q[b:b + 1], 10)
        np.testing.assert_array_equal(idx_b[b], idx_s[0])


def test_rescore_path(rng):
    eng = make_engine()
    fill(eng, rng, 900, 48)
    q = rng.standard_normal((2, 48)).astype(np.float32)
    v1, i1 = eng.search(q, 10, rescore=True)
    v2, i2 = eng.search(q, 10, rescore=False)
    np.testing.assert_array_equal(i1, i2)


def test_growth_recompiles_and_stays_exact(rng):
    eng = make_engine(shards=8, segment_rows=64)
    dim = 48
    vecs1 = rng.standard_normal((400, dim)).astype(np.float32)
    eng.ensure_capacity(400)
    eng.write(np.arange(400, dtype=np.uint64), vecs1)
    cap1 = eng.capacity
    vecs2 = rng.standard_normal((2000, dim)).astype(np.float32)
    eng.ensure_capacity(2400)
    assert eng.capacity > cap1
    assert eng.capacity % 8 == 0
    eng.write(np.arange(400, 2400, dtype=np.uint64), vecs2)
    allv = np.concatenate([vecs1, vecs2])
    q = rng.standard_normal((2, dim)).astype(np.float32)
    vals, idx = eng.search(q, 10)
    oracle_idx, _ = numpy_topk_oracle(allv, np.arange(2400), q, 10, "cosine")
    for b in range(2):
        assert set(idx[b]) == set(oracle_idx[b])


def test_query_dim_mismatch(rng):
    eng = make_engine()
    with pytest.raises(ValueError):
        eng.search(rng.standard_normal((1, 7)).astype(np.float32), 5)


def test_verify_recall_harness(tmp_db, rng):
    from vrod_tpu_torch.utils.verify import verify_recall
    for metric in ("cosine", "l2", "dot"):
        col = tmp_db.create_collection(f"vr_{metric}", dim=24, metric=metric,
                                       segment_rows=64)
        vecs = rng.standard_normal((400, 24)).astype(np.float32)
        rids = col.bulk_insert(vecs)
        for r in rids[::5]:
            col.delete(int(r))
        q = rng.standard_normal((6, 24)).astype(np.float32)
        assert verify_recall(col, q, k=10) == 1.0


def test_device_query_and_device_results(rng):
    """Pre-staged device queries + as_numpy=False (the pipelined-bench path)."""
    eng = make_engine()
    vecs = fill(eng, rng, 300, 48)
    q_dev = torch.from_numpy(vecs[17:19]).to(eng.device)
    vals, idx = eng.search(q_dev, 5, as_numpy=False)
    assert isinstance(vals, torch.Tensor) and isinstance(idx, torch.Tensor)
    assert int(np.asarray(idx)[0, 0]) == 17
    # 1-D device query
    vals, idx = eng.search(q_dev[0], 1)
    assert idx[0, 0] == 17


def test_batch_bucketing():
    from vrod_tpu_torch.engine import _bucket, BATCH_BUCKETS
    assert _bucket(1, BATCH_BUCKETS) == 8
    assert _bucket(8, BATCH_BUCKETS) == 8
    assert _bucket(9, BATCH_BUCKETS) == 16
    assert _bucket(5000, BATCH_BUCKETS) == 8192


def test_verify_recall_quiesced_under_mutation(tmp_db, rng):
    """quiesce=True holds the write lock across capture + search, so a
    hammering concurrent mutator can never produce a spurious miss — the
    gate mode asserts exactly 1.0 (VERDICT r2 weak item 6)."""
    import threading
    from vrod_tpu_torch.utils.verify import verify_recall

    col = tmp_db.create_collection("vq", dim=16, segment_rows=64)
    vecs = rng.standard_normal((80, 16)).astype(np.float32)
    col.bulk_insert(vecs)
    stop = threading.Event()

    def mutate():
        i = 0
        while not stop.is_set():
            rid = col.insert(
                rng.standard_normal(16).astype(np.float32), f"m{i}")
            col.delete(rid)
            i += 1

    t = threading.Thread(target=mutate)
    t.start()
    try:
        for _ in range(10):
            q = rng.standard_normal((4, 16)).astype(np.float32)
            assert verify_recall(col, q, k=10, quiesce=True) == 1.0
    finally:
        stop.set()
        t.join()
