"""Filtered search: id allowlist/denylist masks ANDed into the validity
bitmap (exact top-k of the filtered subset, oracle-verified).

The reference has no filtering (search is a stub, types.rs:121-132); this
is a vrod-tpu extension realized TPU-natively: the filter is data (a bool
mask), not program, so every already-compiled search program is reused.

``tests/test_filter.py`` (10 cases) over ``vrod_tpu_torch``, the same cases
and oracles; its engines come from ``test_torch_search.make_engine``, where
8 shards are ``devices=[cpu] * 8``.
"""

import numpy as np
import pytest

from conftest import numpy_topk_oracle
from test_torch_search import fill, make_engine


@pytest.fixture
def tmp_db(tmp_path):
    """The port's database (conftest's ``tmp_db`` is the JAX package's)."""
    from vrod_tpu_torch.database import Database
    db = Database.new(tmp_path, "testdb")
    yield db
    db.close()


@pytest.mark.parametrize("shards", [1, 8])
def test_engine_within_filter_matches_oracle(shards, rng):
    eng = make_engine(shards=shards)
    n, dim, k = 1200, 48, 10
    vecs = fill(eng, rng, n, dim)
    allow = rng.choice(n, size=120, replace=False)
    mask = eng.filter_mask_from_slots(allow, mode="within")
    q = rng.standard_normal((3, dim)).astype(np.float32)
    vals, idx = eng.search(q, k, filter_mask=mask)
    oracle_idx, _ = numpy_topk_oracle(vecs, np.sort(allow), q, k, "cosine")
    for b in range(3):
        assert set(idx[b]) == set(oracle_idx[b])
        assert set(idx[b]) <= set(allow.tolist())


def test_engine_exclude_filter_matches_oracle(rng):
    eng = make_engine()
    n, dim, k = 900, 48, 15
    vecs = fill(eng, rng, n, dim)
    deny = rng.choice(n, size=200, replace=False)
    mask = eng.filter_mask_from_slots(deny, mode="exclude")
    q = rng.standard_normal((2, dim)).astype(np.float32)
    vals, idx = eng.search(q, k, filter_mask=mask)
    keep = np.setdiff1d(np.arange(n), deny)
    oracle_idx, _ = numpy_topk_oracle(vecs, keep, q, k, "cosine")
    for b in range(2):
        assert set(idx[b]) == set(oracle_idx[b])
        assert not set(idx[b]) & set(deny.tolist())


def test_filter_composes_with_deletes(rng):
    """A deleted row stays masked even when the allowlist names it."""
    eng = make_engine()
    n, dim = 500, 48
    vecs = fill(eng, rng, n, dim)
    eng.erase(np.arange(0, n, 2))
    allow = np.arange(0, 100)  # half of these are deleted
    mask = eng.filter_mask_from_slots(allow, mode="within")
    q = rng.standard_normal((2, dim)).astype(np.float32)
    vals, idx = eng.search(q, 60, filter_mask=mask)
    live_allowed = np.arange(1, 100, 2)
    for b in range(2):
        got = set(idx[b][idx[b] >= 0].tolist())
        assert got == set(live_allowed.tolist())


def test_filter_all_excluded_returns_empty(rng):
    eng = make_engine()
    fill(eng, rng, 200, 48)
    mask = eng.filter_mask_from_slots(np.array([], dtype=np.int64),
                                      mode="within")
    q = rng.standard_normal((1, 48)).astype(np.float32)
    vals, idx = eng.search(q, 5, filter_mask=mask)
    assert (idx == -1).all()


def test_filter_mode_validation(rng):
    eng = make_engine()
    with pytest.raises(ValueError, match="filter mode"):
        eng.filter_mask_from_slots(np.array([0]), mode="nope")


def test_collection_within_and_exclude(tmp_db, rng):
    col = tmp_db.create_collection("f", dim=24, segment_rows=64)
    vecs = rng.standard_normal((300, 24)).astype(np.float32)
    rids = col.bulk_insert(vecs, payloads=[f"p{i}" for i in range(300)])
    q = vecs[7]

    allow = rids[:50]
    hits = col.search_similar(q, k=5, within_ids=allow)
    assert {h.record_id for h in hits} <= set(allow.tolist())
    assert hits[0].record_id == int(rids[7])  # query == stored vector 7
    assert hits[0].payload == "p7"

    hits_ex = col.search_similar(q, k=5, exclude_ids=[int(rids[7])])
    assert int(rids[7]) not in {h.record_id for h in hits_ex}

    # unknown ids are ignored; deleted ids can't resurface via within
    col.delete(int(rids[3]))
    hits2 = col.search_similar(q, k=50,
                               within_ids=list(rids[:50]) + [999999])
    got = {h.record_id for h in hits2}
    assert int(rids[3]) not in got
    assert got == set(int(r) for r in rids[:50]) - {int(rids[3])}

    with pytest.raises(ValueError, match="not both"):
        col.search_similar(q, k=5, within_ids=[1], exclude_ids=[2])


def test_cli_searchsimilar_filter(tmp_db, rng):
    """The SEARCHSIMILAR verb accepts ;within= / ;exclude= options."""
    from vrod_tpu_torch.commands.builder import CommandBuilder
    col = tmp_db.create_collection("g", dim=4, segment_rows=64)
    rids = col.bulk_insert(np.eye(4, dtype=np.float32),
                           payloads=["a", "b", "c", "d"])
    cb = CommandBuilder(tmp_db)
    arg = "1,0,0,0;k=2;exclude=%d" % int(rids[0])
    out = cb.build("g", "SEARCHSIMILAR", arg).execute()
    assert str(int(rids[0])) not in out.split()
    arg = "1,0,0,0;k=2;within=%d,%d" % (int(rids[2]), int(rids[3]))
    out = cb.build("g", "SEARCHSIMILAR", arg).execute()
    first_ids = [line.split("\t")[0] for line in out.splitlines()]
    assert set(first_ids) <= {str(int(rids[2])), str(int(rids[3]))}


def test_filter_mask_cached_until_mutation(tmp_db, rng):
    """Repeated same-filter searches reuse the device mask; any mutation
    (new generation) rebuilds it (slot bindings may have changed)."""
    col = tmp_db.create_collection("fc", dim=8, segment_rows=64)
    rids = col.bulk_insert(rng.standard_normal((50, 8)).astype(np.float32))
    calls = {"n": 0}
    orig = col.engine.filter_mask_from_slots

    def counting(*a, **kw):
        calls["n"] += 1
        return orig(*a, **kw)

    col.engine.filter_mask_from_slots = counting
    q = rng.standard_normal(8).astype(np.float32)
    col.search_similar(q, k=3, within_ids=rids[:10])
    col.search_similar(q, k=3, within_ids=rids[:10])
    assert calls["n"] == 1  # cache hit on the second call
    col.delete(int(rids[20]))  # bump generation
    col.search_similar(q, k=3, within_ids=rids[:10])
    assert calls["n"] == 2  # rebuilt after mutation


def test_k_near_capacity_small_collection(rng):
    """Bucketed k_out must clamp to capacity (k=70 on a 72-slot collection
    used to crash rescore's top_k with k_out=96 > 72)."""
    eng = make_engine(segment_rows=72)
    vecs = fill(eng, rng, 72, 48)
    q = rng.standard_normal((2, 48)).astype(np.float32)
    vals, idx = eng.search(q, 70)
    assert idx.shape == (2, 70)
    for b in range(2):
        got = set(idx[b][idx[b] >= 0].tolist())
        assert len(got) == 70


def test_filter_mask_survives_capacity_shrink(tmp_db, rng):
    """Reindex that only SHRINKS (no row moves) must still invalidate
    cached filter masks — the old mask has the old capacity's shape."""
    col = tmp_db.create_collection("fs", dim=8, segment_rows=64)
    rids = col.bulk_insert(rng.standard_normal((128, 8)).astype(np.float32))
    q = rng.standard_normal(8).astype(np.float32)
    col.search_similar(q, k=3, within_ids=rids[:10])  # cache (128,) mask
    col.delete_many(rids[64:])  # tail segment dies; live already packed
    col.reindex()
    assert col.engine.capacity == 64
    hits = col.search_similar(q, k=3, within_ids=rids[:10])  # must rebuild
    assert {h.record_id for h in hits} <= set(rids[:10].tolist())
