"""Partial-apply rollback + recovery-completion invariants.

A mutation whose device apply fails must leave the LIVE view exactly at
the durable (post-WAL-rewind) state: failed inserts release their id
binding (retries must not wedge), failed updates restore the old record,
and DB-WAL recovery completes half-created collection directories.

``tests/test_rollback.py`` (10 cases) over ``vrod_tpu_torch``, the same
cases and oracles, unchanged but for the package they import.
"""

import numpy as np
import pytest


@pytest.fixture
def tmp_db(tmp_path):
    """The port's database (conftest's ``tmp_db`` is the JAX package's)."""
    from vrod_tpu_torch.database import Database
    db = Database.new(tmp_path, "testdb")
    yield db
    db.close()


def _fail_once(obj, attr):
    """Monkeypatch obj.attr to raise on the first call only."""
    orig = getattr(obj, attr)
    state = {"armed": True}

    def wrapper(*a, **kw):
        if state["armed"]:
            state["armed"] = False
            raise RuntimeError("injected device failure")
        return orig(*a, **kw)

    setattr(obj, attr, wrapper)
    return state


def test_failed_insert_releases_binding_and_retries(tmp_db, rng):
    col = tmp_db.create_collection("r", dim=8, segment_rows=64)
    v = rng.standard_normal(8).astype(np.float32)
    rid0 = col.insert(v, "ok")
    _fail_once(col.engine, "write")
    with pytest.raises(RuntimeError, match="injected"):
        col.insert(v, "boom")
    # The failed op is not durable, its binding is gone, and inserts work.
    rid2 = col.insert(v, "after")
    assert rid2 > rid0
    assert col.count == 2
    assert col.get(rid2).payload == "after"
    # WAL was rewound: a reload replays only the two acked inserts.
    import vrod_tpu_torch.collection as C
    col2 = C.Collection.load(col.path)
    assert col2.count == 2
    col2.close()


def test_failed_update_restores_old_record(tmp_db, rng):
    col = tmp_db.create_collection("u", dim=8, segment_rows=64)
    v_old = rng.standard_normal(8).astype(np.float32)
    rid = col.insert(v_old, "original")
    _fail_once(col.engine, "write")
    v_new = rng.standard_normal(8).astype(np.float32)
    with pytest.raises(RuntimeError, match="injected"):
        col.update(rid, v_new, "edited")
    # Live view must match durable state: the record still exists with its
    # old vector and payload.
    rec = col.get(rid)
    assert rec.payload == "original"
    np.testing.assert_allclose(rec.vector, v_old, rtol=1e-6)
    hits = col.search_similar(v_old, k=1)
    assert hits[0].record_id == rid


def test_bulk_insert_invalidates_filter_masks(tmp_db, rng):
    """bulk_insert must bump the mutation generation: a cached mask from
    before a capacity-growing bulk insert has the old capacity's shape."""
    col = tmp_db.create_collection("g", dim=8, segment_rows=64)
    rids = col.bulk_insert(rng.standard_normal((60, 8)).astype(np.float32))
    q = rng.standard_normal(8).astype(np.float32)
    col.search_similar(q, k=3, within_ids=rids[:10])  # cache a (64,) mask
    # Grow capacity 64 -> 128 via bulk insert.
    col.bulk_insert(rng.standard_normal((60, 8)).astype(np.float32))
    assert col.engine.capacity > 64
    hits = col.search_similar(q, k=3, within_ids=rids[:10])  # must rebuild
    assert {h.record_id for h in hits} <= set(rids[:10].tolist())


def test_recovery_completes_half_created_collection(tmp_path):
    """Crash between mkdir and the vr_config write: the DB WAL op carries
    the config, so recovery must finish the directory, not adopt it."""
    from vrod_tpu_torch.database import Database
    from vrod_tpu_torch.config import CollectionConfig
    from vrod_tpu_torch.wal import ops

    db = Database.new(tmp_path, "hcdb")
    cfg = CollectionConfig(name="half", dim=8, segment_rows=64)
    db.wal.append(ops.encode(ops.CreateCollectionOp(cfg.to_json())))
    (db.path / "collections" / "half").mkdir(parents=True)  # crash here
    db.close()

    db2 = Database.load(tmp_path / "hcdb")
    assert "half" in db2.list_collections()
    col = db2.collection("half")  # must load: vr_config was completed
    assert col.config.dim == 8
    col.bulk_insert(np.ones((3, 8), dtype=np.float32))
    assert col.count == 3
    db2.close()


def test_replay_update_of_missing_record(tmp_path, rng):
    """Crash-replay pattern that used to wedge the DB: record updated then
    deleted, snapshot commits (record absent), crash before the WAL prefix
    is truncated. Replaying the UpdateOp must not crash on the NO_ID slot;
    the later DeleteOp converges the state."""
    from vrod_tpu_torch.collection import Collection
    from vrod_tpu_torch.config import CollectionConfig
    from vrod_tpu_torch.wal import ops

    cfg = CollectionConfig(name="m", dim=8, segment_rows=64)
    col = Collection.create(tmp_path / "m", cfg)
    v = rng.standard_normal(8).astype(np.float32)
    rid = col.insert(v, "orig")
    col.update(rid, v * 2, "edited")
    col.delete(rid)
    keep = col.insert(rng.standard_normal(8).astype(np.float32), "keep")
    col.snapshot()
    # Simulate the crash: re-append the pre-snapshot frames (as if
    # truncate_until never happened) — replay must stay idempotent.
    col.wal.append(ops.encode(ops.UpdateOp(rid, v * 2, "edited")))
    col.wal.append(ops.encode(ops.DeleteOp(rid)))
    col.close()

    col2 = Collection.load(tmp_path / "m")
    assert col2.count == 1
    assert col2.get(keep).payload == "keep"
    import pytest
    from vrod_tpu_torch.errors import RecordNotFoundError
    with pytest.raises(RecordNotFoundError):
        col2.get(rid)
    col2.close()


def test_failed_payload_set_rolls_back_insert(tmp_db, rng):
    """Insert whose payload-store write fails must roll back the binding
    and device row (a bound row without its payload serves wrong data)."""
    col = tmp_db.create_collection("pp", dim=8, segment_rows=64)
    v = rng.standard_normal(8).astype(np.float32)
    col.insert(v, "ok")
    _fail_once(col.payloads, "set_many")
    with pytest.raises(RuntimeError, match="injected"):
        col.insert(v, "boom")
    rid = col.insert(v, "after")  # binding released: retry works
    assert col.count == 2
    assert col.get(rid).payload == "after"


def test_failed_create_is_retryable(tmp_path, rng, monkeypatch):
    """A create that fails mid-engine-init must not poison the name (the
    durable create op is compensated with a drop)."""
    from vrod_tpu_torch.database import Database
    import vrod_tpu_torch.database as dbmod
    db = Database.new(tmp_path, "crdb")
    orig = dbmod.Collection.create
    calls = {"n": 0}

    def flaky(path, config, **kw):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("injected engine OOM")
        return orig(path, config, **kw)

    monkeypatch.setattr(dbmod.Collection, "create", staticmethod(flaky))
    with pytest.raises(RuntimeError, match="injected"):
        db.create_collection("c", dim=8, segment_rows=64)
    assert "c" not in db.list_collections()
    col = db.create_collection("c", dim=8, segment_rows=64)  # retry works
    col.bulk_insert(rng.standard_normal((3, 8)).astype(np.float32))
    db.close()
    # restart: the compensated create must NOT resurrect a phantom from
    # the first (failed) attempt; the second create's records survive.
    db2 = Database.load(tmp_path / "crdb")
    assert db2.collection("c").count == 3
    db2.close()


def test_failed_delete_erase_keeps_binding(tmp_db, rng):
    """Delete whose device erase fails must leave the binding intact: the
    WAL is rewound (the record durably exists), so the live view must
    still serve it — and a retry must work."""
    col = tmp_db.create_collection("dd", dim=8, segment_rows=64)
    v = rng.standard_normal(8).astype(np.float32)
    rid = col.insert(v, "keep")
    _fail_once(col.engine, "erase")
    with pytest.raises(RuntimeError, match="injected"):
        col.delete(rid)
    assert col.count == 1
    assert col.get(rid).payload == "keep"
    assert col.search_similar(v, k=1)[0].record_id == rid
    col.delete(rid)  # retry succeeds
    assert col.count == 0


def test_failed_bulk_delete_erase_keeps_bindings(tmp_db, rng):
    col = tmp_db.create_collection("bd", dim=8, segment_rows=64)
    rids = col.bulk_insert(rng.standard_normal((5, 8)).astype(np.float32),
                           [f"p{i}" for i in range(5)])
    _fail_once(col.engine, "erase")
    with pytest.raises(RuntimeError, match="injected"):
        col.delete_many(rids[:3])
    assert col.count == 5
    for r in rids.tolist():
        col.get(r)  # every binding still resolves
    assert col.delete_many(rids[:3]) == 3  # retry succeeds
    assert col.count == 2


def test_create_race_preserves_foreign_dir(tmp_path, monkeypatch):
    """TOCTOU guard: if the collection dir appears between the registry
    check and mkdir (an external actor), create must not delete it and
    must not leave create/drop ops in the DB WAL."""
    from vrod_tpu_torch.database import Database
    import vrod_tpu_torch.database as dbmod
    from vrod_tpu_torch.errors import CollectionExistsError

    db = Database.new(tmp_path, "race")
    cdir = db.path / "collections" / "c"

    def foreign_then_fail(path, config, **kw):
        cdir.mkdir(parents=True)  # external actor wins the race
        (cdir / "sentinel").write_text("foreign data")
        raise FileExistsError(str(cdir))

    monkeypatch.setattr(dbmod.Collection, "create",
                        staticmethod(foreign_then_fail))
    with pytest.raises(CollectionExistsError):
        db.create_collection("c", dim=8, segment_rows=64)
    assert (cdir / "sentinel").read_text() == "foreign data"
    assert db.wal.frame_count == 0  # create op rewound; no drop logged
    db.close()
