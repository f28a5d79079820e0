"""Database init/load/registry contracts (reference: src/database/).

``tests/test_database.py`` (14 cases) over ``vrod_tpu_torch``, the same
cases and oracles; the second process of the lock test imports only the
port.
"""

import numpy as np
import pytest

from vrod_tpu_torch.config import CONFIG_FILE, WAL_FILE
from vrod_tpu_torch.database import Database
from vrod_tpu_torch.errors import (

    CollectionExistsError, CollectionNotFoundError, DatabaseExistsError,
    DatabaseNotFoundError,
)


@pytest.fixture
def tmp_db(tmp_path):
    """The port's database (conftest's ``tmp_db`` is the JAX package's)."""
    from vrod_tpu_torch.database import Database
    db = Database.new(tmp_path, "testdb")
    yield db
    db.close()


def test_init_creates_layout(tmp_path):
    """Reference contract: db dir contains vr_config + vr_wal (setup.rs:17-23)."""
    db = Database.new(tmp_path, "mydb")
    root = tmp_path / "mydb"
    assert (root / CONFIG_FILE).exists()
    assert (root / WAL_FILE).exists()
    db.close()


def test_init_refuses_existing(tmp_path):
    """Reference contract: AlreadyExists error (setup.rs:6-15)."""
    Database.new(tmp_path, "dup").close()
    with pytest.raises(DatabaseExistsError):
        Database.new(tmp_path, "dup")


def test_load_missing(tmp_path):
    with pytest.raises(DatabaseNotFoundError):
        Database.load(tmp_path / "nope")


def test_load_empty_config_file(tmp_path):
    """The reference's on-disk format has an *empty* vr_config; load must
    accept it (setup.rs:19-20)."""
    root = tmp_path / "legacy"
    root.mkdir()
    (root / CONFIG_FILE).touch()
    (root / WAL_FILE).touch()
    db = Database.load(root)
    assert db.list_collections() == []
    db.close()


def test_create_drop_list(tmp_db):
    tmp_db.create_collection("a", dim=8, segment_rows=64)
    tmp_db.create_collection("b", dim=8, metric="l2", segment_rows=64)
    assert tmp_db.list_collections() == ["a", "b"]
    with pytest.raises(CollectionExistsError):
        tmp_db.create_collection("a", dim=8)
    tmp_db.drop_collection("a")
    assert tmp_db.list_collections() == ["b"]
    with pytest.raises(CollectionNotFoundError):
        tmp_db.drop_collection("a")
    with pytest.raises(CollectionNotFoundError):
        tmp_db.collection("zzz")


def test_reload_database(tmp_path, rng):
    db = Database.new(tmp_path, "db1")
    col = db.create_collection("words", dim=8, segment_rows=64)
    vecs = rng.standard_normal((20, 8)).astype(np.float32)
    rids = col.bulk_insert(vecs)
    db.close()

    db2 = Database.load(tmp_path / "db1")
    assert db2.list_collections() == ["words"]
    col2 = db2.collection("words")
    assert col2.count == 20
    hits = col2.search_similar(vecs[3], k=1)
    assert hits[0].record_id == rids[3]
    db2.close()


def test_db_wal_recovery_of_create(tmp_path):
    """Crash between DB-WAL append and config write: load reconciles."""
    import json
    from vrod_tpu_torch.wal import Wal, ops as wops
    db = Database.new(tmp_path, "db2")
    root = db.path
    db.close()
    # Simulate: the CREATE got WAL-logged but neither the dir nor the config
    # update happened.
    w = Wal(root / WAL_FILE)
    cfg = {"name": "ghost", "dim": 8, "metric": "cosine", "dtype": "float32",
           "segment_rows": 64, "shards": 1, "rescore_margin": 64}
    w.append(wops.encode(wops.CreateCollectionOp(cfg)), sync=True)
    w.close()
    db2 = Database.load(root)
    assert "ghost" in db2.list_collections()
    assert db2.collection("ghost").config.dim == 8
    # registry config was rewritten; WAL drained
    assert db2.wal.frame_count == 0
    raw = json.loads((root / CONFIG_FILE).read_text())
    assert "ghost" in raw["collections"]
    db2.close()


def test_truncate_wal_targets(tmp_db):
    col = tmp_db.create_collection("t", dim=8, segment_rows=64)
    col.insert(np.ones(8, dtype=np.float32))
    assert col.wal.frame_count == 1
    tmp_db.truncate_wal("t")          # collection-level
    assert col.wal.frame_count == 0
    tmp_db.truncate_wal(None)         # database-level (builder.rs:41 default)
    assert tmp_db.wal.frame_count == 0


def test_collection_stats_lazy(tmp_path, rng):
    """Listing must not device-restore cold collections."""
    db = Database.new(tmp_path, "lazy")
    col = db.create_collection("a", dim=8, segment_rows=64)
    col.bulk_insert(rng.standard_normal((30, 8)).astype(np.float32))
    col.snapshot()
    db.close()

    db2 = Database.load(tmp_path / "lazy")
    st = db2.collection_stats("a")
    assert st["count"] == 30           # from snapshot meta, no restore
    assert st["loaded"] is False
    assert "a" not in db2._collections  # still cold
    # un-replayed WAL frames make the cold count unknown
    col = db2.collection("a")
    col.insert(np.ones(8, dtype=np.float32))
    db2.close()
    db3 = Database.load(tmp_path / "lazy")
    st = db3.collection_stats("a")
    # un-replayed WAL frames are counted host-only (no device restore)
    assert st["count"] == 31 and st["wal_frames"] == 1
    assert "a" not in db3._collections  # still cold
    assert db3.collection("a").count == 31
    db3.close()


def test_database_lock_excludes_second_process(tmp_path):
    """A second opener must fail fast instead of corrupting the WAL."""
    import subprocess, sys, os, textwrap
    from vrod_tpu_torch.errors import DatabaseLockedError
    db = Database.new(tmp_path, "locked")
    # same-process second open also fails (fresh fd, same inode lock held)
    child = textwrap.dedent(f"""
        import os, sys
        os.environ["VROD_PLATFORM"] = "cpu"
        from vrod_tpu_torch.database import Database
        from vrod_tpu_torch.errors import DatabaseLockedError
        try:
            Database.load({str(tmp_path / 'locked')!r})
            print("ACQUIRED")
        except DatabaseLockedError:
            print("LOCKED")
    """)
    env = dict(os.environ)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", child], env=env,
                         capture_output=True, text=True, timeout=120)
    assert "LOCKED" in out.stdout, out.stdout + out.stderr
    db.close()
    # after close, a new open succeeds
    db2 = Database.load(tmp_path / "locked")
    db2.close()


def test_multi_collection_database(tmp_path, rng):
    """Several collections with different schemas coexist in one DB."""
    db = Database.new(tmp_path, "multi")
    specs = [("cos32", "cosine", "float32", 16),
             ("l2bf", "l2", "bfloat16", 24),
             ("dot32", "dot", "float32", 8)]
    data = {}
    for name, metric, dtype, dim in specs:
        col = db.create_collection(name, dim=dim, metric=metric,
                                   dtype=dtype, segment_rows=64)
        vecs = rng.standard_normal((60, dim)).astype(np.float32)
        rids = col.bulk_insert(vecs, [f"{name}-{i}" for i in range(60)])
        data[name] = (vecs, rids, dim)
    assert db.list_collections() == sorted(n for n, *_ in specs)
    for name, metric, dtype, dim in specs:
        vecs, rids, _ = data[name]
        hits = db.collection(name).search_similar(vecs[7], k=1)
        assert hits[0].record_id == rids[7]
        assert hits[0].payload == f"{name}-7"
    db.close()

    db2 = Database.load(tmp_path / "multi")
    for name, metric, dtype, dim in specs:
        vecs, rids, _ = data[name]
        col = db2.collection(name)
        assert col.config.metric == metric and col.config.dtype == dtype
        hits = col.search_similar(vecs[7], k=1)
        assert hits[0].record_id == rids[7]
    db2.close()


def test_collection_truncate_wal_preserves_acked_records(tmp_path, rng):
    """TRUNCATEWAL must not destroy acknowledged, un-snapshotted records:
    it snapshots first, so a restart still sees everything."""
    from vrod_tpu_torch.database import Database
    db = Database.new(tmp_path, "twdb")
    col = db.create_collection("t", dim=8, segment_rows=64)
    rids = col.bulk_insert(rng.standard_normal((20, 8)).astype(np.float32),
                           payloads=[f"p{i}" for i in range(20)])
    db.truncate_wal("t")
    assert col.wal.frame_count == 0 or col.wal.valid_size < 1024
    db.close()
    db2 = Database.load(tmp_path / "twdb")
    col2 = db2.collection("t")
    assert col2.count == 20
    assert col2.get(int(rids[7])).payload == "p7"
    db2.close()


def test_cold_count_beyond_2m_ids(tmp_path):
    """LISTCOLLECTIONS exact cold counts must cover 10M-scale collections:
    the old 2M id cap printed '?' for collections the engine itself
    supports (VERDICT r2 weak item 5)."""
    import json
    from vrod_tpu_torch.database import Database

    db = Database.new(tmp_path, "big")
    col = db.create_collection("c", dim=8, segment_rows=64)
    col.insert(np.ones(8, dtype=np.float32), "x")  # one WAL frame
    db.close()

    # Fabricate a snapshot id set past the old cap (host-only counting
    # only reads ids.npy + meta; vectors are never touched).
    snap = tmp_path / "big" / "collections" / "c" / "snapshot"
    snap.mkdir(exist_ok=True)
    ids = np.arange(10, 2_500_010, dtype=np.uint64)
    np.save(snap / "ids.npy", ids)
    (snap / "meta.json").write_text(json.dumps(
        {"count": int(ids.size), "next_id": 2_500_010, "last_lsn": 0}))

    db2 = Database.load(tmp_path / "big")
    st = db2.collection_stats("c")
    # snapshot ids + the WAL-replayed insert (id 1): exact, not None.
    assert st["count"] == ids.size + 1
    db2.close()


def test_cold_count_reinsert_after_delete(tmp_path):
    """Host-only counting is order-sensitive: insert -> delete -> reinsert
    of the same id must count once (the numpy last-event-wins path)."""
    from vrod_tpu_torch.database import Database

    db = Database.new(tmp_path, "rr")
    col = db.create_collection("c", dim=4, segment_rows=64)
    v = np.ones(4, dtype=np.float32)
    rid = col.insert(v, "a")
    col.delete(rid)
    col.insert(v, "b")      # new id
    col.delete_many([2])    # delete it again
    col.insert(v, "c")
    db.close()

    db2 = Database.load(tmp_path / "rr")
    assert db2.collection_stats("c")["count"] == 1
    assert db2.collection("c").count == 1
    db2.close()
