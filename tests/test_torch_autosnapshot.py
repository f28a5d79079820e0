"""Auto-snapshot policy: WAL growth past the configured budget triggers a
background non-blocking snapshot that truncates the covered prefix —
bounding restart-replay time with no operator action (the reference's
TruncateWal/checkpoint intent, types.rs:44-54, made automatic).

``tests/test_autosnapshot.py`` (10 cases) over ``vrod_tpu_torch``, the
same cases and oracles, unchanged but for the package they import.
"""

import time

import numpy as np
import pytest

from vrod_tpu_torch.config import SNAPSHOT_DIR, WAL_FILE


@pytest.fixture
def tmp_db(tmp_path):
    """The port's database (conftest's ``tmp_db`` is the JAX package's)."""
    from vrod_tpu_torch.database import Database
    db = Database.new(tmp_path, "testdb")
    yield db
    db.close()


def _wait_for(pred, timeout=90.0):  # generous: CI boxes under load flake at 30
    t0 = time.time()
    while time.time() - t0 < timeout:
        if pred():
            return True
        time.sleep(0.05)
    return pred()


def test_auto_snapshot_triggers_and_truncates(tmp_db, rng):
    col = tmp_db.create_collection(
        "a", dim=32, segment_rows=64, auto_snapshot_wal_bytes=16 * 1024)
    vecs = rng.standard_normal((64, 32)).astype(np.float32)
    for i in range(8):  # ~8 x 64 x 32 x 4B = 64 KB of WAL frames
        col.bulk_insert(vecs)
    snap = col.path / SNAPSHOT_DIR
    assert _wait_for(lambda: snap.exists()), "auto snapshot never ran"
    assert _wait_for(lambda: col.wal.valid_size < 16 * 1024), \
        "WAL not truncated below budget"
    assert col.count == 8 * 64


def test_auto_snapshot_trigger_during_running_snapshot_not_lost(tmp_db, rng):
    """A budget crossing that lands while a maintenance worker is alive
    must not be dropped: the worker re-checks before exiting (regression —
    the WAL used to sit above budget until the NEXT mutation)."""
    col = tmp_db.create_collection(
        "slow", dim=32, segment_rows=64, auto_snapshot_wal_bytes=8 * 1024)
    real = col._snapshot_impl

    def slow_snapshot():
        real()
        time.sleep(0.8)  # stay alive after the work: the drop window

    col._snapshot_impl = slow_snapshot
    vecs = rng.standard_normal((64, 32)).astype(np.float32)
    col.bulk_insert(vecs)  # crosses budget -> spawns slow worker
    time.sleep(0.3)  # let the first snapshot finish; worker still alive
    t = col._autosnap_thread
    assert t is not None and t.is_alive()
    col.bulk_insert(vecs)  # crosses again AFTER the snapshot's cut
    # No further mutations: the worker's exit re-check must cover it.
    assert _wait_for(lambda: col.wal.valid_size < 8 * 1024), \
        f"trigger dropped: WAL stuck at {col.wal.valid_size}"
    assert col.count == 128


def test_auto_snapshot_restore_consistent(tmp_path, rng):
    from vrod_tpu_torch.database import Database
    db = Database.new(tmp_path, "adb")
    col = db.create_collection(
        "a", dim=16, segment_rows=64, auto_snapshot_wal_bytes=8 * 1024)
    vecs = rng.standard_normal((200, 16)).astype(np.float32)
    rids = col.bulk_insert(vecs, payloads=[f"p{i}" for i in range(200)])
    col.delete(int(rids[5]))
    # Wait until any in-flight auto snapshot settles, then reload.
    t = col._autosnap_thread
    if t is not None:
        t.join(timeout=30)
    db.close()
    db2 = Database.load(tmp_path / "adb")
    col2 = db2.collection("a")
    assert col2.count == 199
    hits = col2.search_similar(vecs[7], k=1)
    assert hits[0].record_id == int(rids[7])
    assert hits[0].payload == "p7"
    db2.close()


def test_auto_snapshot_disabled_by_default(tmp_db, rng):
    col = tmp_db.create_collection("b", dim=16, segment_rows=64)
    col.bulk_insert(rng.standard_normal((300, 16)).astype(np.float32))
    time.sleep(0.2)
    assert not (col.path / SNAPSHOT_DIR).exists()
    assert col.config.auto_snapshot_wal_bytes == 0


def test_auto_snapshot_config_roundtrip(tmp_path):
    from vrod_tpu_torch.database import Database
    db = Database.new(tmp_path, "cdb")
    db.create_collection("c", dim=8, segment_rows=64,
                         auto_snapshot_wal_bytes=12345)
    db.close()
    db2 = Database.load(tmp_path / "cdb")
    assert db2.collection("c").config.auto_snapshot_wal_bytes == 12345
    db2.close()


def test_auto_snapshot_under_concurrent_mutations_and_searches(tmp_path, rng):
    """Stress: writers + searchers while budget-triggered snapshots fire
    repeatedly; the final reload must match the surviving live set."""
    import threading
    from vrod_tpu_torch.database import Database

    db = Database.new(tmp_path, "sdb", wal_sync=False)
    col = db.create_collection(
        "s", dim=16, segment_rows=64, auto_snapshot_wal_bytes=4 * 1024)
    base = rng.standard_normal((64, 16)).astype(np.float32)
    live = set(col.bulk_insert(base).tolist())
    lock = threading.Lock()
    stop = threading.Event()
    errors = []

    def writer(seed):
        r = np.random.default_rng(seed)
        try:
            while not stop.is_set():
                vecs = r.standard_normal((16, 16)).astype(np.float32)
                ids = col.bulk_insert(vecs)
                with lock:
                    live.update(ids.tolist())
                    victims = [i for i in list(live)[:4]]
                    for v in victims:
                        live.discard(v)
                col.delete_many(np.array(victims, dtype=np.uint64))
        except Exception as e:  # pragma: no cover
            errors.append(e)

    def searcher():
        r = np.random.default_rng(99)
        try:
            while not stop.is_set():
                col.search_similar(
                    r.standard_normal(16).astype(np.float32), k=5)
        except Exception as e:  # pragma: no cover
            errors.append(e)

    threads = [threading.Thread(target=writer, args=(s,)) for s in (1, 2)]
    threads.append(threading.Thread(target=searcher))
    for t in threads:
        t.start()
    time.sleep(3.0)
    stop.set()
    for t in threads:
        t.join(timeout=30)
    assert not errors, errors
    t = col._autosnap_thread
    if t is not None:
        t.join(timeout=30)
    expected = set(live)
    db.close()

    db2 = Database.load(tmp_path / "sdb", wal_sync=False)
    col2 = db2.collection("s")
    assert col2.count == len(expected)
    got = set(int(i) for i in col2.alloc.ids_of(
        col2.alloc.live_slots()).tolist())
    assert got == expected
    db2.close()


def test_auto_compact_reclaims_capacity(tmp_db, rng):
    """auto_compact_fraction triggers a background REINDEX after mass
    deletions; capacity shrinks to the live set's segments."""
    col = tmp_db.create_collection(
        "ac", dim=16, segment_rows=64, auto_compact_fraction=0.25)
    vecs = rng.standard_normal((512, 16)).astype(np.float32)
    rids = col.bulk_insert(vecs)
    cap = col.engine.capacity
    assert cap >= 512
    col.delete_many(rids[30:])  # 30 live of 512+ capacity -> < 25%
    assert _wait_for(lambda: col.engine.capacity == 64), \
        f"capacity stayed {col.engine.capacity}"
    assert col.count == 30
    hits = col.search_similar(vecs[3], k=1)
    assert hits[0].record_id == int(rids[3])


def test_manual_snapshot_reevaluates_budgets_after_release(tmp_db, rng):
    """A compaction budget crossed while a manual op held the maintenance
    lock used to be dropped (the trigger saw the lock and returned, and a
    snapshot does NOT compact): manual ops re-evaluate after release."""
    col = tmp_db.create_collection(
        "mre", dim=16, segment_rows=64, auto_compact_fraction=0.25)
    rids = col.bulk_insert(rng.standard_normal((512, 16)).astype(np.float32))
    # Suppress the delete path's own trigger to isolate the manual-op one.
    col._closing = True
    col.delete_many(rids[30:])
    time.sleep(0.2)
    assert col.engine.capacity > 64  # nothing fired while suppressed
    col._closing = False
    col.snapshot()  # trailing re-check must fire the compaction
    assert _wait_for(lambda: col.engine.capacity == 64), \
        f"capacity stayed {col.engine.capacity}"
    assert col.count == 30


def test_auto_compact_disabled_by_default(tmp_db, rng):
    col = tmp_db.create_collection("nc", dim=16, segment_rows=64)
    rids = col.bulk_insert(rng.standard_normal((512, 16)).astype(np.float32))
    cap = col.engine.capacity
    col.delete_many(rids[5:])
    time.sleep(0.3)
    assert col.engine.capacity == cap  # only manual reindex shrinks


def test_auto_compact_no_trigger_when_shrink_impossible(tmp_db, rng):
    """live just over one segment with a high fraction must NOT loop
    maintenance forever: the trigger requires that shrinking would
    actually reclaim a segment."""
    from vrod_tpu_torch import metrics
    col = tmp_db.create_collection(
        "nt", dim=16, segment_rows=64, auto_compact_fraction=0.75)
    rids = col.bulk_insert(rng.standard_normal((70, 16)).astype(np.float32))
    assert col.engine.capacity == 128
    before = metrics.counters.get("collection.auto_compactions")
    for _ in range(5):
        col.insert(rng.standard_normal(16).astype(np.float32))
    t = col._autosnap_thread
    if t is not None:
        t.join(timeout=30)
    assert metrics.counters.get("collection.auto_compactions") == before
    assert col.engine.capacity == 128
