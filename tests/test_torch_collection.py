"""Collection lifecycle: mutations, durability, crash recovery, compaction.

``tests/test_collection.py`` (20 cases) over ``vrod_tpu_torch``, the same
cases and oracles. Two are rewritten to the port's device API, since torch
has one CPU device and no forced host device count: an 8-shard collection
is asked for on ``[cpu] * 8`` (``test_sharded_collection``, its reload
included), and the restore on a smaller topology loads on ``[cpu] * 2``
where JAX passed ``jax.devices("cpu")[:2]``.
"""

import numpy as np
import pytest
import torch

from vrod_tpu_torch.collection import Collection
from vrod_tpu_torch.config import CollectionConfig
from vrod_tpu_torch.errors import DimensionMismatchError, RecordNotFoundError


@pytest.fixture
def tmp_db(tmp_path):
    """The port's database (conftest's ``tmp_db`` is the JAX package's)."""
    from vrod_tpu_torch.database import Database
    db = Database.new(tmp_path, "testdb")
    yield db
    db.close()


CPU = torch.device("cpu")


def new_col(tmp_path, name="c", **kw):
    kw.setdefault("dim", 16)
    kw.setdefault("segment_rows", 64)
    cfg = CollectionConfig(name=name, **kw)
    return Collection.create(tmp_path / name, cfg,
                             devices=[CPU] * cfg.shards)


def test_insert_get_delete(tmp_path, rng):
    col = new_col(tmp_path)
    v = rng.standard_normal(16).astype(np.float32)
    rid = col.insert(v, "hello")
    assert rid == 1
    rec = col.get(rid)
    np.testing.assert_allclose(rec.vector, v, rtol=1e-6)
    assert rec.payload == "hello"
    col.delete(rid)
    with pytest.raises(RecordNotFoundError):
        col.get(rid)
    with pytest.raises(RecordNotFoundError):
        col.delete(rid)
    assert col.count == 0


def test_update(tmp_path, rng):
    col = new_col(tmp_path)
    v1 = rng.standard_normal(16).astype(np.float32)
    v2 = rng.standard_normal(16).astype(np.float32)
    rid = col.insert(v1, "one")
    col.update(rid, v2, "two")
    rec = col.get(rid)
    np.testing.assert_allclose(rec.vector, v2, rtol=1e-6)
    assert rec.payload == "two"
    assert col.count == 1
    with pytest.raises(RecordNotFoundError):
        col.update(999, v2, "nope")


def test_out_of_range_ids_rejected(tmp_path, rng):
    """ids outside (0, 2**64-1) must fail cleanly BEFORE the ctypes
    boundary, where c_uint64 masks 2**64 -> 0 (aliasing another record),
    and before numpy raises a raw OverflowError on the bulk path."""
    col = new_col(tmp_path)
    v = rng.standard_normal(16).astype(np.float32)
    rid = col.insert(v, "hello")
    for bad in (0, -1, 2**64, 2**64 - 1, rid + 2**64, "xyzzy"):
        with pytest.raises(RecordNotFoundError):
            col.get(bad)
        with pytest.raises(RecordNotFoundError):
            col.delete(bad)
        with pytest.raises(RecordNotFoundError):
            col.update(bad, v, "nope")
    # bulk paths: a clean ValueError, never OverflowError / wraparound
    with pytest.raises(ValueError):
        col.delete_many([rid, 2**64])
    with pytest.raises(ValueError):
        col.search_similar(v, k=1, within_ids=[2**70])
    # numpy-typed inputs that asarray would silently MANGLE must be
    # rejected, not converted: signed arrays wrap (-1 -> 2**64-1), float
    # arrays truncate (1.9 -> record 1 — the wrong record).
    with pytest.raises(ValueError):
        col.delete_many(np.array([-1, -2], dtype=np.int64))
    with pytest.raises(ValueError):
        col.delete_many(np.array([float(rid) + 0.9]))
    with pytest.raises(ValueError):
        col.search_similar(v, k=1, exclude_ids=np.array([-2], np.int64))
    # non-integral scalars never truncate onto a live record
    with pytest.raises(RecordNotFoundError):
        col.delete(float(rid) + 0.7)
    # the valid record is untouched by all of the above
    assert col.count == 1
    assert col.get(rid).payload == "hello"
    # ...but exact float/np representations of a live id ARE that id, on
    # the native and pure-Python allocators alike (normalized before the
    # ctypes boundary, which would otherwise raise ArgumentError)
    assert col.get(np.float64(rid)).payload == "hello"
    col.delete(np.uint64(rid))
    assert col.count == 0
    # empty bulk inputs remain valid
    assert col.delete_many([]) == 0
    assert col.delete_many(np.empty(0, np.int64)) == 0


def test_dim_check(tmp_path, rng):
    col = new_col(tmp_path)
    with pytest.raises(DimensionMismatchError):
        col.insert(rng.standard_normal(7).astype(np.float32))
    with pytest.raises(DimensionMismatchError):
        col.search_similar(rng.standard_normal(7).astype(np.float32))


def test_bulk_insert_and_search(tmp_path, rng):
    col = new_col(tmp_path)
    vecs = rng.standard_normal((200, 16)).astype(np.float32)
    rids = col.bulk_insert(vecs, [f"p{i}" for i in range(200)])
    assert len(rids) == 200 and col.count == 200
    hits = col.search_similar(vecs[13], k=1)
    assert hits[0].record_id == rids[13]
    assert hits[0].payload == "p13"


def test_wal_replay_after_crash(tmp_path, rng):
    """Kill before any snapshot: reload must replay the full WAL."""
    col = new_col(tmp_path)
    vecs = rng.standard_normal((50, 16)).astype(np.float32)
    rids = col.bulk_insert(vecs)
    col.delete(int(rids[10]))
    col.update(int(rids[20]), vecs[0], "patched")
    # no close/snapshot — simulate process death (WAL was fsync'd per op)
    col2 = Collection.load(tmp_path / "c")
    assert col2.count == 49
    assert col2.next_id == col.next_id
    with pytest.raises(RecordNotFoundError):
        col2.get(int(rids[10]))
    rec = col2.get(int(rids[20]))
    assert rec.payload == "patched"
    np.testing.assert_allclose(rec.vector, vecs[0], rtol=1e-6)
    hits = col2.search_similar(vecs[5], k=1)
    assert hits[0].record_id == rids[5]


def test_snapshot_restore_and_tail_replay(tmp_path, rng):
    col = new_col(tmp_path)
    vecs = rng.standard_normal((80, 16)).astype(np.float32)
    rids = col.bulk_insert(vecs, [f"p{i}" for i in range(80)])
    col.snapshot()
    assert col.wal.frame_count == 0
    # post-snapshot tail ops
    extra = rng.standard_normal((5, 16)).astype(np.float32)
    extra_ids = col.bulk_insert(extra)
    col.delete(int(rids[0]))
    col2 = Collection.load(tmp_path / "c")
    assert col2.count == 84
    assert col2.get(int(extra_ids[0])) is not None
    with pytest.raises(RecordNotFoundError):
        col2.get(int(rids[0]))
    hits = col2.search_similar(vecs[7], k=1)
    assert hits[0].record_id == rids[7]
    assert hits[0].payload == "p7"


def test_torn_wal_tail_recovery(tmp_path, rng):
    """Fault injection: process dies mid-BULKINSERT append (SURVEY §7.4).

    The torn frame was never acked, so recovery must converge to the state
    before the interrupted op."""
    col = new_col(tmp_path)
    vecs = rng.standard_normal((30, 16)).astype(np.float32)
    col.bulk_insert(vecs)
    wal_path = tmp_path / "c" / "vr_wal"
    # Append half a frame: valid magic + truncated body.
    with open(wal_path, "ab") as f:
        f.write(b"\x57\x4c\x5f\x31" + b"\x02" * 11)
    col2 = Collection.load(tmp_path / "c")
    assert col2.count == 30
    # The WAL is usable again after recovery.
    col2.insert(vecs[0], "post-crash")
    col3 = Collection.load(tmp_path / "c")
    assert col3.count == 31


def test_reindex_compacts(tmp_path, rng):
    col = new_col(tmp_path)
    vecs = rng.standard_normal((100, 16)).astype(np.float32)
    rids = col.bulk_insert(vecs)
    for rid in rids[::2]:
        col.delete(int(rid))
    assert col.alloc.high_water == 100
    moved = col.reindex()
    assert col.alloc.high_water == 50
    assert col.count == 50
    assert moved > 0
    # data still correct after the device gather/scatter moves
    for rid in rids[1::2][:10]:
        rec = col.get(int(rid))
        np.testing.assert_allclose(rec.vector, vecs[int(rid) - 1], rtol=1e-6)
    hits = col.search_similar(vecs[1], k=1)
    assert hits[0].record_id == rids[1]
    # reindex snapshots + truncates the WAL
    assert col.wal.frame_count == 0
    col2 = Collection.load(tmp_path / "c")
    assert col2.count == 50


def test_free_slot_reuse_after_delete(tmp_path, rng):
    col = new_col(tmp_path)
    vecs = rng.standard_normal((10, 16)).astype(np.float32)
    rids = col.bulk_insert(vecs)
    hw = col.alloc.high_water
    col.delete(int(rids[3]))
    new_vec = rng.standard_normal(16).astype(np.float32)
    col.insert(new_vec, "reused")
    assert col.alloc.high_water == hw  # recycled the freed slot
    hits = col.search_similar(new_vec, k=1)
    assert hits[0].payload == "reused"


def test_sharded_collection(tmp_path, rng):
    col = new_col(tmp_path, shards=8)
    vecs = rng.standard_normal((500, 16)).astype(np.float32)
    rids = col.bulk_insert(vecs)
    hits = col.search_similar(vecs[123], k=3)
    assert hits[0].record_id == rids[123]
    col.snapshot()
    col2 = Collection.load(tmp_path / "c", devices=[CPU] * 8)
    assert col2.engine.shards == 8
    hits = col2.search_similar(vecs[123], k=3)
    assert hits[0].record_id == rids[123]


def test_snapshot_corruption_detected(tmp_path, rng):
    from vrod_tpu_torch.errors import WalCorruptionError
    col = new_col(tmp_path)
    col.bulk_insert(rng.standard_normal((20, 16)).astype(np.float32))
    col.snapshot()
    vec_file = tmp_path / "c" / "snapshot" / "vectors.bin"
    data = bytearray(vec_file.read_bytes())
    data[-5] ^= 0xFF
    vec_file.write_bytes(bytes(data))
    with pytest.raises(WalCorruptionError, match="corrupt"):
        Collection.load(tmp_path / "c")


def test_wal_sync_off_still_replays_after_clean_close(tmp_path, rng):
    """wal_sync=False trades durability-on-crash for insert throughput;
    data written before a clean close must still replay."""
    cfg = CollectionConfig(name="ns", dim=16, segment_rows=64)
    col = Collection.create(tmp_path / "ns", cfg, wal_sync=False)
    vecs = rng.standard_normal((40, 16)).astype(np.float32)
    col.bulk_insert(vecs)
    col.close()
    col2 = Collection.load(tmp_path / "ns")
    assert col2.count == 40
    col2.close()


def test_restore_on_smaller_topology(tmp_path, rng):
    """A snapshot from an 8-shard mesh restores on fewer devices (shard
    count clamps; ids/vectors are topology-independent)."""
    import warnings
    col = new_col(tmp_path, name="pod", shards=8)
    vecs = rng.standard_normal((300, 16)).astype(np.float32)
    rids = col.bulk_insert(vecs)
    col.snapshot()
    col.close()
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        col2 = Collection.load(tmp_path / "pod",
                               devices=[CPU] * 2)
        assert any("shards" in str(x.message) for x in w)
    assert col2.engine.shards == 2
    assert col2.count == 300
    hits = col2.search_similar(vecs[123], k=1)
    assert hits[0].record_id == rids[123]


def test_delete_many(tmp_path, rng):
    col = new_col(tmp_path)
    vecs = rng.standard_normal((50, 16)).astype(np.float32)
    rids = col.bulk_insert(vecs)
    n = col.delete_many(list(rids[10:30]) + [99999])  # one unknown id
    assert n == 20
    assert col.count == 30
    assert col.wal.frame_count == 2  # bulk insert + bulk delete
    # deleted records gone, survivors searchable, replay converges
    col2 = Collection.load(tmp_path / "c")
    assert col2.count == 30
    with pytest.raises(RecordNotFoundError):
        col2.get(int(rids[10]))
    hits = col2.search_similar(vecs[5], k=1)
    assert hits[0].record_id == rids[5]
    assert col.delete_many([99999]) == 0


def test_failed_apply_rewinds_wal(tmp_path, rng):
    """A mutation whose device apply fails must not materialize on replay
    (the WAL frame was never acked)."""
    col = new_col(tmp_path, "rw", dim=8, segment_rows=64)
    col.insert(rng.standard_normal(8), "keep")
    boom = RuntimeError("simulated device OOM")

    orig = col._apply_insert

    def failing(*a, **kw):
        raise boom

    col._apply_insert = failing
    import pytest as _pytest
    with _pytest.raises(RuntimeError):
        col.insert(rng.standard_normal(8), "phantom")
    col._apply_insert = orig
    col.close()

    col2 = Collection.load(tmp_path / "rw")
    assert col2.count == 1
    assert col2.get(1).payload == "keep"
    with _pytest.raises(Exception):
        col2.get(2)
    col2.close()


def test_bulk_insert_chunks_wal_frames(tmp_path, rng):
    """Large BULKINSERTs write multiple bounded WAL frames, and a replay
    across the frame boundary reconstructs every record."""
    col = new_col(tmp_path, "chunky", dim=8, segment_rows=4096)
    # Force tiny frames so the test exercises multi-frame bulks cheaply.
    col.WAL_FRAME_ROWS_MAX = 100
    vecs = rng.standard_normal((256, 8)).astype("float32")
    rids = col.bulk_insert(vecs, [f"p{i}" for i in range(256)])
    assert col.wal.frame_count == 3  # ceil(256/100)
    col.close()
    col2 = Collection.load(tmp_path / "chunky")
    assert col2.count == 256
    assert col2.get(int(rids[255])).payload == "p255"
    assert col2.get(int(rids[100])).payload == "p100"
    col2.close()


def test_reindex_reclaims_capacity_after_mass_delete(tmp_db, rng):
    """REINDEX shrinks device capacity to the live set's segments: the
    scan pays for CAPACITY (static shapes), so this restores post-delete
    QPS. Exactness and durability must survive the shrink."""
    col = tmp_db.create_collection("shrinkme", dim=16, segment_rows=64)
    vecs = rng.standard_normal((600, 16)).astype(np.float32)
    rids = col.bulk_insert(vecs, payloads=[f"p{i}" for i in range(600)])
    cap_before = col.engine.capacity
    assert cap_before >= 600
    col.delete_many(rids[40:])          # keep 40 live
    moved = col.reindex()
    assert col.engine.capacity == 64    # one segment
    assert col.engine.capacity == col.alloc.capacity
    assert col.count == 40
    # exactness after shrink
    hits = col.search_similar(vecs[7], k=1)
    assert hits[0].record_id == int(rids[7])
    assert hits[0].payload == "p7"
    # inserts regrow cleanly
    col.bulk_insert(rng.standard_normal((100, 16)).astype(np.float32))
    assert col.engine.capacity >= 128
    # durability across restart
    from vrod_tpu_torch.collection import Collection
    col2 = Collection.load(col.path)
    assert col2.count == 140
    hits = col2.search_similar(vecs[7], k=1)
    assert hits[0].record_id == int(rids[7])
    col2.close()


def test_delete_many_dedupes_and_counts_once(tmp_db, rng):
    col = tmp_db.create_collection("dd", dim=8, segment_rows=64)
    rids = col.bulk_insert(rng.standard_normal((5, 8)).astype(np.float32))
    n = col.delete_many([int(rids[0]), int(rids[0]), int(rids[1])])
    assert n == 2
    assert col.count == 3


def test_insert_rejects_multi_row(tmp_db, rng):
    from vrod_tpu_torch.errors import DimensionMismatchError
    col = tmp_db.create_collection("mr", dim=8, segment_rows=64)
    with pytest.raises(DimensionMismatchError, match="single vector"):
        col.insert(rng.standard_normal((2, 8)).astype(np.float32))
