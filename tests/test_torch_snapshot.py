"""Snapshot redesign tests: crash-safe swap, streaming IO, fuzzy
(non-blocking) snapshots with concurrent mutations, fallback restore.

``tests/test_snapshot.py`` (11 cases) over ``vrod_tpu_torch``, the same
cases and oracles. One is rewritten to the port's coordination client:
``test_multiprocess_snapshot_interleaves_writers_between_chunks`` runs its
one-rank agreement over a real ``torch.distributed.TCPStore`` in this
process (the port's client, ``set``/``wait``/``get``/``delete_key``) where
JAX's file fakes the coordination service's ``key_value_*`` calls.
"""

import json
import shutil
import threading

import numpy as np
import pytest

from vrod_tpu_torch.collection import Collection
from vrod_tpu_torch.config import SNAPSHOT_DIR, CollectionConfig
from vrod_tpu_torch import snapshot as snapio


def new_col(tmp_path, name="c", **kw):
    kw.setdefault("dim", 16)
    kw.setdefault("segment_rows", 64)
    cfg = CollectionConfig(name=name, **kw)
    return Collection.create(tmp_path / name, cfg)


def test_snapshot_roundtrip_streaming(tmp_path, rng):
    col = new_col(tmp_path, "s")
    col.SNAPSHOT_CHUNK_ROWS = 10  # force many chunks
    vecs = rng.standard_normal((37, 16)).astype(np.float32)
    rids = col.bulk_insert(vecs, [f"p{i}" for i in range(37)])
    col.snapshot()
    assert col.wal.frame_count == 0  # fully captured
    col.close()
    col2 = Collection.load(tmp_path / "s")
    col2.SNAPSHOT_CHUNK_ROWS = 10
    assert col2.count == 37
    assert col2.get(int(rids[36])).payload == "p36"
    np.testing.assert_allclose(col2.get(int(rids[3])).vector, vecs[3],
                               rtol=1e-6)
    col2.close()


def test_wal_tail_survives_snapshot(tmp_path, rng):
    """Ops appended after the snapshot cut must survive truncate_until."""
    col = new_col(tmp_path, "t")
    col.bulk_insert(rng.standard_normal((8, 16)), [f"a{i}" for i in range(8)])
    col.snapshot()
    col.insert(rng.standard_normal(16), "after-cut")
    # Another snapshot captures it; WAL empties again.
    col.snapshot()
    assert col.wal.frame_count == 0
    col.close()
    col2 = Collection.load(tmp_path / "t")
    assert col2.count == 9
    col2.close()


def test_crash_between_swap_renames(tmp_path, rng):
    """Simulate a crash after the old snapshot was renamed aside but before
    the new one was renamed in: restore falls back to .old + full WAL."""
    col = new_col(tmp_path, "cr")
    rids = col.bulk_insert(rng.standard_normal((12, 16)),
                           [f"x{i}" for i in range(12)])
    col.snapshot()
    col.insert(rng.standard_normal(16), "late")
    col.close()
    d = tmp_path / "cr"
    # Forge the crash state: snapshot -> snapshot.old, no committed snapshot.
    (d / SNAPSHOT_DIR).rename(d / (SNAPSHOT_DIR + ".old"))
    col2 = Collection.load(d)
    assert col2.count == 13
    assert col2.get(int(rids[0])).payload == "x0"
    # Restore cleaned the leftover .old after success... it restored FROM
    # .old, so it must still be there (it is the only durable base).
    col2.close()


def test_corrupt_snapshot_falls_back_to_old(tmp_path, rng):
    col = new_col(tmp_path, "fb")
    col.bulk_insert(rng.standard_normal((10, 16)),
                    [f"y{i}" for i in range(10)])
    col.snapshot()
    col.close()
    d = tmp_path / "fb"
    # Keep a valid copy as .old, then corrupt the committed snapshot.
    shutil.copytree(d / SNAPSHOT_DIR, d / (SNAPSHOT_DIR + ".old"))
    vp = d / SNAPSHOT_DIR / "vectors.bin"
    raw = bytearray(vp.read_bytes())
    raw[-3] ^= 0xFF
    vp.write_bytes(bytes(raw))
    with pytest.warns(UserWarning, match="restoring from"):
        col2 = Collection.load(d)
    assert col2.count == 10
    col2.close()


def test_corrupt_snapshot_no_fallback_raises(tmp_path, rng):
    col = new_col(tmp_path, "cx")
    col.bulk_insert(rng.standard_normal((4, 16)))
    col.snapshot()
    col.close()
    vp = tmp_path / "cx" / SNAPSHOT_DIR / "vectors.bin"
    raw = bytearray(vp.read_bytes())
    raw[-1] ^= 0x55
    vp.write_bytes(bytes(raw))
    from vrod_tpu_torch.errors import WalCorruptionError
    with pytest.raises(WalCorruptionError):
        Collection.load(tmp_path / "cx")


def test_complete_tmp_restorable(tmp_path, rng):
    """A finished-but-unrenamed .tmp (crash between fsync and rename, with
    no prior snapshot) restores, because the WAL was not yet truncated."""
    col = new_col(tmp_path, "tm")
    col.bulk_insert(rng.standard_normal((6, 16)),
                    [f"z{i}" for i in range(6)])
    col.snapshot()
    col.close()
    d = tmp_path / "tm"
    (d / SNAPSHOT_DIR).rename(d / (SNAPSHOT_DIR + ".tmp"))
    col2 = Collection.load(d)
    assert col2.count == 6
    col2.close()


def test_snapshot_concurrent_with_searches_and_inserts(tmp_path, rng):
    """The snapshot must not block the world: searches and inserts proceed
    while it runs, and a restore afterwards is exact."""
    col = new_col(tmp_path, "cc", segment_rows=256)
    base = rng.standard_normal((300, 16)).astype(np.float32)
    col.bulk_insert(base, [f"b{i}" for i in range(300)])
    col.SNAPSHOT_CHUNK_ROWS = 16  # many short read-lock windows

    stop = threading.Event()
    errors = []
    progressed = {"searches": 0, "inserts": 0}

    def searcher():
        try:
            while not stop.is_set():
                hits = col.search_similar(base[7], k=3)
                assert hits[0].record_id == 8  # ids are 1-based
                progressed["searches"] += 1
        except Exception as e:  # pragma: no cover
            errors.append(e)

    def inserter():
        try:
            while not stop.is_set():
                col.insert(rng.standard_normal(16), "live")
                progressed["inserts"] += 1
        except Exception as e:  # pragma: no cover
            errors.append(e)

    threads = [threading.Thread(target=searcher),
               threading.Thread(target=inserter)]
    for t in threads:
        t.start()
    try:
        for _ in range(3):
            col.snapshot()
    finally:
        stop.set()
        for t in threads:
            t.join()
    assert not errors, errors
    assert progressed["searches"] > 0 and progressed["inserts"] > 0
    expected = col.count
    col.close()
    col2 = Collection.load(tmp_path / "cc")
    assert col2.count == expected
    assert col2.get(8).payload == "b7"
    col2.close()


def test_multiprocess_snapshot_interleaves_writers_between_chunks(
        tmp_path, rng, monkeypatch):
    """Round 5 replaced the r4 whole-gather write-lock hold with PER-CHUNK
    agreed write locks (collection._snapshot_run): on a process-spanning
    mesh each gather chunk dispatches under a cross-rank-agreed mutation
    generation, so a concurrent collective mutation lands BETWEEN chunks
    instead of stalling for the whole capture, and the fuzzy capture is
    made exact by the preserved WAL tail on restore — the same discipline
    as the single-process snapshot. Simulated on a 1-rank engine
    (multiprocess=True; the host-side KV agreement degenerates to one
    rank over a fake in-process client). The real two-process leg is
    tests/test_multihost.py (writer-progress + byte-identical rank dirs)."""
    import torch.distributed as tdist

    from vrod_tpu_torch.parallel import distributed

    # The port's coordination client is the process group's TCPStore: a
    # one-rank store in this process stands in for it.
    store = tdist.TCPStore("127.0.0.1", 0, 1, True)
    monkeypatch.setattr(distributed, "coordination_client", lambda: store)

    col = new_col(tmp_path, "mp", segment_rows=64)
    col.bulk_insert(rng.standard_normal((30, 16)).astype(np.float32),
                    [f"b{i}" for i in range(30)])
    col.SNAPSHOT_CHUNK_ROWS = 8  # 30 rows -> 4 gather chunks
    col.engine.multiprocess = True

    # Stall the snapshot BETWEEN chunks (write_rows runs after the chunk's
    # agreed lock is released) and require a concurrent insert to complete
    # there — under the r4 whole-gather hold this deadlocked the test.
    first_chunk_written = threading.Event()
    mutated = threading.Event()
    orig_write = snapio.RawStreamWriter.write_rows

    def gating_write(self, rows):
        orig_write(self, rows)
        if not first_chunk_written.is_set():
            first_chunk_written.set()
            assert mutated.wait(30), \
                "insert did not interleave between gather chunks"

    monkeypatch.setattr(snapio.RawStreamWriter, "write_rows", gating_write)

    def mutate():
        assert first_chunk_written.wait(60)
        col.insert(rng.standard_normal(16).astype(np.float32), "late")
        mutated.set()

    m = threading.Thread(target=mutate)
    m.start()
    snap = col.snapshot()
    m.join(60)
    assert mutated.is_set()
    assert snap.exists()
    assert col.count == 31
    # The late insert has LSN > the cut: it must survive via the preserved
    # WAL tail (idempotent replay), exactly like single-process snapshots.
    assert col.wal.frame_count >= 1
    col.engine.multiprocess = False
    col.close()
    col2 = Collection.load(tmp_path / "mp")
    assert col2.count == 31
    assert col2.get(31).payload == "late"
    col2.close()


def test_payload_stream_roundtrip(tmp_path):
    payloads = ["", "hello", "semi;colon", "new\nline", "uni: éß☃",
                "x" * 10000]
    pw = snapio.PayloadStreamWriter(tmp_path / "p.bin", len(payloads))
    pw.write_many(payloads[:2])
    pw.write_many(payloads[2:])
    crc = pw.close()
    assert crc == snapio.crc32_of_file(tmp_path / "p.bin")
    got = [p for chunk in snapio.read_payloads(tmp_path / "p.bin",
                                               chunk_records=2,
                                               read_chunk=64)
           for p in chunk]
    assert got == payloads


def test_legacy_round1_snapshot_still_loads(tmp_path, rng):
    """Snapshots written by the round-1 layout (payloads.json, whole-file
    arrays) must keep restoring."""
    col = new_col(tmp_path, "lg")
    vecs = rng.standard_normal((5, 16)).astype(np.float32)
    rids = col.bulk_insert(vecs, [f"old{i}" for i in range(5)])
    col.close()
    d = tmp_path / "lg"
    snap = d / SNAPSHOT_DIR
    snap.mkdir()
    import zlib
    np.save(snap / "ids.npy", rids.astype(np.uint64))
    np.save(snap / "vectors.npy", vecs)
    (snap / "payloads.json").write_text(json.dumps(
        {str(int(r)): f"old{i}" for i, r in enumerate(rids)}))
    crcs = {f: zlib.crc32((snap / f).read_bytes()) & 0xFFFFFFFF
            for f in ("ids.npy", "vectors.npy", "payloads.json")}
    (snap / "meta.json").write_text(json.dumps(
        {"next_id": 6, "count": 5, "last_lsn": 1, "crc32": crcs}))
    # Blow away the WAL as a round-1 snapshot+truncate would have.
    (d / "vr_wal").write_bytes(b"")
    col2 = Collection.load(d)
    assert col2.count == 5
    assert col2.get(int(rids[4])).payload == "old4"
    col2.close()


def test_snapshot_of_empty_wal_preserves_lsn_high_water(tmp_path, rng):
    """A snapshot cut while the WAL is already empty (e.g. REINDEX right
    after a snapshot) must record the durable LSN HIGH-WATER, not
    wal.last_lsn == 0 — recording 0 resets LSN assignment after restore
    (breaking cross-restart monotonicity) and hands replication
    bootstraps a position of 0 below the primary's floor (infinite
    resync loop; found by the replication fuzz)."""
    import json
    from vrod_tpu_torch.database import Database

    db = Database.new(tmp_path, "db")
    col = db.create_collection("c", dim=4, segment_rows=64)
    col.bulk_insert(rng.standard_normal((5, 4)).astype(np.float32))
    col.snapshot()
    floor = col.repl_position()
    assert floor > 0 and col.wal.last_lsn == 0  # WAL truncated

    col.reindex()  # snapshots again, with the WAL still empty
    meta = json.loads(
        (col.path / "snapshot" / "meta.json").read_text())
    assert meta["last_lsn"] == floor  # high-water preserved
    assert col.repl_position() == floor
    db.close()

    db = Database.load(tmp_path / "db")
    try:
        col = db.collection("c")
        assert col.repl_position() == floor
        rid = col.insert(np.ones(4, dtype=np.float32), "post")
        # The new mutation's LSN continues ABOVE the pre-restart history.
        assert col.wal.last_lsn > floor
        assert col.get(rid).payload == "post"
    finally:
        db.close()
