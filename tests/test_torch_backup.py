"""Online BACKUP: consistent point-in-time copy, restorable anywhere.

Extension verb (no reference counterpart; the reference's durability story
is vr_wal alone — src/database/setup.rs:17-23). The contract under test:
a backup taken while the database serves reads and writes loads cleanly,
contains every mutation acked before the backup started, and shares no
mutable state with the live store.

``tests/test_backup.py`` (25 cases) over ``vrod_tpu_torch``, the same
cases and oracles, unchanged but for the package they import.
"""

import json
import threading

import numpy as np
import pytest

from vrod_tpu_torch.commands import CommandBuilder
from vrod_tpu_torch.config import CONFIG_FILE, SNAPSHOT_DIR, WAL_FILE
from vrod_tpu_torch.database import Database
from vrod_tpu_torch.errors import DatabaseExistsError, MissingCommandArgError


@pytest.fixture
def tmp_db(tmp_path):
    """The port's database (conftest's ``tmp_db`` is the JAX package's)."""
    from vrod_tpu_torch.database import Database
    db = Database.new(tmp_path, "testdb")
    yield db
    db.close()


def _fill(col, n, dim, rng, payload_prefix="p"):
    vecs = rng.standard_normal((n, dim)).astype(np.float32)
    rids = col.bulk_insert(vecs, [f"{payload_prefix}{i}" for i in range(n)])
    return vecs, rids


def test_backup_round_trip(tmp_db, tmp_path, rng):
    """Snapshot + WAL-tail + WAL-only collections all restore bit-exactly."""
    a = tmp_db.create_collection("a", dim=8, segment_rows=64)
    vecs_a, rids_a = _fill(a, 20, 8, rng, "a")
    a.snapshot()
    extra = rng.standard_normal((5, 8)).astype(np.float32)
    extra_ids = a.bulk_insert(extra, [f"tail{i}" for i in range(5)])
    a.delete(int(rids_a[3]))

    b = tmp_db.create_collection("b", dim=4, metric="l2", segment_rows=64)
    vecs_b, _ = _fill(b, 7, 4, rng, "b")  # never snapshotted: WAL only

    stats = tmp_db.backup(tmp_path / "bk")
    assert stats["collections"] == 2
    assert stats["wal_bytes"] > 0

    db2 = Database.load(tmp_path / "bk")
    try:
        a2 = db2.collection("a")
        assert a2.count == a.count == 24
        # Payloads and vectors round-trip, including the WAL tail.
        rec = a2.get(int(extra_ids[2]))
        assert rec.payload == "tail2"
        np.testing.assert_allclose(rec.vector, extra[2], rtol=1e-6)
        with pytest.raises(Exception):
            a2.get(int(rids_a[3]))  # the delete was captured
        b2 = db2.collection("b")
        assert b2.count == 7
        hits = b2.search_similar(vecs_b[0], k=1)
        assert hits[0].record_id == 1 and hits[0].payload == "b0"
    finally:
        db2.close()


def test_backup_excludes_caches_and_locks(tmp_db, tmp_path, rng):
    col = tmp_db.create_collection("c", dim=4, segment_rows=64,
                                   payload_store="disk")
    _fill(col, 6, 4, rng)
    col.snapshot()
    tmp_db.backup(tmp_path / "bk")
    cdir = tmp_path / "bk" / "collections" / "c"
    assert not (cdir / "payloads.db").exists()  # rebuildable cache
    assert not (tmp_path / "bk" / "vr_lock").exists()
    assert (cdir / CONFIG_FILE).exists()
    assert (cdir / WAL_FILE).exists()
    # The payloads still restore (snapshot carries them).
    db2 = Database.load(tmp_path / "bk")
    try:
        assert db2.collection("c").get(1).payload == "p0"
    finally:
        db2.close()


def test_backup_is_independent_bytes(tmp_db, tmp_path, rng):
    """No shared inodes: corrupting the backup must not touch the live DB."""
    col = tmp_db.create_collection("c", dim=4, segment_rows=64)
    _fill(col, 6, 4, rng)
    col.snapshot()
    tmp_db.backup(tmp_path / "bk")
    snap = tmp_path / "bk" / "collections" / "c" / SNAPSHOT_DIR
    for f in snap.iterdir():
        assert f.stat().st_nlink == 1, f"{f} is hardlinked to the live store"


def test_backup_refuses_existing_dest(tmp_db, tmp_path):
    (tmp_path / "bk").mkdir()
    with pytest.raises(DatabaseExistsError):
        tmp_db.backup(tmp_path / "bk")


def test_backup_failure_leaves_no_dest(tmp_db, tmp_path, rng, monkeypatch):
    """A failed backup must not leave a half-image that loads as a DB."""
    col = tmp_db.create_collection("c", dim=4, segment_rows=64)
    _fill(col, 4, 4, rng)

    def boom(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(type(col), "backup_into", boom)
    with pytest.raises(OSError):
        tmp_db.backup(tmp_path / "bk")
    assert not (tmp_path / "bk").exists()
    assert not (tmp_path / "bk.tmp").exists()


def test_backup_cold_collection(tmp_path, rng):
    """A never-loaded collection is copied without forcing a device restore."""
    db = Database.new(tmp_path, "db")
    col = db.create_collection("cold", dim=4, segment_rows=64)
    _fill(col, 9, 4, rng)
    col.snapshot()
    db.close()

    db = Database.load(tmp_path / "db")
    try:
        assert "cold" not in db._collections  # lazy: still cold
        db.backup(tmp_path / "bk")
        assert "cold" not in db._collections  # backup kept it cold
    finally:
        db.close()
    db2 = Database.load(tmp_path / "bk")
    try:
        assert db2.collection("cold").count == 9
    finally:
        db2.close()


def test_backup_verb_and_errors(tmp_db, tmp_path, rng):
    col = tmp_db.create_collection("c", dim=4, segment_rows=64)
    _fill(col, 3, 4, rng)
    out = CommandBuilder(tmp_db).build(
        None, "backup", str(tmp_path / "bk")).execute()
    assert "Backed up 1 collections" in out
    with pytest.raises(MissingCommandArgError):
        CommandBuilder(tmp_db).build(None, "BACKUP", None).execute()
    db2 = Database.load(tmp_path / "bk")
    try:
        assert db2.collection("c").count == 3
    finally:
        db2.close()


def test_backup_under_concurrent_mutations(tmp_db, tmp_path, rng):
    """Every record acked before the backup starts is in the image; the
    image loads cleanly regardless of writes racing the copy."""
    col = tmp_db.create_collection("c", dim=8, segment_rows=64)
    pre_vecs, pre_ids = _fill(col, 30, 8, rng, "pre")
    col.snapshot()
    _fill(col, 10, 8, rng, "tail")  # WAL tail beyond the snapshot

    stop = threading.Event()
    errs = []

    def mutate():
        i = 0
        while not stop.is_set():
            try:
                rid = col.insert(rng.standard_normal(8).astype(np.float32),
                                 f"live{i}")
                if i % 3 == 0:
                    col.delete(rid)
                i += 1
            except Exception as e:  # pragma: no cover
                errs.append(e)
                return

    t = threading.Thread(target=mutate)
    t.start()
    try:
        stats = tmp_db.backup(tmp_path / "bk")
    finally:
        stop.set()
        t.join()
    assert not errs
    assert stats["collections"] == 1

    db2 = Database.load(tmp_path / "bk")
    try:
        c2 = db2.collection("c")
        # All 40 pre-backup records present with exact payloads.
        for rid in pre_ids[:5].tolist():
            assert c2.get(rid).payload == f"pre{rid - 1}"
        assert c2.count >= 40
        # No stale hold dirs left in the live collection dir.
        assert not list(col.path.glob(".snap_hold_*"))
    finally:
        db2.close()


def test_backup_after_crash_recovered_fallback_snapshot(tmp_path, rng):
    """A crash between the snapshot-swap renames leaves the data in
    snapshot.old with a truncated WAL; a backup (or replication bootstrap)
    taken after the reload must still carry the snapshot-covered records.
    The load normalizes the fallback to the committed name (collection.py
    _restore), which this test pins."""
    db = Database.new(tmp_path, "db")
    col = db.create_collection("c", dim=4, segment_rows=64)
    vecs, rids = _fill(col, 12, 4, rng)
    col.snapshot()  # WAL truncated: records now live ONLY in the snapshot
    # Simulate the crash window in _snapshot_impl phase 3: the committed
    # dir was renamed to .old and the process died before tmp -> snapshot.
    (col.path / SNAPSHOT_DIR).rename(col.path / (SNAPSHOT_DIR + ".old"))
    db.close()

    db = Database.load(tmp_path / "db")
    try:
        col = db.collection("c")
        assert col.count == 12
        assert (col.path / SNAPSHOT_DIR).is_dir()  # normalized on load
        assert not (col.path / (SNAPSHOT_DIR + ".old")).exists()
        db.backup(tmp_path / "bk")
    finally:
        db.close()
    db2 = Database.load(tmp_path / "bk")
    try:
        assert db2.collection("c").count == 12
        assert db2.collection("c").get(int(rids[0])).payload == "p0"
    finally:
        db2.close()


# -- BACKUP;verify: offline image verification (vrod_tpu_torch/verify_image.py) --


def _made_image(tmp_db, tmp_path, rng):
    """Standard three-shape image: snapshot+tail, WAL-only, cold-ish."""
    a = tmp_db.create_collection("a", dim=8, segment_rows=64)
    _fill(a, 20, 8, rng, "a")
    a.snapshot()
    a.bulk_insert(rng.standard_normal((5, 8)).astype(np.float32),
                  [f"t{i}" for i in range(5)])
    b = tmp_db.create_collection("b", dim=4, metric="l2", segment_rows=64)
    _fill(b, 7, 4, rng, "b")
    tmp_db.backup(tmp_path / "bk")
    return tmp_path / "bk"


def test_verify_clean_image(tmp_db, tmp_path, rng):
    from vrod_tpu_torch.verify_image import verify_image
    img = _made_image(tmp_db, tmp_path, rng)
    rep = verify_image(img)
    assert rep["ok"], rep
    assert rep["collections"] == 2
    assert rep["snapshot_files"] == 4  # vectors/aux/payloads/ids (meta's crc map)
    assert rep["wal_frames"] > 0
    assert rep["errors"] == []


def test_verify_verb_surface(tmp_db, tmp_path, rng):
    """BACKUP -a <path>;verify returns an OK line; any other semicolon
    argument is a destination PATH (-a is a filesystem path — an unknown-
    option error would make semicolon paths unreachable)."""
    img = _made_image(tmp_db, tmp_path, rng)
    builder = CommandBuilder(tmp_db)
    out = builder.build(None, "BACKUP", f"{img};verify").execute()
    assert "OK" in out and "2 collections" in out
    semi_dest = tmp_path / "2026;08"
    out2 = builder.build(None, "BACKUP", str(semi_dest)).execute()
    assert "Backed up" in out2
    db2 = Database.load(semi_dest)
    try:
        assert set(db2.config.collections) == {"a", "b"}
    finally:
        db2.close()


def test_verify_detects_snapshot_bit_flip(tmp_db, tmp_path, rng):
    from vrod_tpu_torch.errors import WalCorruptionError
    from vrod_tpu_torch.verify_image import verify_image
    img = _made_image(tmp_db, tmp_path, rng)
    vec = img / "collections" / "a" / SNAPSHOT_DIR / "vectors.bin"
    data = bytearray(vec.read_bytes())
    data[len(data) // 2] ^= 0x40
    vec.write_bytes(bytes(data))
    rep = verify_image(img)
    assert not rep["ok"]
    assert any("vectors.bin crc32" in e for e in rep["errors"])
    with pytest.raises(WalCorruptionError):
        CommandBuilder(tmp_db).build(
            None, "BACKUP", f"{img};verify").execute()


def test_verify_detects_wal_corruption(tmp_db, tmp_path, rng):
    from vrod_tpu_torch.verify_image import verify_image
    img = _made_image(tmp_db, tmp_path, rng)
    wal = img / "collections" / "b" / WAL_FILE
    data = bytearray(wal.read_bytes())
    data[-3] ^= 0xFF  # flip a byte inside the LAST frame's payload
    wal.write_bytes(bytes(data))
    rep = verify_image(img)
    assert not rep["ok"]
    assert any("torn/corrupt tail" in e and "collections/b" in e
               for e in rep["errors"])


def test_verify_detects_lost_snapshot_coverage(tmp_db, tmp_path, rng):
    """A deleted snapshot directory means acked records exist on neither
    the snapshot nor the log. The backup manifest witnesses the deletion
    (per-file checksums cannot — the bytes are simply gone); without a
    manifest the verifier must err conservatively on the same shape."""
    import shutil
    from vrod_tpu_torch.config import BACKUP_MANIFEST_FILE
    from vrod_tpu_torch.verify_image import verify_image
    img = _made_image(tmp_db, tmp_path, rng)
    # Collection 'a' was snapshotted (WAL truncated to the tail), so its
    # WAL starts at cut+1; deleting every snapshot dir breaks coverage.
    for suffix in ("", ".old", ".tmp"):
        d = img / "collections" / "a" / (SNAPSHOT_DIR + suffix)
        if d.exists():
            shutil.rmtree(d)
    rep = verify_image(img)
    assert not rep["ok"]
    assert any("backup manifest but missing from the image" in e
               for e in rep["errors"])
    # Legacy image (no manifest): the shape is ambiguous with a rewound
    # genesis op, and the verifier must still flag it — conservatively.
    (img / BACKUP_MANIFEST_FILE).unlink()
    rep2 = verify_image(img)
    assert not rep2["ok"]
    assert any("no usable snapshot" in e for e in rep2["errors"])


def test_verify_accepts_rewound_genesis_ops(tmp_db, tmp_path, rng):
    """A never-snapshotted collection whose FIRST op failed at apply (WAL
    frame rewound, LSN consumed — next_lsn stays monotonic) legally has a
    WAL starting at LSN 2 and no snapshot. With the backup manifest ruling
    out a deleted snapshot dir, this healthy image must verify ok=True
    (warned); the pre-manifest verifier false-positived here."""
    from vrod_tpu_torch.verify_image import verify_image
    a = tmp_db.create_collection("a", dim=8, segment_rows=64)
    orig = a._apply_insert

    def failing(*args, **kw):
        a._apply_insert = orig
        raise RuntimeError("simulated device failure")

    a._apply_insert = failing
    with pytest.raises(RuntimeError):
        a.insert(rng.standard_normal(8), "phantom-genesis")
    _fill(a, 4, 8, rng, "a")  # WAL now starts at LSN 2
    tmp_db.backup(tmp_path / "bk")
    rep = verify_image(tmp_path / "bk")
    assert rep["ok"], rep["errors"]
    assert any("rewound never-acked genesis" in w for w in rep["warnings"])
    db2 = Database.load(tmp_path / "bk")
    try:
        assert db2.collection("a").count == 4
    finally:
        db2.close()


def test_verify_flags_manifest_tamper_and_size_drift(tmp_db, tmp_path,
                                                     rng):
    from vrod_tpu_torch.config import BACKUP_MANIFEST_FILE
    from vrod_tpu_torch.verify_image import verify_image
    img = _made_image(tmp_db, tmp_path, rng)
    man_p = img / BACKUP_MANIFEST_FILE
    # Semantic tamper that keeps the JSON parseable: self-checksum fails.
    original = man_p.read_text()
    man_p.write_text(original.replace('"format": 1', '"format": 2', 1)
                     if '"format": 1' in original
                     else original.replace('"format":1', '"format":2', 1))
    rep = verify_image(img)
    assert not rep["ok"]
    assert any("self-checksum mismatch" in e and "manifest" in e
               for e in rep["errors"])
    # Size drift on a listed file (appended bytes after the backup).
    man_p.write_text(original)
    with open(img / "collections" / "b" / WAL_FILE, "ab") as f:
        f.write(b"\x00" * 7)
    rep2 = verify_image(img)
    assert not rep2["ok"]
    assert any("backup manifest recorded" in e for e in rep2["errors"])


def test_verify_truncated_payload_header_is_report_not_crash(
        tmp_db, tmp_path, rng):
    """payloads.bin cut inside its own header (magic intact, count torn)
    must come back as a report error — verify_image's contract is 'never
    raises for content problems', and this shape used to escape as a raw
    struct.error."""
    from vrod_tpu_torch.verify_image import verify_image
    img = _made_image(tmp_db, tmp_path, rng)
    pay = img / "collections" / "a" / SNAPSHOT_DIR / "payloads.bin"
    head = pay.read_bytes()[:8]  # 5-byte magic + 3 of the 8 count bytes
    pay.write_bytes(head)
    rep = verify_image(img)  # must not raise
    assert not rep["ok"]
    assert any("truncated inside the header" in e for e in rep["errors"])


def test_verify_tolerates_rewind_lsn_holes(tmp_db, tmp_path, rng):
    """A failed (never-acked) apply rewinds its WAL frame but LSN
    assignment stays monotonic, leaving a hole in the sequence — a LEGAL
    image shape that must verify ok=True (warned, not errored). Both hole
    positions are exercised: mid-log and abutting the snapshot cut."""
    from vrod_tpu_torch.verify_image import verify_image

    def fail_next_apply(col):
        orig = col._apply_insert

        def failing(*a, **kw):
            col._apply_insert = orig
            raise RuntimeError("simulated device failure")

        col._apply_insert = failing

    a = tmp_db.create_collection("a", dim=8, segment_rows=64)
    _fill(a, 6, 8, rng, "a")
    fail_next_apply(a)
    with pytest.raises(RuntimeError):
        a.insert(rng.standard_normal(8), "phantom-mid")
    _fill(a, 3, 8, rng, "a2")  # mid-log hole

    b = tmp_db.create_collection("b", dim=4, segment_rows=64)
    _fill(b, 5, 4, rng, "b")
    b.snapshot()
    b.truncate_wal()
    fail_next_apply(b)
    with pytest.raises(RuntimeError):
        b.insert(rng.standard_normal(4), "phantom-cut")
    _fill(b, 2, 4, rng, "b2")  # hole abutting the snapshot cut

    tmp_db.backup(tmp_path / "bk")
    rep = verify_image(tmp_path / "bk")
    assert rep["ok"], rep["errors"]
    assert any("LSN hole" in w for w in rep["warnings"])
    assert any("on neither" in w for w in rep["warnings"])
    # And the image loads with every ACKED record intact.
    db2 = Database.load(tmp_path / "bk")
    try:
        assert db2.collection("a").count == 9
        assert db2.collection("b").count == 7
    finally:
        db2.close()


def test_verify_flags_meta_semantic_tamper(tmp_db, tmp_path, rng):
    """A byte flip inside meta.json that keeps the JSON parseable (found
    by the verify fuzz: 'storage' -> 'storaQe') must fail the meta
    self-checksum — the per-file crc map cannot protect meta itself, and
    restore keys on those fields."""
    from vrod_tpu_torch.verify_image import verify_image
    img = _made_image(tmp_db, tmp_path, rng)
    meta_p = img / "collections" / "a" / SNAPSHOT_DIR / "meta.json"
    meta_p.write_text(meta_p.read_text().replace('"storage"', '"storaQe"'))
    rep = verify_image(img)
    assert not rep["ok"]
    assert any("self-checksum mismatch" in e for e in rep["errors"])


def test_restore_rejects_meta_semantic_tamper(tmp_path, rng):
    """Restore must skip a snapshot whose meta self-checksum fails (and
    error loudly when no fallback validates) instead of keying on
    tampered fields."""
    from vrod_tpu_torch.errors import WalCorruptionError
    db = Database.new(tmp_path, "db")
    col = db.create_collection("c", dim=8, segment_rows=64)
    _fill(col, 9, 8, rng, "c")
    col.snapshot()
    db.close()
    meta_p = (tmp_path / "db" / "collections" / "c" / SNAPSHOT_DIR
              / "meta.json")
    meta_p.write_text(
        meta_p.read_text().replace('"count": 9', '"count": 8'))
    db2 = Database.load(tmp_path / "db")
    try:
        with pytest.raises(WalCorruptionError, match="corrupt"):
            db2.collection("c").count
    finally:
        db2.close()


def test_verify_flags_committed_snapshot_without_meta(tmp_db, tmp_path,
                                                      rng):
    """meta.json is written before the snapshot swap, so a committed dir
    without one can only mean damage (it is also what restore keys on)."""
    from vrod_tpu_torch.verify_image import verify_image
    img = _made_image(tmp_db, tmp_path, rng)
    (img / "collections" / "a" / SNAPSHOT_DIR / "meta.json").unlink()
    rep = verify_image(img)
    assert not rep["ok"]
    assert any("without meta.json" in e for e in rep["errors"])


def test_backup_cold_collection_excludes_torn_tail(tmp_path, rng):
    """A cold (never-loaded) collection whose last process crashed
    mid-append carries a torn WAL tail; BACKUP must copy only the valid
    prefix — the image verifies clean and loads every durable record."""
    from vrod_tpu_torch.verify_image import verify_image
    db = Database.new(tmp_path, "db")
    col = db.create_collection("c", dim=8, segment_rows=64)
    _fill(col, 6, 8, rng, "c")
    db.close()

    wal_p = tmp_path / "db" / "collections" / "c" / WAL_FILE
    clean = wal_p.stat().st_size
    with open(wal_p, "ab") as f:
        f.write(b"\x57\x4c\x5f\x31torn-mid-append")  # magic + short junk

    db2 = Database.load(tmp_path / "db")  # 'c' stays cold: never touched
    try:
        stats = db2.backup(tmp_path / "bk")
        assert stats["wal_bytes"] == clean
    finally:
        db2.close()
    img_wal = tmp_path / "bk" / "collections" / "c" / WAL_FILE
    assert img_wal.stat().st_size == clean
    rep = verify_image(tmp_path / "bk")
    assert rep["ok"], rep["errors"]
    db3 = Database.load(tmp_path / "bk")
    try:
        assert db3.collection("c").count == 6
    finally:
        db3.close()


def test_verify_detects_missing_collection_dir(tmp_db, tmp_path, rng):
    import shutil
    from vrod_tpu_torch.verify_image import verify_image
    img = _made_image(tmp_db, tmp_path, rng)
    shutil.rmtree(img / "collections" / "b")
    rep = verify_image(img)
    assert not rep["ok"]
    assert any("'b'" in e and "no directory" in e for e in rep["errors"])


def test_verify_warns_unlisted_dir_and_rejects_meta_mismatch(
        tmp_db, tmp_path, rng):
    import json as _json
    from vrod_tpu_torch.verify_image import verify_image
    img = _made_image(tmp_db, tmp_path, rng)
    (img / "collections" / "zzz").mkdir()
    (img / "collections" / "zzz" / CONFIG_FILE).write_text("{}")
    # Tamper with meta count (keeping its crc map intact is impossible for
    # ids.npy length, so this trips the structural check, not the crc one).
    meta_p = img / "collections" / "a" / SNAPSHOT_DIR / "meta.json"
    meta = _json.loads(meta_p.read_text())
    meta["count"] += 1
    # Restamp the self-checksum so the STRUCTURAL layer is what trips
    # (the self-checksum layer has its own dedicated test).
    from vrod_tpu_torch.snapshot import meta_self_crc
    meta["meta_crc"] = meta_self_crc(meta)
    meta_p.write_text(_json.dumps(meta))
    rep = verify_image(img)
    assert any("zzz" in w for w in rep["warnings"])
    assert not rep["ok"]  # sizes no longer match the recorded count
    assert any("expected" in e or "ids.npy holds" in e
               for e in rep["errors"])


def test_verify_missing_root(tmp_path):
    from vrod_tpu_torch.verify_image import verify_image
    with pytest.raises(FileNotFoundError):
        verify_image(tmp_path / "nope")
