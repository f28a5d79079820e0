"""The port's pull-based replication (``vrod_tpu_torch.replication``): the
cases of ``tests/test_replication.py`` over the port's Database, server and
CLI on the CPU: bootstrap from a shipped snapshot, WAL tail, resync,
promotion and fencing, read-your-writes, crash recovery.
"""

import numpy as np
import pytest

from vrod_tpu_torch import metrics
from vrod_tpu_torch.client import VrodClient, VrodServerError
from vrod_tpu_torch.database import Database
from vrod_tpu_torch.replication import Replicator
from vrod_tpu_torch.server import VrodServer

DIM = 8


@pytest.fixture
def tmp_db(tmp_path):
    """The port's Database (conftest's ``tmp_db`` is the JAX package's)."""
    db = Database.new(tmp_path, "testdb")
    yield db
    db.close()


@pytest.fixture
def primary(tmp_db, tmp_path):
    with VrodServer(tmp_db, f"unix:{tmp_path}/primary.sock").start() as s:
        yield tmp_db, s


@pytest.fixture
def replica_db(tmp_path):
    db = Database.new(tmp_path / "replica_home", "rdb")
    yield db
    db.close()


def _fill(db, name="c", n=24, seed=0, snapshot=True, tail=8):
    col = db.create_collection(name, dim=DIM, segment_rows=64)
    rng = np.random.default_rng(seed)
    vecs = rng.standard_normal((n, DIM)).astype(np.float32)
    col.bulk_insert(vecs[:n - tail], [f"p{i}" for i in range(n - tail)])
    if snapshot:
        col.snapshot()
    if tail:
        col.bulk_insert(vecs[n - tail:],
                        [f"p{i}" for i in range(n - tail, n)])
    return col, vecs


def _assert_identical(primary_col, replica_col):
    assert replica_col.count == primary_col.count
    p_slots = primary_col.alloc.live_slots()
    p_ids = np.sort(primary_col.alloc.ids_of(p_slots.astype(np.uint64)))
    r_slots = replica_col.alloc.live_slots()
    r_ids = np.sort(replica_col.alloc.ids_of(r_slots.astype(np.uint64)))
    np.testing.assert_array_equal(p_ids, r_ids)
    for rid in p_ids[:: max(1, len(p_ids) // 8)].tolist():
        p = primary_col.get(int(rid))
        r = replica_col.get(int(rid))
        np.testing.assert_array_equal(p.vector, r.vector)  # bit-identical
        assert p.payload == r.payload


def test_bootstrap_and_tail(primary, replica_db):
    db, server = primary
    col, vecs = _fill(db)  # snapshot + WAL tail
    wal_only, _ = _fill(db, "walonly", n=5, seed=1, snapshot=False, tail=0)

    with Replicator(replica_db, server.address).start() as rep:
        rep.wait_caught_up()
        assert sorted(replica_db.list_collections()) == ["c", "walonly"]
        _assert_identical(col, replica_db.collection("c"))
        _assert_identical(wal_only, replica_db.collection("walonly"))

        # Live mutations flow: insert / update / delete on the primary.
        rid = col.insert(vecs[0] * 0.5, "new")
        col.update(rid, vecs[1] * 2.0, "updated")
        col.delete(2)
        rep.wait_caught_up()
        _assert_identical(col, replica_db.collection("c"))
        r = replica_db.collection("c").get(rid)
        assert r.payload == "updated"

        # Replica searches are exact over the replicated state.
        q = vecs[3]
        ph = col.search_similar(q, k=3)
        rh = replica_db.collection("c").search_similar(q, k=3)
        assert [(h.record_id, h.payload) for h in ph] == \
               [(h.record_id, h.payload) for h in rh]


def test_replica_restart_resumes_without_bootstrap(primary, tmp_path):
    db, server = primary
    col, vecs = _fill(db)
    home = tmp_path / "rhome"
    rdb = Database.new(home, "rdb")
    with Replicator(rdb, server.address).start() as rep:
        rep.wait_caught_up()
    rdb.close()

    col.bulk_insert(vecs[:4] * 3.0, ["x0", "x1", "x2", "x3"])
    boots_before = metrics.counters.snapshot().get("repl.bootstraps", 0)
    rdb = Database.load(home / "rdb")
    try:
        with Replicator(rdb, server.address).start() as rep:
            rep.wait_caught_up()
            _assert_identical(col, rdb.collection("c"))
        # Resumed from its own durable WAL position: no second bootstrap.
        assert metrics.counters.snapshot().get(
            "repl.bootstraps", 0) == boots_before
    finally:
        rdb.close()


def test_resync_after_primary_truncation(primary, tmp_path):
    """A follower that was down across a primary snapshot (WAL truncated
    past its position) re-bootstraps and converges."""
    db, server = primary
    col, vecs = _fill(db)
    home = tmp_path / "rhome"
    rdb = Database.new(home, "rdb")
    with Replicator(rdb, server.address).start() as rep:
        rep.wait_caught_up()
    rdb.close()

    # While the follower is down: mutate, snapshot (truncates the WAL).
    col.bulk_insert(vecs[:6] * 1.5, [f"late{i}" for i in range(6)])
    col.delete(1)
    col.snapshot()

    resyncs_before = metrics.counters.snapshot().get("repl.resyncs", 0)
    rdb = Database.load(home / "rdb")
    try:
        with Replicator(rdb, server.address).start() as rep:
            rep.wait_caught_up()
            _assert_identical(col, rdb.collection("c"))
        assert metrics.counters.snapshot().get(
            "repl.resyncs", 0) == resyncs_before + 1
    finally:
        rdb.close()


def test_drop_propagates(primary, replica_db):
    db, server = primary
    _fill(db)
    _fill(db, "doomed", n=4, seed=2, tail=0)
    with Replicator(replica_db, server.address).start() as rep:
        rep.wait_caught_up()
        assert "doomed" in replica_db.list_collections()
        db.drop_collection("doomed")
        rep.wait_caught_up()
        assert replica_db.list_collections() == ["c"]


def test_collection_filter(primary, replica_db):
    db, server = primary
    _fill(db)
    _fill(db, "ignored", n=4, seed=3, tail=0)
    with Replicator(replica_db, server.address,
                    collections=["c"]).start() as rep:
        rep.wait_caught_up()
        assert replica_db.list_collections() == ["c"]


def test_read_only_replica_and_promote(primary, replica_db, tmp_path):
    db, server = primary
    col, vecs = _fill(db)
    rep = Replicator(replica_db, server.address).start()
    rserver = VrodServer(replica_db, f"unix:{tmp_path}/replica.sock",
                         read_only=True).start()
    rserver.attach_replicator(rep)
    try:
        rep.wait_caught_up()
        with VrodClient(rserver.address) as c:
            hits = c.search_similar("c", vecs[0], k=2)  # reads are served
            assert hits[0].record_id == 1
            with pytest.raises(VrodServerError, match="read-only replica"):
                c.insert("c", vecs[0], "nope")
            with pytest.raises(VrodServerError, match="read-only replica"):
                c.execute("DROP", arg="c")
            assert c.stats()["read_only"] is True
            assert "positions" in c.stats()["replication"]

            # Cutover: PROMOTE stops replication and enables writes.
            assert "promoted" in c._request(cmd="PROMOTE")
            rid = c.insert("c", vecs[0] * 0.1, "post-promote")
            assert rid > 0
            assert c.stats()["read_only"] is False
        assert not rep._thread.is_alive()
        # The old primary no longer feeds it: diverged by design.
        col.insert(vecs[1], "only-on-old-primary")
        import time as _t
        _t.sleep(0.25)  # would have replicated within one poll interval
        payloads = {replica_db.collection("c").get(i).payload
                    for i in (rid,)}
        assert payloads == {"post-promote"}
        assert not any(
            h.payload == "only-on-old-primary"
            for h in replica_db.collection("c").search_similar(vecs[1], k=5))
    finally:
        rserver.close()
        rep.stop()


def test_replica_apply_duplicate_and_order(tmp_db):
    """Collection-level contract: duplicate frames are skipped untouched;
    an out-of-order (regressing) frame raises."""
    col = tmp_db.create_collection("c", dim=DIM, segment_rows=64)
    rng = np.random.default_rng(0)
    vecs = rng.standard_normal((3, DIM)).astype(np.float32)
    col.bulk_insert(vecs, ["a", "b", "c"])
    tail = col.repl_tail(0)
    assert not tail["resync"] and len(tail["frames"]) == 1

    rep_col = tmp_db.create_collection("r", dim=DIM, segment_rows=64)
    lsn, frame = tail["frames"][0]
    assert rep_col.replica_apply(lsn, frame) is True
    assert rep_col.replica_apply(lsn, frame) is False  # duplicate: skipped
    assert rep_col.count == 3
    assert rep_col.repl_position() == lsn

    # A later frame with a gap is fine (primaries rewind failed ops).
    rid = col.insert(vecs[0] * 2, "d")
    t2 = col.repl_tail(lsn)
    (l2, f2), = t2["frames"]
    assert rep_col.replica_apply(l2 + 5, f2) is True  # gap tolerated
    # A frame at or below the position is duplicate delivery: skipped.
    assert rep_col.replica_apply(l2 + 3, f2) is False
    assert rep_col.get(rid).payload == "d"


def test_repl_tail_resync_signals(tmp_db):
    col = tmp_db.create_collection("c", dim=DIM, segment_rows=64)
    rng = np.random.default_rng(0)
    col.bulk_insert(rng.standard_normal((4, DIM)).astype(np.float32))
    col.snapshot()  # truncates: floor > 0
    col.insert(rng.standard_normal(DIM).astype(np.float32))
    head = col.repl_position()
    assert col.repl_tail(0)["resync"] is True          # behind the floor
    assert col.repl_tail(head + 1)["resync"] is True   # ahead of the head
    t = col.repl_tail(head - 1)
    assert t["resync"] is False and len(t["frames"]) == 1


def test_bootstrap_crash_leaves_no_staging(primary, tmp_path, monkeypatch):
    """A bootstrap killed mid-fetch leaves only a staging dir, which the
    next Database.load sweeps; the collection is absent, not half-made."""
    db, server = primary
    _fill(db)
    home = tmp_path / "rhome"
    rdb = Database.new(home, "rdb")
    rep = Replicator(rdb, server.address)

    def boom(name):
        # Simulate dying after staging was created but before adoption.
        import tempfile
        from vrod_tpu_torch.config import COLLECTIONS_DIR
        tempfile.mkdtemp(prefix=".repl_boot_",
                         dir=rdb.path / COLLECTIONS_DIR)
        raise RuntimeError("killed mid-bootstrap")

    monkeypatch.setattr(rep, "_bootstrap", boom)
    with pytest.raises(RuntimeError):
        rep._sync_once()
    rdb.close()

    rdb = Database.load(home / "rdb")
    try:
        assert rdb.list_collections() == []
        from vrod_tpu_torch.config import COLLECTIONS_DIR
        assert not list((rdb.path / COLLECTIONS_DIR).glob(".repl_boot_*"))
        # And a clean replicator run converges from scratch.
        with Replicator(rdb, server.address).start() as rep2:
            rep2.wait_caught_up()
            assert rdb.list_collections() == ["c"]
    finally:
        rdb.close()


def test_replicated_int8_and_filters(primary, replica_db):
    """Quantized collections replicate bit-exactly (stored-representation
    frames), and replica-side filtered search works."""
    db, server = primary
    col = db.create_collection("q", dim=DIM, dtype="int8", segment_rows=64)
    rng = np.random.default_rng(7)
    vecs = rng.standard_normal((16, DIM)).astype(np.float32)
    col.bulk_insert(vecs, [f"q{i}" for i in range(16)])
    col.snapshot()
    col.bulk_insert(vecs[:4] * 0.3, ["t0", "t1", "t2", "t3"])

    with Replicator(replica_db, server.address).start() as rep:
        rep.wait_caught_up()
        rcol = replica_db.collection("q")
        _assert_identical(col, rcol)
        ph = col.search_similar(vecs[0], k=4, exclude_ids=[1])
        rh = rcol.search_similar(vecs[0], k=4, exclude_ids=[1])
        assert [(h.record_id, round(h.score, 5)) for h in ph] == \
               [(h.record_id, round(h.score, 5)) for h in rh]


def test_replicated_int4_bit_exact(primary, replica_db):
    """Packed int4 collections replicate bit-exactly through BOTH ship
    paths (snapshot bootstrap carries packed stored-representation bytes;
    WAL tail re-quantizes from the f32 record on the replica) — search
    results and dequantized lookups agree across the pair."""
    db, server = primary
    col = db.create_collection("p4", dim=DIM, dtype="int4", segment_rows=64)
    rng = np.random.default_rng(11)
    vecs = rng.standard_normal((16, DIM)).astype(np.float32)
    col.bulk_insert(vecs, [f"q{i}" for i in range(16)])
    col.snapshot()  # bootstrap leg: packed bytes ship verbatim
    col.bulk_insert(vecs[:4] * 0.3, ["t0", "t1", "t2", "t3"])  # tail leg

    with Replicator(replica_db, server.address).start() as rep:
        rep.wait_caught_up()
        rcol = replica_db.collection("p4")
        assert rcol.config.dtype == "int4"
        np.testing.assert_array_equal(np.asarray(col.engine.x),
                                      np.asarray(rcol.engine.x))
        _assert_identical(col, rcol)
        ph = col.search_similar(vecs[0], k=4)
        rh = rcol.search_similar(vecs[0], k=4)
        assert [(h.record_id, h.score) for h in ph] == \
               [(h.record_id, h.score) for h in rh]


def test_cold_collection_tail_stays_cold(primary, replica_db):
    """An idle caught-up follower polling REPL.TAIL must not force the
    primary to device-restore cold collections (disk metadata answers)."""
    db, server = primary
    _fill(db, tail=0)  # snapshot only, no WAL tail
    with Replicator(replica_db, server.address).start() as rep:
        rep.wait_caught_up()
    # Evict: reload the primary DB object state by dropping the hot handle.
    # (Simpler: a fresh server on a freshly loaded DB.)
    db2 = None
    import vrod_tpu_torch.database as D
    home = db.path
    db.close()
    server.close()
    db2 = D.Database.load(home)
    try:
        with VrodServer(db2, f"unix:{home}/p2.sock").start() as s2:
            assert not db2.is_loaded("c")
            with Replicator(replica_db, s2.address,
                            poll_interval_s=0.05).start() as rep:
                rep.wait_caught_up()
                import time as _t
                _t.sleep(0.3)  # several idle polls
            assert not db2.is_loaded("c")  # caught-up polls stayed cold
    finally:
        db2.close()


def test_fetch_refreshes_hold_ttl(primary):
    """A slow bootstrap must not lose its snapshot pin mid-transfer: every
    successful REPL.FETCH pushes the idle deadline forward."""
    import time as _t
    db, server = primary
    _fill(db, tail=0)
    db.collection("c")  # ensure loaded
    with VrodClient(server.address) as c:
        snap = c._request(cmd="REPL.SNAPSHOT", collection="c")
        assert snap["token"]
        before = server._repl_holds[snap["token"]][3]
        _t.sleep(0.05)
        c._request(cmd="REPL.FETCH", token=snap["token"],
                   file=snap["files"][0][0], offset=0, size=16)
        after = server._repl_holds[snap["token"]][3]
        assert after > before
        c._request(cmd="REPL.RELEASE", token=snap["token"])
        assert snap["token"] not in server._repl_holds


def test_raw_wire_forms_match_base64(primary):
    """The raw continuation forms of REPL.FETCH / REPL.TAIL must carry
    byte-identical content to their base64-in-JSON forms (the raw path is
    a codec change only — ~23x faster ship, same bytes)."""
    import base64
    db, server = primary
    _fill(db)  # snapshot + WAL tail
    with VrodClient(server.address) as c:
        snap = c._request(cmd="REPL.SNAPSHOT", collection="c")
        fname, fsize, _crc = snap["files"][0]
        rb = c._request(cmd="REPL.FETCH", token=snap["token"], file=fname,
                        offset=0, size=fsize)
        rr = c._request(cmd="REPL.FETCH", token=snap["token"], file=fname,
                        offset=0, size=fsize, raw=True)
        assert rr["raw"] == base64.b64decode(rb["data"])
        assert rr["eof"] == rb["eof"]
        assert "data" not in rr and "raw_bytes" not in rr
        c._request(cmd="REPL.RELEASE", token=snap["token"])

        # Tail from the snapshot floor (after=0 is below it -> resync).
        floor = int(snap["floor"])
        tb = c._request(cmd="REPL.TAIL", collection="c", after=floor)
        tr = c._request(cmd="REPL.TAIL", collection="c", after=floor,
                        raw=True)
        assert not tb["resync"] and not tr["resync"]
        want = [(int(lsn), base64.b64decode(b64))
                for lsn, b64 in tb["frames"]]
        assert Replicator._decode_frames(tr) == want
        assert tr["position"] == tb["position"]
        assert tr["frames_n"] == len(want) > 0


def test_decode_frames_rejects_torn_raw():
    from vrod_tpu_torch.replication import ReplicationError
    import struct
    good = struct.pack("<QI", 7, 3) + b"abc"
    assert Replicator._decode_frames({"raw": good, "frames_n": 1}) \
        == [(7, b"abc")]
    with pytest.raises(ReplicationError, match="header"):
        Replicator._decode_frames({"raw": good[:8]})
    with pytest.raises(ReplicationError, match="payload"):
        Replicator._decode_frames({"raw": good[:-1]})
    with pytest.raises(ReplicationError, match="announced"):
        Replicator._decode_frames({"raw": good, "frames_n": 2})


def test_replication_against_pre_raw_primary(primary, replica_db,
                                             monkeypatch):
    """A primary that predates the raw extension ignores the flag and
    answers in base64 — the replicator must converge identically through
    the fallback branch."""
    from vrod_tpu_torch.server import VrodServer as VS
    db, server = primary
    col, _ = _fill(db)
    orig = VS.handle_request

    def strip_raw(self, req):
        req.pop("raw", None)
        return orig(self, req)

    monkeypatch.setattr(VS, "handle_request", strip_raw)
    with Replicator(replica_db, server.address).start() as rep:
        rep.wait_caught_up()
        _assert_identical(col, replica_db.collection("c"))


REPL_CHILD = """
import os, sys, time
os.environ["VROD_PLATFORM"] = "cpu"
from vrod_tpu_torch.database import Database
from vrod_tpu_torch.replication import Replicator

home, addr = sys.argv[1], sys.argv[2]
db = Database.new(home, "rdb")
rep = Replicator(db, addr, poll_interval_s=0.02).start()
print("READY", flush=True)
while True:
    time.sleep(0.03)
    pos = 0
    if "c" in db.list_collections():
        try:
            pos = db.collection("c").repl_position()
        except Exception:
            pass
    print(f"POS {pos}", flush=True)
"""


def test_sigkill_replica_mid_tail(primary, tmp_path):
    """SIGKILL the whole replica process while it is applying the primary's
    stream: the replica's own WAL-first discipline means a reload yields a
    clean LSN-prefix of the primary (contiguous ids, matching payloads),
    and a fresh replicator converges it without a re-bootstrap."""
    import os
    import subprocess
    import sys
    import threading
    import time

    db, server = primary
    col = db.create_collection("c", dim=DIM, segment_rows=64)
    rng = np.random.default_rng(0)

    stop = threading.Event()

    def feed():
        i = 0
        while not stop.is_set() and i < 4000:
            col.insert(rng.standard_normal(DIM).astype(np.float32), f"m{i}")
            i += 1

    feeder = threading.Thread(target=feed)
    feeder.start()

    script = tmp_path / "repl_child.py"
    script.write_text(REPL_CHILD)
    env = dict(os.environ)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    addr = server.address
    proc = subprocess.Popen(
        [sys.executable, str(script), str(tmp_path / "rhome"), addr],
        stdout=subprocess.PIPE, text=True, env=env)
    try:
        deadline = time.time() + 120
        pos = 0
        while time.time() < deadline:
            line = proc.stdout.readline()
            if line.startswith("POS"):
                pos = int(line.split()[1])
                if pos >= 50:  # mid-stream: the feeder is still going
                    break
        proc.kill()  # SIGKILL: a real crash, no unwind
    finally:
        proc.wait()
        stop.set()
        feeder.join()
    assert pos >= 50

    rdb = Database.load(tmp_path / "rhome" / "rdb")
    try:
        rcol = rdb.collection("c")
        m = rcol.count
        assert m >= 1  # it was mid-stream; SOME durable prefix exists
        # Insert-only stream => the applied prefix is exactly ids 1..M,
        # each bit-identical to the primary's record.
        r_ids = np.sort(rcol.alloc.ids_of(
            rcol.alloc.live_slots().astype(np.uint64)))
        np.testing.assert_array_equal(
            r_ids, np.arange(1, m + 1, dtype=np.uint64))
        for rid in (1, m // 2 or 1, m):
            p, r = col.get(rid), rcol.get(rid)
            np.testing.assert_array_equal(p.vector, r.vector)
            assert p.payload == r.payload
        # A fresh replicator resumes from the durable position (no
        # bootstrap) and converges to the primary.
        boots_before = metrics.counters.snapshot().get("repl.bootstraps", 0)
        with Replicator(rdb, addr).start() as rep:
            rep.wait_caught_up(timeout=120)
            _assert_identical(col, rcol)
        assert metrics.counters.snapshot().get(
            "repl.bootstraps", 0) == boots_before
    finally:
        rdb.close()


def test_replication_with_auth_token(tmp_db, tmp_path, replica_db):
    """A token-protected primary feeds an authenticated replicator; an
    unauthenticated one gets a clean error, not silent stalling."""
    with VrodServer(tmp_db, f"unix:{tmp_path}/auth_p.sock",
                    auth_token="repl-secret").start() as server:
        _fill(tmp_db, tail=0)
        with Replicator(replica_db, server.address,
                        auth_token="repl-secret").start() as rep:
            rep.wait_caught_up()
            assert replica_db.collection("c").count == 24
        bad = Replicator(replica_db, server.address, poll_interval_s=0.05)
        bad.start()
        try:
            import time as _t
            _t.sleep(0.5)
            assert "Authentication" in (bad.status()["last_error"] or "")
        finally:
            bad.stop()


def test_read_your_writes_min_position(primary, replica_db, tmp_path):
    """Mutation responses carry the durable position; a replica search
    with min_position blocks until replication reaches it — so a client
    can write to the primary and immediately read its write on a replica,
    even with a slow poll interval."""
    db, server = primary
    _fill(db, tail=0)
    # Slow poll: without the position gate, an immediate replica read
    # would reliably miss the write.
    rep = Replicator(replica_db, server.address,
                     poll_interval_s=0.8).start()
    rserver = VrodServer(replica_db, f"unix:{tmp_path}/ryw.sock",
                         read_only=True).start()
    rserver.attach_replicator(rep)
    try:
        rep.wait_caught_up()
        with VrodClient(server.address) as w, \
                VrodClient(rserver.address) as r:
            vec = np.full(DIM, 0.25, np.float32)
            rid = w.insert("c", vec, "fresh-write")
            pos = w.position("c")
            assert pos > 0
            # Immediately read on the replica, demanding the position.
            vec2, payload = r.get("c", rid, min_position=pos)
            assert payload == "fresh-write"
            hits = r.search_similar("c", vec, k=1, min_position=pos)
            assert hits[0].record_id == rid
            # An unreachable position fails fast with a clear error.
            with pytest.raises(VrodServerError, match="Replica is behind"):
                r._request(cmd="SEARCH", collection="c", record_id=rid,
                           min_position=pos + 10**6,
                           position_timeout_s=0.2)
    finally:
        rserver.close()
        rep.stop()


def test_randomized_convergence(primary, tmp_path):
    """Model test: a random interleaving of primary mutations, primary
    snapshots (WAL truncation), replica downtime (restarts), and sync
    passes must always converge the replica to the primary, bit-exactly —
    whether via tailing or forced resyncs."""
    import time as _t

    db, server = primary
    # auto_snapshot in the mix: snapshot-of-empty-WAL scenarios (REINDEX
    # right after a snapshot) must keep the LSN high-water (the infinite-
    # resync regression the 20-seed fuzz caught).
    col = db.create_collection("c", dim=DIM, segment_rows=64,
                               auto_snapshot_wal_bytes=6000)
    rng = np.random.default_rng(42)
    home = tmp_path / "rhome"
    rdb = Database.new(home, "rdb")
    rep = Replicator(rdb, server.address, poll_interval_s=0.05).start()
    live = []

    try:
        for step in range(60):
            roll = rng.random()
            if roll < 0.45 or not live:
                n = int(rng.integers(1, 6))
                vecs = rng.standard_normal((n, DIM)).astype(np.float32)
                ids = col.bulk_insert(vecs, [f"s{step}-{i}"
                                             for i in range(n)])
                live.extend(int(i) for i in ids)
            elif roll < 0.65:
                victim = live.pop(int(rng.integers(0, len(live))))
                col.delete(victim)
            elif roll < 0.80:
                target = live[int(rng.integers(0, len(live)))]
                col.update(target, rng.standard_normal(DIM).astype(
                    np.float32), f"u{step}")
            elif roll < 0.85:
                col.snapshot()  # truncates the primary WAL
            elif roll < 0.90:
                col.reindex()  # compaction + snapshot (may cut an empty WAL)
            else:
                # Replica downtime across whatever happens next.
                rep.stop()
                rdb.close()
                rdb = Database.load(home / "rdb")
                rep = Replicator(rdb, server.address,
                                 poll_interval_s=0.05).start()
            if step % 15 == 14:
                rep.wait_caught_up(timeout=60)
                _assert_identical(col, rdb.collection("c"))
        rep.wait_caught_up(timeout=60)
        _assert_identical(col, rdb.collection("c"))
    finally:
        rep.stop()
        rdb.close()


def test_zero_loss_cutover_runbook(primary, replica_db, tmp_path):
    """FENCE old primary -> wait caught up -> PROMOTE replica: every write
    acked before the fence is on the new primary; writes during the fence
    are rejected, so nothing can be silently stranded."""
    db, server = primary
    col, vecs = _fill(db)
    rep = Replicator(replica_db, server.address).start()
    rserver = VrodServer(replica_db, f"unix:{tmp_path}/cutover.sock",
                         read_only=True).start()
    rserver.attach_replicator(rep)
    try:
        with VrodClient(server.address) as pc, \
                VrodClient(rserver.address) as rc:
            rng = np.random.default_rng(99)
            fresh = rng.standard_normal(DIM).astype(np.float32)
            last = pc.insert("c", fresh, "final-acked-write")
            # (1) fence the old primary
            assert "fenced" in pc._request(cmd="FENCE")
            with pytest.raises(VrodServerError, match="read-only"):
                pc.insert("c", vecs[0], "after-fence")
            # (2) wait until the replica has everything
            rep.wait_caught_up()
            # (3) promote the replica
            assert "promoted" in rc._request(cmd="PROMOTE")
            # (4) the new primary has the final acked write and is writable
            _assert_identical(col, replica_db.collection("c"))
            assert rc.get("c", last)[1] == "final-acked-write"
            rc.insert("c", vecs[1], "new-era")
            # PROMOTE also lifts a fence on the old primary if re-used.
            assert "promoted" in pc._request(cmd="PROMOTE")
            pc.insert("c", vecs[2], "unfenced")
            assert last > 0
    finally:
        rserver.close()
        rep.stop()


def test_fence_persists_across_restart(tmp_path):
    """A supervisor-restarted fenced primary must come back fenced (the
    vr_fence marker), or the cutover's divergence guarantee breaks."""
    db = Database.new(tmp_path, "fdb")
    db.create_collection("c", dim=DIM, segment_rows=64)
    with VrodServer(db, f"unix:{tmp_path}/f.sock").start() as s:
        with VrodClient(s.address) as c:
            assert "fenced" in c._request(cmd="FENCE")
    db.close()

    db = Database.load(tmp_path / "fdb")
    try:
        with VrodServer(db, f"unix:{tmp_path}/f2.sock").start() as s:
            assert s.read_only  # restarted fenced
            with VrodClient(s.address) as c:
                with pytest.raises(VrodServerError, match="read-only"):
                    c.insert("c", np.ones(DIM, np.float32), "x")
                assert "promoted" in c._request(cmd="PROMOTE")
                c.insert("c", np.ones(DIM, np.float32), "ok")
        assert not (tmp_path / "fdb" / "vr_fence").exists()
    finally:
        db.close()


def test_min_position_on_missing_collection_fails_fast(primary):
    """On a server with no replicator, min_position + a wrong collection
    name must raise the real not-found error immediately, not stall the
    position timeout and blame replication lag."""
    import time as _t
    db, server = primary
    _fill(db, tail=0)
    with VrodClient(server.address) as c:
        t0 = _t.monotonic()
        with pytest.raises(VrodServerError, match="No collection"):
            c.get("no_such", 1, min_position=5)
        assert _t.monotonic() - t0 < 5.0


def test_chained_replication(primary, tmp_path):
    """Cascading topology A -> B -> C: every server speaks REPL.*, and a
    replica's WAL is a byte-identical suffix of its primary's, so a
    replica can feed further replicas (fan-out without loading A)."""
    db, aserver = primary
    col, vecs = _fill(db)

    bdb = Database.new(tmp_path / "b", "rdb")
    brep = Replicator(bdb, aserver.address, poll_interval_s=0.05).start()
    bserver = VrodServer(bdb, f"unix:{tmp_path}/b.sock",
                         read_only=True).start()
    bserver.attach_replicator(brep)

    cdb = Database.new(tmp_path / "c", "rdb")
    crep = Replicator(cdb, bserver.address, poll_interval_s=0.05).start()
    try:
        brep.wait_caught_up()
        crep.wait_caught_up()
        _assert_identical(col, cdb.collection("c"))

        # Mutations flow down the whole chain.
        rid = col.insert(vecs[0] * 0.3, "chained")
        col.delete(3)
        brep.wait_caught_up()
        crep.wait_caught_up()
        _assert_identical(col, cdb.collection("c"))
        assert cdb.collection("c").get(rid).payload == "chained"
    finally:
        crep.stop()
        cdb.close()
        bserver.close()
        brep.stop()
        bdb.close()


def test_crashed_hold_is_swept_on_reload(tmp_path):
    """A server that dies holding a replication snapshot pin leaves a
    .snap_hold_ dir; the next load sweeps it (disk space is reclaimed)."""
    db = Database.new(tmp_path, "hdb")
    col = db.create_collection("c", dim=DIM, segment_rows=64)
    col.bulk_insert(np.eye(DIM, dtype=np.float32))
    col.snapshot()
    # Take the pin a bootstrapping follower would hold, then "crash":
    # never __exit__ it (a graceful server close WOULD release it — that
    # path is covered by VrodServer.close; this is the SIGKILL shape).
    cm = col.hold_snapshot()  # keep referenced: GC would run the finally
    assert cm.__enter__() is not None
    db.close()
    assert list((tmp_path / "hdb" / "collections" / "c").glob(
        ".snap_hold_*"))  # still there: nothing cleaned it up

    db = Database.load(tmp_path / "hdb")
    try:
        db.collection("c")  # load sweeps stale pins
        assert not list((tmp_path / "hdb" / "collections" / "c").glob(
            ".snap_hold_*"))
    finally:
        db.close()


def test_cli_two_process_replication_topology(tmp_path):
    """The full production shape as REAL OS processes: `vrod --serve`
    primary and `vrod --serve --replica-of` replica launched through the
    CLI, driven over sockets — bootstrap, live tail, read-only
    enforcement, PROMOTE — then the replica process is SIGKILLed and its
    database must reload to a clean prefix."""
    import os
    import signal
    import subprocess
    import sys
    import time

    env = dict(os.environ)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env.update({"PYTHONPATH": repo, "VROD_PLATFORM": "cpu"})

    def cli(*args, **kw):
        return subprocess.run([sys.executable, "-m", "vrod_tpu_torch.cli", *args],
                              env=env, capture_output=True, text=True, **kw)

    assert cli("--init-database", str(tmp_path), "-n", "pdb").returncode == 0
    assert cli("-d", str(tmp_path / "pdb"), "-e", "create",
               "-a", f"c;dim={DIM};segment_rows=64").returncode == 0
    assert cli("--init-database", str(tmp_path), "-n", "rdb").returncode == 0

    p_sock, r_sock = tmp_path / "p.sock", tmp_path / "r.sock"
    primary = subprocess.Popen(
        [sys.executable, "-m", "vrod_tpu_torch.cli", "-d", str(tmp_path / "pdb"),
         "--serve", f"unix:{p_sock}"], env=env,
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    replica = None
    try:
        deadline = time.time() + 120
        while not p_sock.is_socket() and time.time() < deadline:
            time.sleep(0.2)
        assert p_sock.is_socket()
        replica = subprocess.Popen(
            [sys.executable, "-m", "vrod_tpu_torch.cli", "-d", str(tmp_path / "rdb"),
             "--serve", f"unix:{r_sock}", "--replica-of", f"unix:{p_sock}"],
            env=env, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        while not r_sock.is_socket() and time.time() < deadline:
            time.sleep(0.2)
        assert r_sock.is_socket()

        with VrodClient(f"unix:{p_sock}") as pc, \
                VrodClient(f"unix:{r_sock}") as rc:
            rng = np.random.default_rng(3)
            vec = rng.standard_normal(DIM).astype(np.float32)
            rid = pc.insert("c", vec, "live")
            pos = pc.position("c")
            # Read-your-writes across the two processes.
            assert rc.get("c", rid, min_position=pos)[1] == "live"
            with pytest.raises(VrodServerError, match="read-only"):
                rc.insert("c", vec, "nope")
            assert rc.stats()["replication"]["running"] is True

        # SIGKILL the whole replica process mid-life; its DB reloads clean.
        replica.kill()
        replica.wait(timeout=30)
        replica = None
        rdb = Database.load(tmp_path / "rdb")
        try:
            assert rdb.collection("c").get(rid).payload == "live"
        finally:
            rdb.close()
    finally:
        if replica is not None:
            replica.kill()
            replica.wait(timeout=30)
        primary.send_signal(signal.SIGINT)
        try:
            primary.wait(timeout=30)
        except subprocess.TimeoutExpired:
            primary.kill()
            primary.wait(timeout=30)


def test_status_reports_per_collection_lag(primary, replica_db, tmp_path):
    """STATS observability: lag = primary position - applied position per
    collection; 0 when caught up, the full primary position before the
    first tail, and surfaced through a replica server's STATS verb."""
    db, server = primary
    col, vecs = _fill(db)

    # Before any sync pass, status is empty but well-formed.
    rep = Replicator(replica_db, server.address)
    st = rep.status()
    assert st["lag"] == {} and st["max_lag"] == 0

    with rep.start():
        rep.wait_caught_up()
        st = rep.status()
        assert st["lag"] == {"c": 0}
        assert st["max_lag"] == 0
        assert st["positions"]["c"] == st["primary_positions"]["c"] > 0

        # A replica server exposes the same through STATS.
        rserver = VrodServer(replica_db, f"unix:{tmp_path}/replica.sock",
                             read_only=True)
        rserver.attach_replicator(rep)
        with rserver.start():
            with VrodClient(rserver.address) as cli:
                stats = cli.stats()
            repl = stats["replication"]
            assert repl["lag"]["c"] == 0
            assert repl["max_lag"] == 0
            rserver._replicator = None  # fixture owns the replicator's stop

    # Lag mechanics (pure computation): behind by 3 frames and a
    # not-yet-bootstrapped collection both surface.
    rep2 = Replicator(replica_db, server.address)
    with rep2._lock:
        rep2._primary_pos = {"c": 10, "new": 4}
        rep2._positions = {"c": 7}
    st = rep2.status()
    assert st["lag"] == {"c": 3, "new": 4}
    assert st["max_lag"] == 4
