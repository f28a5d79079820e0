"""The port's network serving layer (``vrod_tpu_torch.server``): the cases
of ``tests/test_server.py`` run over the port's Database, server, client and
CLI (``python -m vrod_tpu_torch.cli --serve``) on the CPU
(``VROD_PLATFORM=cpu``, set by conftest for these processes and their
children). Protocol, correctness, cross-client batching, durability.
"""

import json
import socket
import threading
from pathlib import Path

import numpy as np
import pytest

from vrod_tpu_torch import metrics
from vrod_tpu_torch.client import VrodClient, VrodServerError
from vrod_tpu_torch.database import Database
from vrod_tpu_torch.server import VrodServer, parse_addr

DIM = 16


@pytest.fixture
def tmp_db(tmp_path):
    """The port's Database (conftest's ``tmp_db`` is the JAX package's)."""
    db = Database.new(tmp_path, "testdb")
    yield db
    db.close()


@pytest.fixture
def server(tmp_db, tmp_path):
    with VrodServer(tmp_db, f"unix:{tmp_path}/vrod.sock",
                    max_wait_ms=5.0).start() as s:
        yield s


@pytest.fixture
def client(server):
    with VrodClient(server.address) as c:
        yield c


def _fill(client, name="c", n=32, seed=0):
    client.execute("CREATE", arg=f"{name};dim={DIM};metric=cosine;"
                                 f"segment_rows=64")
    rng = np.random.default_rng(seed)
    vecs = rng.standard_normal((n, DIM)).astype(np.float32)
    rids = client.bulk_insert(name, vecs, [f"p{i}" for i in range(n)])
    return vecs, rids


def test_parse_addr():
    assert parse_addr("unix:/tmp/x.sock") == ("unix", "/tmp/x.sock")
    assert parse_addr("127.0.0.1:7045") == ("tcp", "127.0.0.1", 7045)
    assert parse_addr(("localhost", 0)) == ("tcp", "localhost", 0)
    for bad in ("unix:", "nohost", "h:notaport"):
        with pytest.raises(ValueError):
            parse_addr(bad)


def test_ping_stats_roundtrip(client):
    assert client.ping() == "pong"
    st = client.stats()
    assert st["uptime_s"] >= 0 and "counters" in st
    # Capability discovery: any-language clients check features ONCE
    # instead of trial-and-fallback per call.
    from vrod_tpu_torch import VROD_VERSION
    assert st["version"] == VROD_VERSION
    assert "raw_continuations" in st["features"]
    assert "binary_vectors" in st["features"]


def test_insert_search_get_update_delete(client):
    vecs, rids = _fill(client)
    # top-1 of a stored vector is itself at cosine 1.0
    hits = client.search_similar("c", vecs[3], k=2)
    assert hits[0].record_id == rids[3]
    assert hits[0].score == pytest.approx(1.0, abs=1e-5)
    assert hits[0].payload == "p3"
    # exact lookup round-trips the vector
    v, payload = client.get("c", rids[3])
    np.testing.assert_allclose(v, vecs[3], rtol=1e-6)
    assert payload == "p3"
    # single insert
    rid = client.insert("c", vecs[0] * 0.5, "copy")
    assert client.search_similar("c", vecs[0], k=2)[1].record_id == rid
    # update moves the record
    client.update("c", rid, -vecs[0], "flipped")
    hits = client.search_similar("c", -vecs[0], k=1)
    assert (hits[0].record_id, hits[0].payload) == (rid, "flipped")
    # delete removes it from results
    assert client.delete("c", rid) == 1
    assert all(h.record_id != rid
               for h in client.search_similar("c", -vecs[0], k=8))


def test_filters_and_batch_search(client):
    vecs, rids = _fill(client)
    only = rids[:4]
    hits = client.search_similar("c", vecs[10], k=4, within_ids=only)
    assert {h.record_id for h in hits} <= set(only)
    hits = client.search_similar("c", vecs[10], k=4,
                                 exclude_ids=[rids[10]])
    assert all(h.record_id != rids[10] for h in hits)
    # client-side batch: one request, one engine call, exact per-row results
    batches = client.search_similar_batch("c", vecs[:6], k=1)
    assert [b[0].record_id for b in batches] == list(rids[:6])


def test_execute_parity_path(client, tmp_path):
    """Any reference verb works over the wire with the CLI -a contract."""
    client.execute("CREATE", arg=f"p;dim={DIM};metric=dot")
    out = client.execute("INSERT", collection="p",
                         arg=",".join(["1.0"] * DIM) + ";hello")
    assert out == "Inserted record 1"
    out = client.execute("SEARCHSIMILAR", collection="p",
                         arg=",".join(["1.0"] * DIM) + ";k=1")
    assert "hello" in out
    assert "p" in client.execute("LISTCOLLECTIONS")
    assert client.execute("REINDEX", collection="p").startswith("Reindexed")
    client.execute("DROP", arg="p")
    assert "p " not in client.execute("LISTCOLLECTIONS")


def test_concurrent_clients_batch_into_tiles(tmp_db, tmp_path):
    """N clients hammer single-query searches; every result is exact and
    the frontend packed them into fewer engine batches than queries. A
    barrier start + a wide batch window (100 ms x 8 rounds vs 48 queries)
    makes full serialization — the only false-failure mode — implausible
    even on a loaded single-core CI box."""
    with VrodServer(tmp_db, f"unix:{tmp_path}/b.sock",
                    max_wait_ms=100.0).start() as server:
        with VrodClient(server.address) as c0:
            vecs, rids = _fill(c0, n=48)
        before = metrics.counters.snapshot()
        errors, lock = [], threading.Lock()
        start = threading.Barrier(6)

        def worker(tid):
            try:
                with VrodClient(server.address) as c:
                    start.wait(timeout=30)
                    for i in range(tid, 48, 6):
                        hits = c.search_similar("c", vecs[i], k=1)
                        if hits[0].record_id != rids[i]:
                            raise AssertionError(
                                f"query {i}: got {hits[0].record_id}")
            except Exception as e:
                with lock:
                    errors.append(e)

        threads = [threading.Thread(target=worker, args=(t,))
                   for t in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    assert not errors
    after = metrics.counters.snapshot()
    queries = 48
    batches = after.get("frontend.batch", 0) - before.get("frontend.batch", 0)
    assert 0 < batches < queries, (
        f"expected cross-client micro-batching: {batches} batches "
        f"for {queries} queries")


def test_error_responses_keep_connection(client):
    with pytest.raises(VrodServerError, match="Unrecognized"):
        client.execute("FROBNICATE")
    with pytest.raises(VrodServerError, match="No collection named"):
        client.search_similar("ghost", np.zeros(DIM), k=1)
    _fill(client, n=4)
    with pytest.raises(VrodServerError):
        client.search_similar("c", np.zeros(DIM - 1), k=1)  # bad dim
    # connection still serves after errors
    assert client.ping() == "pong"


def test_bad_json_closes_connection(server):
    spec = parse_addr(server.address)
    s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    s.settimeout(10)
    s.connect(spec[1])
    s.sendall(b"this is not json\n")
    f = s.makefile("rb")
    resp = json.loads(f.readline())
    assert resp["ok"] is False and "JSON" in resp["error"]
    assert f.readline() == b""  # server closed the framing-broken conn
    s.close()


def test_client_caps_hostile_raw_frames(tmp_path):
    """A hostile/broken server announcing an absurd raw_bytes must fail
    the request (connection marked broken) instead of allocating it."""
    import socketserver
    import threading
    from vrod_tpu_torch.client import VrodConnectionError

    class Evil(socketserver.StreamRequestHandler):
        def handle(self):
            req = json.loads(self.rfile.readline())
            resp = {"ok": True, "id": req["id"],
                    "result": {"raw_bytes": 1 << 40}}
            self.wfile.write(json.dumps(resp).encode() + b"\n")
            self.wfile.flush()

    srv = socketserver.ThreadingUnixStreamServer(
        str(tmp_path / "evil.sock"), Evil)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        c = VrodClient(f"unix:{tmp_path}/evil.sock")
        with pytest.raises(VrodConnectionError, match="unreasonable"):
            c._request(cmd="PING")
        with pytest.raises(VrodConnectionError, match="broken"):
            c._request(cmd="PING")  # framing is unrecoverable
        c.close()
    finally:
        srv.shutdown()
        srv.server_close()


def test_correlation_id_echo(server):
    spec = parse_addr(server.address)
    s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    s.settimeout(10)
    s.connect(spec[1])
    s.sendall(json.dumps({"cmd": "PING", "id": "xyz"}).encode() + b"\n")
    resp = json.loads(s.makefile("rb").readline())
    assert resp == {"ok": True, "result": "pong", "id": "xyz"}
    s.close()


def test_drop_then_recreate_rebinds_batcher(client):
    vecs, rids = _fill(client, n=8, seed=1)
    assert client.search_similar("c", vecs[0], k=1)[0].record_id == rids[0]
    client.execute("DROP", arg="c")
    vecs2, rids2 = _fill(client, n=8, seed=2)
    hits = client.search_similar("c", vecs2[5], k=1)
    assert hits[0].record_id == rids2[5]


def test_tcp_transport(tmp_db):
    with VrodServer(tmp_db, ("127.0.0.1", 0)).start() as s:
        with VrodClient(s.address) as c:
            assert c.ping() == "pong"


def test_shutdown_verb(tmp_db, tmp_path):
    s = VrodServer(tmp_db, f"unix:{tmp_path}/sd.sock").start()
    with VrodClient(s.address) as c:
        assert c.shutdown_server() == "shutting down"
    # close() runs on a helper thread: wait until it unlinks the socket
    # (its last act) so the connect below cannot race the listen backlog.
    import time
    sock_path = s.address[len("unix:"):]
    for _ in range(100):
        if not Path(sock_path).exists():
            break
        time.sleep(0.1)
    assert s._closing.is_set()
    assert not Path(sock_path).exists()
    with pytest.raises((ConnectionRefusedError, FileNotFoundError, OSError)):
        VrodClient(s.address)


def test_cli_serve_flag(tmp_path):
    """--serve end-to-end: subprocess CLI server, client over unix socket."""
    import subprocess
    import sys
    import time

    from vrod_tpu_torch.database import Database

    db = Database.new(tmp_path, "sdb")
    db.close()
    sock = tmp_path / "cli.sock"
    # stderr to a FILE: an undrained pipe could block a chatty child
    # before it binds the socket (same rationale as the SIGKILL test).
    errlog = open(tmp_path / "server.err", "w+b")
    proc = subprocess.Popen(
        [sys.executable, "-m", "vrod_tpu_torch.cli", "-d", str(tmp_path / "sdb"),
         "--serve", f"unix:{sock}"],
        stdout=subprocess.DEVNULL, stderr=errlog)
    try:
        for _ in range(300):
            if sock.exists():
                break
            if proc.poll() is not None:
                errlog.seek(0)
                raise AssertionError(f"server died: {errlog.read().decode()}")
            time.sleep(0.1)
        else:
            raise AssertionError("server socket never appeared")
        with VrodClient(f"unix:{sock}") as c:
            assert c.ping() == "pong"
            c.execute("CREATE", arg=f"k;dim={DIM}")
            rid = c.insert("k", np.ones(DIM, np.float32), "via-cli-server")
            hits = c.search_similar("k", np.ones(DIM, np.float32), k=1)
            assert hits[0].record_id == rid
            c.shutdown_server()
        proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        errlog.close()


def test_cli_serve_sigterm_graceful(tmp_path):
    """SIGTERM (the supervisor stop signal) drains and exits 0 with the
    socket unlinked — routed through the same path as Ctrl-C. Durable
    state survives: a mutation acked before the signal is present on
    reload."""
    import signal
    import subprocess
    import sys
    import time

    from vrod_tpu_torch.database import Database

    db = Database.new(tmp_path, "tdb")
    db.close()
    sock = tmp_path / "term.sock"
    errlog = open(tmp_path / "term.err", "w+b")
    proc = subprocess.Popen(
        [sys.executable, "-m", "vrod_tpu_torch.cli", "-d", str(tmp_path / "tdb"),
         "--serve", f"unix:{sock}"],
        stdout=subprocess.DEVNULL, stderr=errlog)
    try:
        for _ in range(300):
            if sock.exists():
                break
            if proc.poll() is not None:
                errlog.seek(0)
                raise AssertionError(f"server died: {errlog.read().decode()}")
            time.sleep(0.1)
        else:
            raise AssertionError("server socket never appeared")
        with VrodClient(f"unix:{sock}") as c:
            c.execute("CREATE", arg=f"t;dim={DIM}")
            rid = c.insert("t", np.ones(DIM, np.float32), "pre-term")
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0, "SIGTERM exit must be clean"
        assert not sock.exists(), "socket not unlinked on graceful stop"
        db = Database.load(tmp_path / "tdb")
        try:
            assert db.collection("t").get(rid).payload == "pre-term"
        finally:
            db.close()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        errlog.close()


def test_unix_socket_not_stolen_from_live_server(tmp_db, tmp_path):
    """Binding a path a LIVE server answers on must fail, not silently
    steal it; a stale path (dead owner) must be reclaimed."""
    import vrod_tpu_torch.database as vdb

    sock = tmp_path / "owned.sock"
    with VrodServer(tmp_db, f"unix:{sock}").start():
        db2 = vdb.Database.new(tmp_path / "d2", "db2")
        try:
            with pytest.raises(OSError, match="already in use"):
                VrodServer(db2, f"unix:{sock}")
        finally:
            db2.close()
    # After close the path is gone; simulate a crash leaving a stale file:
    s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    s.bind(str(sock))
    s.close()  # closed without unlink -> stale, nobody answers
    db3 = vdb.Database.new(tmp_path / "d3", "db3")
    try:
        with VrodServer(db3, f"unix:{sock}").start() as srv:
            with VrodClient(srv.address) as c:
                assert c.ping() == "pong"
    finally:
        db3.close()


def test_client_hard_fails_after_timeout(server):
    """A read timeout desyncs request/response pairing: the client must
    refuse further use (blind retries could re-execute mutations)."""
    from vrod_tpu_torch.client import VrodConnectionError

    with VrodClient(server.address) as c:
        # CREATE does real filesystem + engine work (milliseconds), so a
        # 100 us read window always expires before the response lands.
        c._sock.settimeout(0.0001)
        with pytest.raises(VrodConnectionError):
            c.execute("CREATE", arg=f"slow;dim={DIM}")
        # ... and every subsequent call fails fast, without transmitting.
        with pytest.raises(VrodConnectionError, match="broken"):
            c.insert("slow", np.zeros(DIM), "never-sent")


def test_unix_socket_permissions(server):
    import os
    import stat

    path = server.address[len("unix:"):]
    mode = stat.S_IMODE(os.stat(path).st_mode)
    assert mode == 0o700, oct(mode)


def test_client_import_is_engine_free():
    """vrod_tpu_torch.client must import without torch/engine modules:
    client-only processes need sockets+json, not a CUDA runtime."""
    import subprocess
    import sys

    code = (
        "import sys\n"
        "from vrod_tpu_torch.client import VrodClient\n"
        "from vrod_tpu_torch import VrodServerError\n"
        "heavy = [m for m in ('torch', 'jax', 'jaxlib', 'vrod_tpu', "
        "'vrod_tpu_torch.engine', 'vrod_tpu_torch.database', "
        "'vrod_tpu_torch.collection') if m in sys.modules]\n"
        "assert not heavy, f'client import pulled {heavy}'\n"
        "print('LIGHT')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "LIGHT" in out.stdout


def test_server_sigkill_acked_inserts_survive(tmp_path):
    """Durability THROUGH the network layer: SIGKILL the serving process
    mid-insert-stream; every insert the client saw acked must be present
    after WAL replay in a fresh process (ack ⊃ fsync — the server answers
    only after the collection's WAL append+fsync)."""
    import os
    import signal
    import subprocess
    import sys
    import time

    from vrod_tpu_torch.database import Database

    db = Database.new(tmp_path, "kdb")
    db.create_collection("c", dim=DIM, metric="cosine", segment_rows=64)
    db.close()
    sock = tmp_path / "k.sock"
    # stderr to a FILE, not a pipe: an undrained pipe buffer (~64 KiB)
    # could block a chatty child before it ever binds the socket.
    errlog = open(tmp_path / "server.err", "w+b")
    proc = subprocess.Popen(
        [sys.executable, "-m", "vrod_tpu_torch.cli", "-d", str(tmp_path / "kdb"),
         "--serve", f"unix:{sock}"],
        stdout=subprocess.DEVNULL, stderr=errlog)
    try:
        for _ in range(300):
            if sock.exists():
                break
            if proc.poll() is not None:
                errlog.seek(0)
                raise AssertionError(errlog.read().decode())
            time.sleep(0.1)
        else:
            raise AssertionError("server socket never appeared")
        rng = np.random.default_rng(9)
        acked = {}
        with VrodClient(f"unix:{sock}") as c:
            for i in range(40):
                v = rng.standard_normal(DIM).astype(np.float32)
                rid = c.insert("c", v, f"ack{i}")
                acked[rid] = f"ack{i}"
        # kill mid-lifecycle: more un-acked work may be in flight from the
        # server's own maintenance; only ACKED records carry the guarantee.
        os.kill(proc.pid, signal.SIGKILL)
        proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        errlog.close()
    db2 = Database.load(tmp_path / "kdb")
    try:
        col = db2.collection("c")
        assert col.count >= len(acked)
        for rid, payload in acked.items():
            rec = col.get(rid)
            assert rec.payload == payload
    finally:
        db2.close()


def test_auth_token(tmp_db, tmp_path):
    """With auth_token set, every verb except PING needs the shared secret;
    failures are clean errors on a live connection, not disconnects."""
    with VrodServer(tmp_db, f"unix:{tmp_path}/auth.sock",
                    auth_token="s3cret").start() as s:
        with VrodClient(s.address) as anon:
            assert anon.ping() == "pong"  # health check stays open
            with pytest.raises(VrodServerError, match="Authentication"):
                anon.stats()
            with pytest.raises(VrodServerError, match="Authentication"):
                anon.execute("CREATE", arg="c;dim=8;segment_rows=64")
            assert anon.ping() == "pong"  # connection survived the denial
        with VrodClient(s.address, auth_token="wrong") as bad:
            with pytest.raises(VrodServerError, match="Authentication"):
                bad.stats()
        with VrodClient(s.address, auth_token="s3cret") as ok:
            ok.execute("CREATE", arg="c;dim=8;segment_rows=64")
            rid = ok.insert("c", np.ones(8, np.float32), "p")
            assert ok.search_similar("c", np.ones(8, np.float32),
                                     k=1)[0].record_id == rid
        assert metrics.counters.snapshot().get("server.auth_failure", 0) >= 3


def test_binary_vector_protocol_parity(server):
    """vector_b64 / vectors_b64 (packed little-endian f32) and JSON float
    lists are interchangeable forms of the same request — identical
    results; malformed binary fields fail cleanly."""
    import base64
    with VrodClient(server.address, binary_vectors=True) as b, \
            VrodClient(server.address, binary_vectors=False) as j:
        vecs, rids = _fill(b)  # CREATE via string path; bulk via b64 form
        q = vecs[7]
        hb = b.search_similar("c", q, k=3)
        hj = j.search_similar("c", q, k=3)
        assert [tuple(h) for h in hb] == [tuple(h) for h in hj]
        assert hb[0].record_id == rids[7]
        bb = b.search_similar_batch("c", vecs[:4], k=2)
        bj = j.search_similar_batch("c", vecs[:4], k=2)
        assert [[tuple(h) for h in hits] for hits in bb] == \
               [[tuple(h) for h in hits] for hits in bj]
        # Mutations through both forms, read back through either.
        r1 = b.insert("c", q * 0.5, "bin")
        r2 = j.insert("c", q * 0.25, "json")
        assert j.get("c", r1)[1] == "bin"
        assert b.get("c", r2)[1] == "json"
        b.update("c", r1, q * 0.1, "bin2")
        assert j.get("c", r1)[1] == "bin2"

        # Malformed binary fields: clean errors, live connection.
        with pytest.raises(VrodServerError, match="vector_b64"):
            b._request(cmd="SEARCHSIMILAR", collection="c",
                       vector_b64="!!!notbase64!!!", k=1)
        with pytest.raises(VrodServerError, match="multiple of 4"):
            b._request(cmd="SEARCHSIMILAR", collection="c",
                       vector_b64=base64.b64encode(b"abc").decode(), k=1)
        # Wrong-dim batch: the rows cross-check catches the silent reshape.
        bad = np.zeros((2, DIM * 2), np.float32)
        with pytest.raises(VrodServerError, match="rows=2"):
            b._request(cmd="SEARCHSIMILAR", collection="c", rows=2, k=1,
                       vectors_b64=base64.b64encode(
                           bad.tobytes()).decode())
        assert b.ping() == "pong"


def test_packed_batch_response_parity(server):
    """binary_hits packed responses decode to exactly the JSON-triples
    answer, including short rows (filters) and empty rows."""
    with VrodClient(server.address, binary_vectors=True) as b, \
            VrodClient(server.address, binary_vectors=False) as j:
        vecs, rids = _fill(b)
        qb = b.search_similar_batch("c", vecs[:5], k=3)   # packed
        qj = j.search_similar_batch("c", vecs[:5], k=3)   # triples
        assert [[tuple(h) for h in hits] for hits in qb] == \
               [[tuple(h) for h in hits] for hits in qj]
        # Filtered (short rows) through the packed path.
        fb = b.search_similar_batch("c", vecs[:3], k=5,
                                    within_ids=[int(rids[0]), int(rids[1])])
        fj = j.search_similar_batch("c", vecs[:3], k=5,
                                    within_ids=[int(rids[0]), int(rids[1])])
        assert [[tuple(h) for h in hits] for hits in fb] == \
               [[tuple(h) for h in hits] for hits in fj]
        assert all(len(hits) == 2 for hits in fb)


def test_raw_batch_response_parity_and_fallback(server, monkeypatch):
    """The raw-continuation batch response (the binary client's default)
    decodes to exactly the base64 form (what a pre-raw server answers —
    forced here by stripping the opt-in flag) and the JSON-triples
    answer; a raw frame shorter than its hits_raw announcement hard-fails
    the connection instead of mis-slicing."""
    from vrod_tpu_torch.client import VrodConnectionError
    with VrodClient(server.address, binary_vectors=True) as b, \
            VrodClient(server.address, binary_vectors=False) as j:
        vecs, rids = _fill(b)
        raw_form = b.search_similar_batch("c", vecs[:5], k=3)
        triples = j.search_similar_batch("c", vecs[:5], k=3)
        assert [[tuple(h) for h in hits] for hits in raw_form] == \
               [[tuple(h) for h in hits] for hits in triples]
        # Pre-raw server emulation: same request without the raw opt-in
        # answers hits_b64; the client's fallback decode must agree.
        orig = b._request

        def strip_raw(**req):
            req.pop("raw", None)
            return orig(**req)

        monkeypatch.setattr(b, "_request", strip_raw)
        b64_form = b.search_similar_batch("c", vecs[:5], k=3)
        assert [[tuple(h) for h in hits] for hits in b64_form] == \
               [[tuple(h) for h in hits] for hits in raw_form]
        monkeypatch.setattr(b, "_request", orig)

        # Torn/mis-announced raw payload: hard connection failure (the
        # bytes cannot be trusted), not a silent mis-slice.
        def doctored(**req):
            return {"hits_raw": {"b": 2, "n": 3}, "raw": b"short",
                    "payloads": ["x", "y", "z"]}

        monkeypatch.setattr(b, "_request", doctored)
        with pytest.raises(VrodConnectionError, match="hits_raw"):
            b.search_similar_batch("c", vecs[:2], k=3)


def test_concurrent_clients_chaos(tmp_db, tmp_path):
    """Search clients race mutator clients through real sockets while
    auto-snapshots fire: every response is well-formed, searches only
    ever return records that were live at some point, and the final
    durable state matches a reload."""
    import threading

    col = tmp_db.create_collection("c", dim=DIM, segment_rows=64,
                                   auto_snapshot_wal_bytes=20000)
    rng = np.random.default_rng(0)
    base = rng.standard_normal((32, DIM)).astype(np.float32)
    col.bulk_insert(base, [f"base{i}" for i in range(32)])

    with VrodServer(tmp_db, f"unix:{tmp_path}/chaos.sock",
                    max_wait_ms=1.0).start() as s:
        stop = threading.Event()
        errors = []

        def searcher(seed):
            r = np.random.default_rng(seed)
            with VrodClient(s.address) as c:
                while not stop.is_set():
                    try:
                        hits = c.search_similar(
                            "c", r.standard_normal(DIM).astype(np.float32),
                            k=3)
                        for h in hits:
                            assert h.record_id >= 1 and isinstance(
                                h.payload, str)
                    except Exception as e:
                        errors.append(("search", e))
                        return

        def mutator(seed):
            r = np.random.default_rng(1000 + seed)
            mine = []
            with VrodClient(s.address) as c:
                while not stop.is_set():
                    try:
                        roll = r.random()
                        if roll < 0.6 or not mine:
                            mine.append(c.insert(
                                "c", r.standard_normal(DIM).astype(
                                    np.float32), f"m{seed}"))
                        elif roll < 0.8:
                            c.delete("c", mine.pop(
                                int(r.integers(0, len(mine)))))
                        else:
                            c.update("c",
                                     mine[int(r.integers(0, len(mine)))],
                                     r.standard_normal(DIM).astype(
                                         np.float32), f"u{seed}")
                    except Exception as e:
                        errors.append(("mutate", e))
                        return

        threads = [threading.Thread(target=searcher, args=(i,))
                   for i in range(4)]
        threads += [threading.Thread(target=mutator, args=(i,))
                    for i in range(3)]
        for t in threads:
            t.start()
        import time as _t
        _t.sleep(4.0)
        stop.set()
        for t in threads:
            t.join(timeout=60)
        # A straggler past the join timeout could mutate after the count
        # is read — fail loudly on the real problem, not on durability.
        assert not any(t.is_alive() for t in threads)
        assert not errors, errors[:3]
        live_count = tmp_db.collection("c").count

    tmp_db.close()
    from vrod_tpu_torch.database import Database
    db2 = Database.load(tmp_db.path)
    try:
        assert db2.collection("c").count == live_count  # durable == live
    finally:
        db2.close()
    # (the tmp_db fixture's teardown close() is idempotent)


def test_client_rejects_bad_shapes_and_empty_bulk(client):
    """Both wire forms agree on shape validation: a 3-D tensor raises
    (the packed form would silently reshape it into garbage queries
    otherwise), and an empty bulk insert is a no-op returning []."""
    client.execute("CREATE", arg=f"c;dim={DIM};segment_rows=64")
    assert client.bulk_insert("c", []) == []
    bad = np.zeros((2, DIM, 3), np.float32)
    with pytest.raises(ValueError, match="2-D"):
        client.search_similar_batch("c", bad, k=1)
    with pytest.raises(ValueError, match="2-D"):
        client.bulk_insert("c", bad)


def test_stats_latency_histogram(client):
    """STATS reports per-event latency quantiles from the log2 histogram."""
    _fill(client, n=4)
    for _ in range(5):
        client.search_similar("c", np.zeros(DIM, np.float32), k=2)
    st = client.stats()
    lat = st["latencies"]
    assert "server.request" in lat
    sr = lat["server.request"]
    assert sr["count"] >= 6
    assert 0 < sr["p50_ms"] <= sr["p99_ms"]
    assert "collection.search" in lat  # engine-path timing flows in too
