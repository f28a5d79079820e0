"""Network serving layer: concurrent clients over one loaded database.

The reference has no server layer (SURVEY §1: CLI → command layer →
database, one process, one thread); vrod-tpu adds one as an extension, and
this is the port's copy of it, speaking the same wire protocol byte for
byte: a long-lived process keeps the database loaded and the kernels built,
and concurrent client connections feed a per-collection ``QueryBatcher`` —
independent clients' single queries pack into one (B, dim) device batch,
which the engine searches with K3 and K1 on the card.

Protocol: newline-delimited JSON over TCP (loopback by default) or a unix
domain socket. One request object per line, one response object per line,
in order, per connection:

    → {"cmd": "SEARCHSIMILAR", "collection": "c", "vector": [...], "k": 5}
    ← {"ok": true, "result": {"hits": [[id, score, payload], ...]}}

Every request may carry a client correlation ``"id"``, echoed in the
response. Two request forms are accepted:

- **Structured** (preferred): ``vector``/``vectors``/``records``/``ids``/
  ``record_id``/``payload`` fields, handled natively (single queries go
  through the batcher; a 2-D ``vectors`` matrix is already a batch and runs
  as one engine call).
- **Command-string parity**: any reference verb with the CLI's ``-a``
  string under ``"arg"`` — routed through the same ``CommandBuilder`` as
  the CLI, so the server speaks the full verb vocabulary by construction.

Admin verbs: ``PING``, ``STATS`` (uptime + process-wide counters — the
``frontend.batch`` counter vs ``server.request`` shows cross-client
batching — and the process's RSS and device memory), ``SHUTDOWN``.

Security model: no auth — bind to loopback or a mode-0700 unix socket (the
default), exactly like the CLI's local trust model. Anyone who can connect
can mutate; do not bind a routable address on an untrusted network.
"""

from __future__ import annotations

import json
import os
import socket
import socketserver
import threading
import time
from pathlib import Path

import numpy as np

from . import metrics
from .commands import CommandBuilder
from .errors import VrodError
from .frontend import QueryBatcher
from .netaddr import parse_addr  # re-export; clients import it sans engine

__all__ = ["VrodServer", "parse_addr", "MAX_LINE_BYTES"]

# One JSON document per line. Bulk inserts ride inline (a 10k x 768 f32
# batch is ~80 MB of JSON text), so the cap is generous; it exists to bound
# memory against a malformed/hostile peer, not to size-limit real requests.
MAX_LINE_BYTES = 256 * 1024 * 1024


class _Handler(socketserver.StreamRequestHandler):
    def handle(self):  # noqa: D102 — socketserver contract
        server: VrodServer = self.server.vrod  # type: ignore[attr-defined]
        metrics.counters.inc("server.connection")
        while not server._closing.is_set():
            try:
                line = self.rfile.readline(MAX_LINE_BYTES + 1)
            except OSError:
                return
            if not line:
                return  # client closed
            if len(line) > MAX_LINE_BYTES:
                self._send({"ok": False,
                            "error": f"Request exceeds {MAX_LINE_BYTES} "
                                     f"bytes; closing connection"})
                return
            line = line.strip()
            if not line:
                continue
            try:
                req = json.loads(line)
                if not isinstance(req, dict):
                    raise ValueError("request must be a JSON object")
            except ValueError as e:
                # Framing is unreliable after a parse error (the "line" may
                # be a fragment of something bigger): answer and close.
                self._send({"ok": False, "error": f"Bad request JSON: {e}"})
                return
            # Re-check AFTER the blocking readline: a connection idle across
            # close() must not dispatch against closed batchers/database.
            if server._closing.is_set():
                resp = {"ok": False, "error": "Server is shutting down"}
                if req.get("id") is not None:  # echo: not a desync
                    resp["id"] = req["id"]
                self._send(resp)
                return
            resp = server.handle_request(req)
            if req.get("id") is not None:
                resp["id"] = req["id"]
            if not self._send(resp):
                return

    def _send(self, obj) -> bool:
        # Raw continuation frames (protocol extension): a handler returns
        # bulk bytes under "__raw__"; the response line then announces
        # "raw_bytes": N and the N bytes follow the newline VERBATIM. The
        # base64-in-JSON forms cap at ~40 MB/s of pure codec on one core
        # (measured in the JAX package; a 4 MiB chunk costs ~100 ms to
        # encode+decode) —
        # replication bootstrap/tail use this to ship at socket speed.
        # Requests remain pure JSON lines; only responses carry raw.
        raw = None
        result = obj.get("result")
        if isinstance(result, dict) and "__raw__" in result:
            raw = result.pop("__raw__")
            result["raw_bytes"] = len(raw)
        try:
            self.wfile.write(json.dumps(obj).encode() + b"\n")
            if raw is not None:
                self.wfile.write(raw)
            self.wfile.flush()
            return True
        except OSError:
            return False


class _ThreadingTCPServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True
    # close() may be reached from a handler thread (SHUTDOWN verb);
    # joining handler threads from one of them would deadlock.
    block_on_close = False
    # socketserver's default backlog of 5 EAGAINs a burst of concurrent
    # unix-socket connects (and SYN-drops TCP ones) — e.g. a client fleet
    # reconnecting at once. 128 matches a typical somaxconn floor.
    request_queue_size = 128


class _ThreadingUnixServer(socketserver.ThreadingUnixStreamServer):
    daemon_threads = True
    block_on_close = False
    request_queue_size = 128


def process_memory() -> dict:
    """This process's resident set (``VmRSS``, read now: ``ru_maxrss``
    would carry a parent's peak across fork and exec) and, once it has
    used a CUDA device, the memory its tensors hold on its current device
    (allocated) and its caching allocator keeps there (reserved), now and
    at their peaks, in bytes: what a drill or a soak reads on the card,
    where the rows live outside RSS."""
    import torch
    out = {}
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                out["rss_bytes"] = int(line.split()[1]) * 1024
    if torch.cuda.is_initialized():
        out.update(
            device_allocated_bytes=torch.cuda.memory_allocated(),
            device_max_allocated_bytes=torch.cuda.max_memory_allocated(),
            device_reserved_bytes=torch.cuda.memory_reserved(),
            device_max_reserved_bytes=torch.cuda.max_memory_reserved())
    return out


class VrodServer:
    """Serve one loaded :class:`~vrod_tpu_torch.database.Database` to
    concurrent network clients. ``addr``: ``"HOST:PORT"``, ``("host",
    port)`` (port 0 = ephemeral), or ``"unix:PATH"``."""

    def __init__(self, db, addr=("127.0.0.1", 0), *, max_batch: int = 256,
                 max_wait_ms: float = 2.0,
                 search_timeout_s: float | None = 600.0,
                 read_only: bool = False, auth_token: str | None = None):
        self.db = db
        self.max_batch = max_batch
        self.max_wait_ms = max_wait_ms
        # Optional shared-secret auth: every request (except PING, a health
        # check) must carry a matching "auth" field. This guards against
        # ACCIDENTAL access on a shared host/network — the transport is
        # plaintext, so it is not a defense against an active attacker;
        # keep the unix-socket/loopback trust model for that.
        self.auth_token = auth_token
        # Read-only replicas reject client mutations; the attached
        # Replicator applies the primary's stream directly (library path,
        # not the network dispatch). PROMOTE flips this off. A durable
        # fence marker (written by the FENCE verb) survives process
        # restarts: a supervisor-restarted old primary mid-cutover must
        # come back fenced, or two writable databases diverge.
        self.read_only = read_only or self._fence_marker().exists()
        self._replicator = None
        # Snapshot pins served to bootstrapping followers: token ->
        # (context manager, hold dir, meta, deadline).
        self._repl_holds: dict[str, tuple] = {}
        self._repl_lock = threading.Lock()
        # Per-query wall clock for the batched path. Generous: the FIRST
        # search of a process builds the CUDA kernels (about a minute of
        # nvcc); a tight cap here would fail real queries whose engine call
        # then completes and is discarded.
        self.search_timeout_s = search_timeout_s
        self._batchers: dict[str, QueryBatcher] = {}
        self._batchers_lock = threading.Lock()
        self._closing = threading.Event()
        self._closed = threading.Event()
        self._inflight = 0
        self._inflight_cv = threading.Condition()
        self._t0 = time.monotonic()
        self._serve_thread: threading.Thread | None = None
        self._sock_inode: int | None = None
        spec = parse_addr(addr)
        if spec[0] == "unix":
            path = Path(spec[1])
            if path.is_socket():
                # Refuse to steal a LIVE server's socket; unlink only a
                # provably stale path (ECONNREFUSED: bound by a process
                # that died without cleanup). A connect timeout means a
                # live-but-backlogged listener — treat as in use.
                probe = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
                try:
                    probe.settimeout(1.0)
                    probe.connect(str(path))
                except ConnectionRefusedError:
                    path.unlink()  # nobody listening: stale
                except OSError as e:
                    raise OSError(
                        f"Refusing to bind {path}: probe inconclusive "
                        f"({e}); if the old server is dead, remove the "
                        f"socket file manually") from e
                else:
                    raise OSError(
                        f"Address already in use: a live server answers on "
                        f"{path}")
                finally:
                    probe.close()
            # Bind under umask 0o077 so there is no window where the
            # default-mode socket (0777 & ~umask) accepts other users.
            old_umask = os.umask(0o077)
            try:
                self._sock = _ThreadingUnixServer(str(path), _Handler)
            finally:
                os.umask(old_umask)
            os.chmod(path, 0o700)
            self._sock_inode = os.stat(path).st_ino
            self.address = f"unix:{path}"
        else:
            self._sock = _ThreadingTCPServer((spec[1], spec[2]), _Handler)
            host, port = self._sock.server_address[:2]
            self.address = f"{host}:{port}"
        self._sock.vrod = self  # type: ignore[attr-defined]

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "VrodServer":
        """Serve on a background thread (tests / embedding in an app)."""
        self._serve_thread = threading.Thread(
            target=self._sock.serve_forever, daemon=True)
        self._serve_thread.start()
        return self

    def serve_forever(self) -> None:
        """Serve on the calling thread until close()/SHUTDOWN/KeyboardInterrupt."""
        try:
            self._sock.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            self.close()

    def close(self, drain_timeout_s: float = 30.0) -> None:
        with self._inflight_cv:
            if self._closing.is_set():
                already_closing = True
            else:
                self._closing.set()
                already_closing = False
        if already_closing:
            # A concurrent close() (e.g. the CLI's finally after a SHUTDOWN
            # verb spawned one on a helper thread) must WAIT for the drain:
            # returning early would let the caller close the Database while
            # a mutation is still mid-WAL-apply on a handler thread.
            self._closed.wait(timeout=drain_timeout_s + 10)
            return
        self._sock.shutdown()
        self._sock.server_close()
        # Drain in-flight requests: in CLI --serve mode the Database closes
        # right after close() returns, and a mutation mid-WAL-apply must
        # not race that. New requests are refused once _closing is set.
        deadline = time.monotonic() + drain_timeout_s
        with self._inflight_cv:
            while self._inflight > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._inflight_cv.wait(timeout=remaining)
        with self._batchers_lock:
            batchers, self._batchers = dict(self._batchers), {}
        for b in batchers.values():
            b.close()
        if self._replicator is not None:
            self._replicator.stop()
        with self._repl_lock:
            holds, self._repl_holds = dict(self._repl_holds), {}
        for cm, _hold, _meta, _deadline in holds.values():
            cm.__exit__(None, None, None)
        if self.address.startswith("unix:"):
            # Unlink only OUR socket: another server may have (wrongly or
            # after our crash-restart) re-bound the same path since.
            path = self.address[len("unix:"):]
            try:
                if os.stat(path).st_ino == self._sock_inode:
                    os.unlink(path)
            except OSError:
                pass
        self._closed.set()  # drain + teardown done: concurrent close() may return
        if self._serve_thread and \
                self._serve_thread is not threading.current_thread():
            self._serve_thread.join(timeout=5)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- request dispatch ---------------------------------------------------

    def handle_request(self, req: dict) -> dict:
        import concurrent.futures

        with self._inflight_cv:
            if self._closing.is_set():
                return {"ok": False, "error": "Server is shutting down"}
            self._inflight += 1
        metrics.counters.inc("server.request")
        t0 = time.monotonic()
        try:
            result = self._dispatch(req)
            return {"ok": True, "result": result}
        except (VrodError, ValueError, TypeError, KeyError) as e:
            metrics.counters.inc("server.error")
            return {"ok": False, "error": str(e) or repr(e)}
        except concurrent.futures.TimeoutError:
            metrics.counters.inc("server.error")
            return {"ok": False,
                    "error": f"Search timed out after "
                             f"{self.search_timeout_s} s (server-side cap)"}
        except Exception as e:  # never kill the connection thread
            metrics.counters.inc("server.error")
            return {"ok": False, "error": f"Internal error: {e!r}"}
        finally:
            # Record ALL outcomes: errored requests — search timeouts above
            # all — are the slow tail a p99 exists to surface.
            metrics.latencies.record("server.request", time.monotonic() - t0)
            with self._inflight_cv:
                self._inflight -= 1
                self._inflight_cv.notify_all()

    # Verbs that change logical database state. On a read-only replica they
    # are rejected at the dispatch boundary (the Replicator's apply path is
    # a library call, not a request). BACKUP/EXPORT/SNAPSHOT-maintenance
    # stay allowed: backups FROM replicas are the standard way to keep load
    # off a primary.
    _MUTATING_VERBS = frozenset({
        "CREATE", "DROP", "TRUNCATEWAL", "INSERT", "BULKINSERT", "UPDATE",
        "DELETE", "REINDEX"})

    def _dispatch(self, req: dict):
        cmd = str(req.get("cmd", "")).upper()
        collection = req.get("collection")
        if cmd == "PING":
            return "pong"
        if self.auth_token is not None:
            import hmac
            if not hmac.compare_digest(
                    str(req.get("auth", "")), self.auth_token):
                metrics.counters.inc("server.auth_failure")
                raise VrodError(
                    "Authentication failed: request needs the server's "
                    "'auth' token")
        if cmd == "STATS":
            from .config import VROD_VERSION
            stats = {"uptime_s": round(time.monotonic() - self._t0, 3),
                     "address": self.address,
                     "version": VROD_VERSION,
                     # Capability discovery for any-language clients: one
                     # STATS instead of per-call trial-and-fallback.
                     # Servers predating a feature simply omit its name.
                     "features": ["binary_vectors", "packed_hits",
                                  "raw_continuations", "min_position",
                                  "replication", "backup_verify",
                                  "fence_promote"],
                     "read_only": self.read_only,
                     "collections": self.db.list_collections(),
                     "counters": metrics.counters.snapshot(),
                     # p50/p95/p99 per timed event (server.request =
                     # whole-request wall time incl. batching wait).
                     "latencies": metrics.latencies.snapshot(),
                     "memory": process_memory()}
            if self._replicator is not None:
                stats["replication"] = self._replicator.status()
            return stats
        if self.read_only and cmd in self._MUTATING_VERBS:
            raise VrodError(
                f"{cmd} rejected: this server is a read-only replica "
                f"(send PROMOTE to make it a standalone primary)")
        if cmd == "PROMOTE":
            return self._promote()
        if cmd == "FENCE":
            # The other half of a zero-loss cutover: stop acking writes on
            # the old primary BEFORE promoting a replica (docs/operations.md
            # runbook). Idempotent; PROMOTE lifts it.
            return self._fence(float(req.get("drain_timeout_s", 30.0)))
        if cmd.startswith("REPL."):
            return self._dispatch_repl(cmd, req)
        if cmd == "SHUTDOWN":
            # close() from a helper thread: the handler thread must finish
            # sending this response first, and serve_forever lives elsewhere.
            threading.Thread(target=self.close, daemon=True).start()
            return "shutting down"

        # Structured fast paths (native JSON fields, no record-string
        # round-trip). Single queries go through the cross-client batcher.
        if cmd in ("SEARCHSIMILAR", "SEARCH") \
                and req.get("min_position") is not None:
            # Read-your-writes across replication: mutation responses carry
            # the primary's durable position; a reader hands it back and
            # the (possibly lagging) replica waits to reach it before
            # serving. On a primary this returns immediately.
            self._await_position(collection, int(req["min_position"]),
                                 float(req.get("position_timeout_s", 10.0)))
        # Search responses serialize (id, score, payload) triples straight
        # from the collection's tuple path — no per-hit objects, no
        # re-walk (the host-side formatting cost used to exceed the device
        # scan itself; see collection.search_triples).
        if cmd == "SEARCHSIMILAR" and ("vector" in req
                                       or "vector_b64" in req):
            triples = self._batcher(collection).search_triples(
                self._req_vector(req), int(req.get("k", 10)),
                timeout=self.search_timeout_s,
                within_ids=req.get("within"), exclude_ids=req.get("exclude"))
            return {"hits": triples}
        if cmd == "SEARCHSIMILAR" and ("vectors" in req
                                       or "vectors_b64" in req):
            # A client-side batch is already a tile: one engine call.
            col = self._collection(collection)
            vecs = self._req_vectors(req, col)
            kk = int(req.get("k", 10))
            fkw = {"within_ids": req.get("within"),
                   "exclude_ids": req.get("exclude")}
            if req.get("binary_hits"):
                # Packed response: at 256 x 100 the JSON triple encode
                # cost ~41 ms in the JAX package's measurement. ids/scores
                # ride as base64 arrays; payload strings stay a JSON list.
                import base64
                ids, scores, counts, payloads = col.search_packed(
                    vecs, kk, **fkw)
                if req.get("raw"):
                    # Raw continuation (same opt-in as REPL.FETCH/TAIL):
                    # counts (B x u4) || ids (N x u8) || scores (N x f4)
                    # ship verbatim after the response line — no base64
                    # codec, no 1.33x inflation. Payload STRINGS stay in
                    # the JSON line (they need escaping anyway).
                    return {"__raw__": b"".join((
                                counts.astype("<u4", copy=False).tobytes(),
                                ids.astype("<u8", copy=False).tobytes(),
                                scores.astype("<f4", copy=False).tobytes())),
                            "hits_raw": {"b": int(counts.shape[0]),
                                         "n": int(ids.shape[0])},
                            "payloads": payloads}
                return {"hits_b64": {
                    "ids": base64.b64encode(
                        ids.astype("<u8", copy=False).tobytes()).decode(),
                    "scores": base64.b64encode(
                        scores.astype("<f4", copy=False).tobytes()).decode(),
                    "counts": base64.b64encode(
                        counts.astype("<u4", copy=False).tobytes()).decode(),
                    "payloads": payloads,
                }}
            return {"batches": col.search_triples(vecs, kk, **fkw)}
        if cmd == "SEARCH" and "record_id" in req:
            rec = self._collection(collection).get(int(req["record_id"]))
            return {"record_id": int(req["record_id"]),
                    "vector": np.asarray(rec.vector, np.float32).tolist(),
                    "payload": rec.payload}
        # Mutation responses carry "position" (the collection's durable LSN
        # after the ack) so clients can demand read-your-writes from a
        # replica via SEARCH*/min_position.
        if cmd == "INSERT" and ("vector" in req or "vector_b64" in req):
            col = self._collection(collection)
            rid = col.insert(self._req_vector(req),
                             str(req.get("payload", "")))
            return {"record_id": int(rid), "position": col.repl_position()}
        if cmd == "BULKINSERT" and "vectors_b64" in req:
            # Binary bulk form: packed little-endian f32 rows + a parallel
            # payload list (the [vec-list, payload] record form stays
            # supported below for non-Python clients).
            col = self._collection(collection)
            vecs = self._req_vectors(req, col)
            payloads = req.get("payloads") or [""] * len(vecs)
            rids = col.bulk_insert(vecs, [str(p) for p in payloads])
            return {"record_ids": [int(r) for r in rids],
                    "position": col.repl_position()}
        if cmd == "BULKINSERT" and "records" in req:
            records = req["records"]
            if not records:
                # position included even for the no-op: clients track the
                # read-your-writes high-water off every mutation response.
                col = self._collection(collection)
                return {"record_ids": [], "position": col.repl_position()}
            vecs = np.asarray([r[0] for r in records], dtype=np.float32)
            payloads = [str(r[1]) if len(r) > 1 else "" for r in records]
            col = self._collection(collection)
            rids = col.bulk_insert(vecs, payloads)
            return {"record_ids": [int(r) for r in rids],
                    "position": col.repl_position()}
        if cmd == "UPDATE" and ("vector" in req or "vector_b64" in req):
            rid = int(req["record_id"])
            col = self._collection(collection)
            col.update(rid, self._req_vector(req),
                       str(req.get("payload", "")))
            return {"record_id": rid, "position": col.repl_position()}
        if cmd == "DELETE" and "ids" in req:
            col = self._collection(collection)
            n = col.delete_many([int(i) for i in req["ids"]])
            return {"deleted": int(n), "position": col.repl_position()}

        # Command-string parity path: the CLI's exact contract.
        out = CommandBuilder(self.db).build(
            collection, cmd, req.get("arg")).execute()
        if cmd == "DROP":
            self._forget_batcher(req.get("arg"))
        return out

    # -- helpers -------------------------------------------------------------

    def _collection(self, name):
        if not name:
            raise ValueError("Request requires a 'collection'")
        return self.db.collection(str(name))

    @staticmethod
    def _req_vector(req) -> np.ndarray:
        """One query/record vector from a request: ``vector`` (JSON float
        list — any client) or ``vector_b64`` (base64 of packed
        little-endian float32 — ~17x cheaper to parse than a 768-float
        JSON list and 3.8x smaller on the wire; what VrodClient sends by
        default)."""
        b64 = req.get("vector_b64")
        if b64 is None:
            return np.asarray(req["vector"], np.float32)
        import base64
        try:
            buf = base64.b64decode(b64, validate=True)
        except Exception as e:
            raise ValueError(f"Bad vector_b64: {e}")
        if len(buf) % 4:
            raise ValueError(
                f"vector_b64 must be packed little-endian float32 "
                f"(got {len(buf)} bytes, not a multiple of 4)")
        return np.frombuffer(buf, dtype="<f4")

    def _req_vectors(self, req, col) -> np.ndarray:
        """A 2-D query/record matrix: ``vectors`` (JSON list of rows) or
        ``vectors_b64`` (packed little-endian float32 rows; the row width
        is the collection's dim). ``col`` is the already-resolved
        Collection (callers need it anyway — no second registry lookup)."""
        b64 = req.get("vectors_b64")
        if b64 is None:
            vecs = np.asarray(req["vectors"], dtype=np.float32)
            if vecs.ndim != 2:
                raise ValueError(
                    f"'vectors' must be 2-D, got shape {vecs.shape}")
            return vecs
        flat = self._req_vector({"vector_b64": b64})
        dim = col.config.dim
        if flat.size == 0 or flat.size % dim:
            raise ValueError(
                f"vectors_b64 holds {flat.size} float32s, not a multiple "
                f"of the collection dim {dim}")
        vecs = flat.reshape(-1, dim)
        rows = req.get("rows")
        if rows is not None and int(rows) != vecs.shape[0]:
            raise ValueError(
                f"vectors_b64 reshapes to {vecs.shape[0]} rows of the "
                f"collection dim {dim}, but the request says rows={rows} "
                f"— wrong-dim batch?")
        return vecs

    def _await_position(self, name, min_position: int,
                        timeout_s: float) -> None:
        """Block until the collection's durable position reaches
        ``min_position`` (replication catch-up) or fail with a clear
        staleness error. Polling (5 ms) keeps it simple: the wait is the
        rare path — only readers who explicitly demand read-your-writes
        on a lagging replica ever sit here. Re-resolves the collection
        each poll: a concurrent resync drops and re-creates it."""
        deadline = time.monotonic() + max(0.0, timeout_s)
        while True:
            try:
                pos = self._collection(name).repl_position()
            except VrodError:
                # Transiently absent is only plausible mid-resync, i.e.
                # when a replicator is attached; on a plain server a
                # missing collection is just a wrong name — fail with the
                # real error, not a 10 s stall + "Replica is behind".
                if self._replicator is None:
                    raise
                pos = -1  # mid-resync (dropped): keep waiting
            if pos >= min_position:
                return
            if time.monotonic() >= deadline or self._closing.is_set():
                raise VrodError(
                    f"Replica is behind: position {pos} < requested "
                    f"min_position {min_position} after {timeout_s} s")
            time.sleep(0.005)

    def _batcher(self, name) -> QueryBatcher:
        col = self._collection(name)
        with self._batchers_lock:
            if self._closing.is_set():
                raise VrodError("Server is shutting down")
            b = self._batchers.get(col.config.name)
            if b is None or b.collection is not col:
                # New collection object (first use, or re-created after a
                # DROP that raced _forget_batcher): replace the batcher.
                if b is not None:
                    b.close()
                b = QueryBatcher(col, max_batch=self.max_batch,
                                 max_wait_ms=self.max_wait_ms)
                self._batchers[col.config.name] = b
            return b

    def _forget_batcher(self, name) -> None:
        if not name:
            return
        with self._batchers_lock:
            b = self._batchers.pop(str(name).strip(), None)
        if b is not None:
            b.close()

    # -- replication source + promotion --------------------------------------
    #
    # Any server can feed followers (see replication.py for the
    # puller). Protocol, all newline-JSON like everything else:
    #   REPL.MANIFEST                        -> collections, configs, head LSNs
    #   REPL.SNAPSHOT  {collection}          -> pin the snapshot; token + files
    #   REPL.FETCH     {token, file, offset, size} -> base64 bytes
    #   REPL.RELEASE   {token}               -> drop the pin
    #   REPL.TAIL      {collection, after, max_bytes} -> WAL frames > after
    #   PROMOTE                              -> replica becomes a primary

    REPL_HOLD_TTL_S = 600.0  # a crashed follower must not pin disk forever
    REPL_FETCH_MAX = 8 << 20

    def attach_replicator(self, replicator) -> None:
        self._replicator = replicator

    def _fence_marker(self) -> Path:
        return Path(self.db.path) / "vr_fence"

    def _fence(self, drain_timeout_s: float) -> str:
        # Durable first: a fence that survives only in memory lets a
        # supervisor-restarted old primary come back writable mid-cutover.
        self.read_only = True
        marker = self._fence_marker()
        marker.touch()
        from .snapshot import fsync_dir
        fsync_dir(marker.parent)
        metrics.counters.inc("server.fences")
        # Drain: a mutation that passed the read_only check concurrently
        # with this FENCE may still be mid-apply — it will be ACKED, so
        # "fenced" must not return (and let the operator read replica
        # positions) until it has landed in the WAL and the position it
        # bumps is visible. In-flight searches count too (cheap wait;
        # cannot tell them apart), bounded by the timeout.
        deadline = time.monotonic() + max(0.0, drain_timeout_s)
        with self._inflight_cv:
            while self._inflight > 1:  # > 1: this FENCE is itself in-flight
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return (f"fenced, but {self._inflight - 1} requests "
                            f"still in flight after {drain_timeout_s} s — "
                            f"re-check replica positions before PROMOTE")
                self._inflight_cv.wait(timeout=remaining)
        return "fenced: mutations rejected and in-flight requests drained"

    def _promote(self) -> str:
        if not self.read_only and self._replicator is None:
            return "already a primary"
        if self._replicator is not None:
            self._replicator.stop()
            self._replicator = None
        self.read_only = False
        try:
            marker = self._fence_marker()
            if marker.exists():
                marker.unlink()
                from .snapshot import fsync_dir
                fsync_dir(marker.parent)
        except OSError:
            pass  # in-memory state is already writable; marker is advisory
        metrics.counters.inc("server.promotions")
        return "promoted: replication stopped, writes enabled"

    def _dispatch_repl(self, cmd: str, req: dict):
        import base64
        self._sweep_repl_holds()
        if cmd == "REPL.MANIFEST":
            out = {}
            for name in self.db.list_collections():
                out[name] = {
                    "config": self.db.collection_config_json(name),
                    "position": self.db.collection_position(name),
                }
            return {"collections": out}
        if cmd == "REPL.TAIL":
            name = req.get("collection")
            if not name:
                raise ValueError("Request requires a 'collection'")
            after = int(req.get("after", 0))
            if not self.db.is_loaded(str(name)):
                # Cold collection: answer caught-up/resync polls from disk
                # metadata alone — tailing must not force a device restore
                # the primary's own clients never asked for. A genuinely
                # behind follower falls through and pays the load once.
                pos = self.db.collection_position(str(name))
                if after >= pos:
                    return {"frames": [], "position": pos,
                            "resync": after > pos}
            col = self._collection(name)
            r = col.repl_tail(
                after,
                max_bytes=min(int(req.get("max_bytes", self.REPL_FETCH_MAX)),
                              self.REPL_FETCH_MAX))
            metrics.counters.inc("repl.frames_served", len(r["frames"]))
            if req.get("raw"):
                # Packed frame stream: <u64 lsn><u32 len><payload> each,
                # shipped as one raw continuation (see _Handler._send).
                import struct as _struct
                parts = []
                for lsn, p in r["frames"]:
                    parts.append(_struct.pack("<QI", lsn, len(p)))
                    parts.append(p)
                return {"__raw__": b"".join(parts),
                        "frames_n": len(r["frames"]),
                        "position": r["position"], "resync": r["resync"]}
            return {"frames": [[lsn, base64.b64encode(p).decode()]
                               for lsn, p in r["frames"]],
                    "position": r["position"], "resync": r["resync"]}
        if cmd == "REPL.SNAPSHOT":
            import uuid
            col = self._collection(req.get("collection"))
            cm = col.hold_snapshot()
            hold = cm.__enter__()
            if hold is None:  # never snapshotted: bootstrap is WAL-only
                cm.__exit__(None, None, None)
                return {"token": None, "files": [], "floor": 0,
                        "config": col.config.to_json()}
            token = uuid.uuid4().hex
            try:
                import json as _json
                meta = _json.loads((hold / "meta.json").read_text())
                crcs = dict(meta.get("crc32", {}))
                from . import snapshot as snapio
                files = []
                for f in sorted(hold.iterdir()):
                    crc = crcs.get(f.name)
                    if crc is None:  # meta.json itself / legacy layouts
                        crc = snapio.crc32_of_file(f)
                    files.append([f.name, f.stat().st_size, int(crc)])
            except BaseException:
                cm.__exit__(None, None, None)
                raise
            with self._repl_lock:
                self._repl_holds[token] = (
                    cm, hold, meta,
                    time.monotonic() + self.REPL_HOLD_TTL_S)
            return {"token": token, "files": files,
                    "floor": int(meta.get("last_lsn", 0)),
                    "config": col.config.to_json()}
        if cmd == "REPL.FETCH":
            token = str(req.get("token"))
            with self._repl_lock:
                ent = self._repl_holds.get(token)
                if ent is not None:
                    # Refresh the TTL: it bounds ABANDONED holds, so it must
                    # measure idle time, not total transfer time — a 30 GB
                    # bootstrap legitimately fetches for longer than any
                    # fixed deadline.
                    ent = (ent[0], ent[1], ent[2],
                           time.monotonic() + self.REPL_HOLD_TTL_S)
                    self._repl_holds[token] = ent
            if ent is None:
                raise VrodError("Unknown or expired replication token "
                                "(re-run REPL.SNAPSHOT)")
            _cm, hold, _meta, _dl = ent
            fname = str(req.get("file", ""))
            if "/" in fname or fname in ("", ".", ".."):
                raise ValueError(f"Bad snapshot file name {fname!r}")
            path = hold / fname
            offset = int(req.get("offset", 0))
            size = min(int(req.get("size", self.REPL_FETCH_MAX)),
                       self.REPL_FETCH_MAX)
            with open(path, "rb") as f:
                f.seek(offset)
                data = f.read(size)
            metrics.counters.inc("repl.bytes_served", len(data))
            eof = offset + len(data) >= path.stat().st_size
            if req.get("raw"):
                return {"__raw__": data, "eof": eof}
            return {"data": base64.b64encode(data).decode(), "eof": eof}
        if cmd == "REPL.RELEASE":
            with self._repl_lock:
                ent = self._repl_holds.pop(str(req.get("token")), None)
            if ent is not None:
                ent[0].__exit__(None, None, None)
            return "released"
        raise VrodError(f"Unknown replication verb {cmd!r}")

    def _sweep_repl_holds(self) -> None:
        now = time.monotonic()
        expired = []
        with self._repl_lock:
            for token, ent in list(self._repl_holds.items()):
                if ent[3] < now:
                    expired.append(self._repl_holds.pop(token))
        for cm, _hold, _meta, _dl in expired:
            cm.__exit__(None, None, None)
