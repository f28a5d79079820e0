"""Pull-based replication: keep a local database converged to a primary.

The reference is a single-process store (SURVEY §1); replication is a
vrod-tpu extension built from parts the durability design already
guarantees:

- every mutation is one WAL frame, applied in LSN order, idempotent on
  replay (``collection.py`` WAL-first contract), so a replica that applies
  the primary's frame stream in order IS the primary's state;
- snapshots record the LSN they cut at (``meta.json last_lsn``), so a
  follower bootstraps from snapshot files + the WAL tail exactly like a
  local restart does;
- the server can pin a snapshot with hardlinks (``Collection.
  hold_snapshot``) and serve its immutable files in chunks.

A :class:`Replicator` polls the primary (any ``VrodServer`` — every server
is a replication source): it converges the collection registry (creates
from the primary's manifest, drops what vanished), bootstraps new
collections from a pinned snapshot, then tails each collection's WAL with
``REPL.TAIL``, applying frames via ``Collection.replica_apply`` — which
appends the frame bytes verbatim to the replica's own WAL before applying,
so a replica restart resumes from its own durable position with no
re-bootstrap. If the primary truncated past the follower's position (the
follower was down across a snapshot) the tail answers ``resync`` and the
collection is dropped and re-bootstrapped.

Consistency model: asynchronous, eventually consistent. A replica serves
reads only (``VrodServer(read_only=True)`` rejects client mutations);
``PROMOTE`` stops the replicator and enables writes — there is NO fencing
of the old primary (stop it first; two writable databases diverge).

Scope: single-process databases on both ends (either package's: the
replication verbs and WAL frames are the same bytes). The replica applies
ops through the same engine path as a primary, so searches on the replica
are exact over whatever prefix it has applied.
"""

from __future__ import annotations

import base64
import threading
import time

from . import metrics
from .client import VrodClient, VrodConnectionError, VrodServerError
from .errors import VrodError


class ReplicationError(VrodError):
    pass


class Replicator:
    """Pull ``collections`` (None = every collection on the primary) from
    ``primary_addr`` into ``db``. The replica database should be dedicated:
    local collections matching the filter but absent on the primary are
    DROPPED to converge.

    ``start()`` spawns the poll loop; ``stop()`` halts it (idempotent).
    ``wait_caught_up()`` blocks until every tracked collection's local
    position matches the primary's (for tests and cutover scripts)."""

    def __init__(self, db, primary_addr, *, collections=None,
                 poll_interval_s: float = 0.5, max_bytes: int = 8 << 20,
                 fetch_bytes: int = 4 << 20, auth_token: str | None = None):
        self.db = db
        self.primary_addr = primary_addr
        self._auth_token = auth_token  # the PRIMARY's token (if it has one)
        self._filter = (None if collections in (None, "*")
                        else frozenset(collections))
        self.poll_interval_s = poll_interval_s
        self.max_bytes = max_bytes
        self.fetch_bytes = fetch_bytes
        self._client: VrodClient | None = None
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._thread: threading.Thread | None = None
        self._lock = threading.Lock()  # status snapshot consistency
        self._positions: dict[str, int] = {}   # local applied head per col
        self._primary_pos: dict[str, int] = {}
        self._last_error: str | None = None
        # Pass bookkeeping for wait_caught_up: a caller must observe a pass
        # that STARTED after it was called (an in-flight pass may have read
        # the manifest before the caller's mutations were acked).
        self._pass_cv = threading.Condition()
        self._passes_started = 0
        self._passes_ok = 0  # index of the latest successfully completed pass

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "Replicator":
        if self._thread is not None:
            raise ReplicationError("Replicator already started")
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="vrod-replicator")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()
        t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=60)
        c, self._client = self._client, None
        if c is not None:
            c.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()

    def status(self) -> dict:
        with self._lock:
            # Per-collection lag = primary position minus applied position
            # (in LSNs): 0 = caught up; > 0 = frames behind; a collection
            # known to the primary but not yet bootstrapped locally shows
            # its full primary position. Negative would mean the replica is
            # AHEAD (a rebuilt primary) — surfaced raw, the next tail pass
            # resyncs it.
            lag = {n: p - self._positions.get(n, 0)
                   for n, p in self._primary_pos.items()}
            return {
                "primary": str(self.primary_addr),
                "running": self._thread is not None
                and self._thread.is_alive(),
                "positions": dict(self._positions),
                "primary_positions": dict(self._primary_pos),
                "lag": lag,
                "max_lag": max(lag.values(), default=0),
                "last_error": self._last_error,
            }

    def wait_caught_up(self, timeout: float = 60.0) -> None:
        """Block until a sync pass that started after this call completes
        with every tracked collection at the primary's position (as of that
        pass). Mutations acked on the primary before this call are applied
        locally when it returns."""
        deadline = time.monotonic() + timeout
        with self._pass_cv:
            entry = self._passes_started
        while time.monotonic() < deadline:
            self._wake.set()  # don't sit out the poll interval
            with self._pass_cv:
                self._pass_cv.wait(timeout=0.05)
                ok = self._passes_ok
            if ok <= entry:
                continue
            with self._lock:
                err = self._last_error
                lag = {n: self._primary_pos.get(n, 0) - p
                       for n, p in self._positions.items()}
                names_ok = set(self._positions) >= set(self._primary_pos)
            if err is None and names_ok and all(
                    v <= 0 for v in lag.values()):
                return
            entry = ok  # mutations landed mid-pass: require another pass
        raise TimeoutError(
            f"Replica did not catch up within {timeout} s: {self.status()}")

    # -- poll loop -----------------------------------------------------------

    def _run(self) -> None:
        while not self._stop.is_set():
            with self._pass_cv:
                self._passes_started += 1
                mine = self._passes_started
            try:
                self._sync_once()
                with self._lock:
                    self._last_error = None
                with self._pass_cv:
                    self._passes_ok = mine
                    self._pass_cv.notify_all()
            except (VrodConnectionError, OSError) as e:
                # Transport broke: the client hard-fails forever, so drop it
                # and reconnect on the next pass.
                self._note_error(f"connection: {e}")
                c, self._client = self._client, None
                if c is not None:
                    c.close()
            except Exception as e:
                self._note_error(repr(e))
            self._wake.wait(timeout=self.poll_interval_s)
            self._wake.clear()

    def _note_error(self, msg: str) -> None:
        metrics.counters.inc("repl.errors")
        with self._lock:
            self._last_error = msg

    def _rpc(self, **req):
        if self._client is None:
            self._client = VrodClient(self.primary_addr,
                                      auth_token=self._auth_token)
        return self._client._request(**req)

    def _tracked(self, name: str) -> bool:
        return self._filter is None or name in self._filter

    def _sync_once(self) -> None:
        manifest = self._rpc(cmd="REPL.MANIFEST")["collections"]
        remote = {n: m for n, m in manifest.items() if self._tracked(n)}
        with self._lock:
            self._primary_pos = {
                n: int(m["position"]) for n, m in remote.items()}
        # Converge the registry: drop local collections the primary lost.
        for name in list(self.db.list_collections()):
            if self._tracked(name) and name not in remote:
                self.db.drop_collection(name)
                with self._lock:
                    self._positions.pop(name, None)
                metrics.counters.inc("repl.drops")
        for name in sorted(remote):
            if self._stop.is_set():
                return
            if name not in self.db.list_collections():
                self._bootstrap(name)
            else:
                with self._lock:
                    local = self._positions.get(name)
                if local is not None and local == int(remote[name]["position"]):
                    continue  # caught up as of this manifest: skip the RPC
            self._tail(name)

    # -- bootstrap (snapshot ship) --------------------------------------------

    def _bootstrap(self, name: str) -> None:
        import shutil
        import tempfile
        import zlib
        from .collection import Collection
        from .config import COLLECTIONS_DIR, SNAPSHOT_DIR, CollectionConfig
        from .snapshot import fsync_dir, fsync_file

        snap = self._rpc(cmd="REPL.SNAPSHOT", collection=name)
        staging = tempfile.mkdtemp(
            prefix=".repl_boot_", dir=self.db.path / COLLECTIONS_DIR)
        try:
            cfg = CollectionConfig.from_json(snap["config"])
            if cfg.name != name:
                raise ReplicationError(
                    f"Primary sent config named {cfg.name!r} for {name!r}")
            Collection.create_on_disk(staging, cfg, exist_ok=True)
            if snap["token"] is not None:
                from pathlib import Path
                sdir = Path(staging) / SNAPSHOT_DIR
                sdir.mkdir()
                for fname, fsize, fcrc in snap["files"]:
                    # The protocol has no auth: never let a spoofed primary
                    # steer writes outside the staging snapshot dir.
                    fname = str(fname)
                    if ("/" in fname or "\\" in fname
                            or fname in ("", ".", "..")):
                        raise ReplicationError(
                            f"Primary sent unsafe snapshot file name "
                            f"{fname!r}")
                    crc = 0
                    with open(sdir / fname, "wb") as out:
                        offset = 0
                        while offset < fsize:
                            r = self._rpc(cmd="REPL.FETCH",
                                          token=snap["token"], file=fname,
                                          offset=offset,
                                          size=self.fetch_bytes, raw=True)
                            # raw continuation when the primary supports
                            # it (socket-speed); base64 from older ones.
                            data = (r["raw"] if "raw" in r
                                    else base64.b64decode(r["data"]))
                            if not data:
                                raise ReplicationError(
                                    f"Short fetch of {fname} at {offset}")
                            out.write(data)
                            crc = zlib.crc32(data, crc)
                            offset += len(data)
                            metrics.counters.inc(
                                "repl.bytes_fetched", len(data))
                    if (crc & 0xFFFFFFFF) != int(fcrc):
                        raise ReplicationError(
                            f"CRC mismatch fetching snapshot file {fname} "
                            f"of {name!r} (transfer corrupted); will retry")
                    fsync_file(sdir / fname)
                fsync_dir(sdir)
            fsync_dir(staging)
            self.db.adopt_collection_dir(name, staging)
            metrics.counters.inc("repl.bootstraps")
        except BaseException:
            shutil.rmtree(staging, ignore_errors=True)
            raise
        finally:
            if snap["token"] is not None:
                try:
                    self._rpc(cmd="REPL.RELEASE", token=snap["token"])
                except (VrodConnectionError, VrodServerError, OSError):
                    pass  # the primary's TTL sweep reclaims it

    # -- tail (WAL frame stream) ----------------------------------------------

    @staticmethod
    def _decode_frames(r: dict) -> list[tuple[int, bytes]]:
        """REPL.TAIL frames in either wire form: raw-packed
        ``<u64 lsn><u32 len><payload>`` (a primary honoring ``raw=True``)
        or ``[lsn, base64]`` pairs (older primaries, and the caught-up
        cold-collection fast path, which answers in JSON regardless)."""
        import struct
        if "raw" in r:
            data = r["raw"]
            want = int(r.get("frames_n", -1))
            frames = []
            off = 0
            while off < len(data):
                if off + 12 > len(data):
                    raise ReplicationError(
                        "Torn raw frame header in REPL.TAIL response")
                lsn, plen = struct.unpack_from("<QI", data, off)
                off += 12
                if off + plen > len(data):
                    raise ReplicationError(
                        "Torn raw frame payload in REPL.TAIL response")
                frames.append((lsn, data[off:off + plen]))
                off += plen
            if want >= 0 and want != len(frames):
                raise ReplicationError(
                    f"REPL.TAIL announced {want} frames, raw stream "
                    f"held {len(frames)}")
            return frames
        return [(int(lsn), base64.b64decode(b64))
                for lsn, b64 in r["frames"]]

    def _tail(self, name: str) -> None:
        col = self.db.collection(name)
        pos = col.repl_position()
        resyncs = 0
        primary_head = None
        while not self._stop.is_set():
            r = self._rpc(cmd="REPL.TAIL", collection=name, after=pos,
                          max_bytes=self.max_bytes, raw=True)
            # The TAIL answer carries the primary's head AT SERVE TIME —
            # fresher than the pass-start manifest, whose staleness would
            # otherwise show a spurious NEGATIVE lag in status() right
            # after frames newer than the manifest apply.
            primary_head = max(primary_head or 0, int(r["position"]))
            if r["resync"]:
                # The primary truncated past us (or we are ahead of a
                # rebuilt primary): local state cannot be patched forward.
                resyncs += 1
                if resyncs > 3:
                    # Circuit breaker: a bootstrap that lands behind the
                    # floor again points at a primary whose snapshot/floor
                    # are inconsistent — hot-looping drop+bootstrap would
                    # burn both hosts forever and hide the fault (the
                    # pre-fix snapshot-of-empty-WAL bug did exactly this).
                    # Surface it; the next poll pass retries.
                    raise ReplicationError(
                        f"Collection {name!r} resynced {resyncs - 1}x in "
                        f"one pass and is still behind (local {pos}, "
                        f"primary {r['position']}): the primary's snapshot "
                        f"does not reach its own WAL floor")
                metrics.counters.inc("repl.resyncs")
                self.db.drop_collection(name)
                with self._lock:
                    self._positions.pop(name, None)
                self._bootstrap(name)
                col = self.db.collection(name)
                pos = col.repl_position()
                continue
            frames = self._decode_frames(r)
            if not frames:
                break
            resyncs = 0  # forward progress: the breaker counts only
            #              consecutive resyncs WITHOUT applied frames
            for lsn, payload in frames:
                col.replica_apply(int(lsn), payload, sync=False)
            col.replica_sync(int(frames[-1][0]))
            pos = int(frames[-1][0])
            metrics.counters.inc("repl.frames_applied", len(frames))
        with self._lock:
            self._positions[name] = pos
            if primary_head is not None and name in self._primary_pos:
                self._primary_pos[name] = max(self._primary_pos[name],
                                              primary_head)
