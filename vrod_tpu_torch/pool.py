"""Read-scaling client pool: one primary + N replicas, with failover.

Completes the replication story (``replication.py``) on the
client side: mutations go to the primary, reads round-robin across the
replicas, and each mutation's durable ``position`` is threaded into
subsequent reads as ``min_position`` so the pool is read-your-writes by
default despite asynchronous replication.

Failure model: an endpoint whose transport breaks (connect failure,
timeout, desync) is marked down and skipped for ``cooldown_s``; reads fail
over to the next healthy replica and finally to the primary, so a pool
read only fails when every endpoint is unreachable. Server-side errors
(bad request, staleness timeout) are NOT failover events — they are
answers, and retrying them elsewhere would just duplicate the wait.

Engine-free import (sockets + json only), like ``VrodClient``.
"""

from __future__ import annotations

import threading
import time

from .client import VrodClient, VrodConnectionError, VrodServerError

__all__ = ["VrodPool"]


class _Endpoint:
    __slots__ = ("addr", "client", "down_until")

    def __init__(self, addr):
        self.addr = addr
        self.client: VrodClient | None = None
        self.down_until = 0.0


class VrodPool:
    """``writes`` → primary; ``reads`` → round-robin over replicas (falling
    back to the primary when none are healthy). Mirrors the VrodClient
    API. Thread-safe; connections are lazy and re-established after the
    cooldown once an endpoint recovers."""

    def __init__(self, primary_addr, replica_addrs=(), *,
                 auth_token: str | None = None, timeout: float | None = 600.0,
                 connect_timeout: float | None = 5.0,
                 cooldown_s: float = 5.0, read_your_writes: bool = True,
                 binary_vectors: bool = True):
        self._primary = _Endpoint(primary_addr)
        self._replicas = [_Endpoint(a) for a in replica_addrs]
        self._auth_token = auth_token
        self._timeout = timeout
        # Dead hosts must fail the connect in seconds, not the op timeout
        # (which is sized for slow first-compile searches): failover speed
        # is bounded by this.
        self._connect_timeout = connect_timeout
        self._binary = binary_vectors  # passthrough (non-upgraded servers)
        self.cooldown_s = cooldown_s
        self.read_your_writes = read_your_writes
        self._rr = 0
        self._lock = threading.Lock()
        self._positions: dict[str, int] = {}  # per-collection write high-water

    # -- lifecycle ------------------------------------------------------------

    def close(self) -> None:
        for ep in [self._primary, *self._replicas]:
            c, ep.client = ep.client, None
            if c is not None:
                c.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- endpoint management ----------------------------------------------------

    def _connect(self, ep: _Endpoint) -> VrodClient:
        with self._lock:
            c = ep.client
        if c is not None:
            return c
        # Connect OUTSIDE the lock (a slow connect must not stall other
        # endpoints' reads), then install; a racing winner keeps its
        # client and the loser's is closed.
        c = VrodClient(ep.addr, timeout=self._timeout,
                       connect_timeout=self._connect_timeout,
                       auth_token=self._auth_token,
                       binary_vectors=self._binary)
        with self._lock:
            if ep.client is None:
                ep.client = c
                return c
            extra = c
        extra.close()
        with self._lock:
            return ep.client

    def _mark_down(self, ep: _Endpoint, client) -> None:
        """Cool the endpoint and drop OUR failed client. Only the slot
        reference is cleared — the client object is not force-closed,
        because another thread may be mid-request on it (its own failure
        will route it here too); the socket closes with the last ref."""
        with self._lock:
            ep.down_until = time.monotonic() + self.cooldown_s
            if ep.client is client:
                ep.client = None

    def _read_order(self) -> list[_Endpoint]:
        """Healthy replicas starting at the round-robin cursor, then the
        primary; endpoints still cooling down come LAST — a read must
        never wait on a known-dead host's connect before trying the
        healthy primary."""
        now = time.monotonic()
        with self._lock:
            self._rr += 1
            start = self._rr
        n = len(self._replicas)
        rotated = [self._replicas[(start + i) % n] for i in range(n)]
        healthy = [ep for ep in rotated if ep.down_until <= now]
        cooling = [ep for ep in rotated if ep.down_until > now]
        return healthy + [self._primary] + cooling

    def _read(self, fn):
        last_exc: Exception | None = None
        for ep in self._read_order():
            client = None
            try:
                client = self._connect(ep)
                return fn(client)
            except (VrodConnectionError, OSError) as e:
                self._mark_down(ep, client)
                last_exc = e
            except VrodServerError as e:
                # A gracefully-draining server answers ok:false "shutting
                # down" on a live socket: for an idempotent READ that is a
                # failover event (rolling restarts), not an answer.
                if "shutting down" not in str(e):
                    raise
                self._mark_down(ep, client)
                last_exc = e
        raise VrodConnectionError(
            f"No endpoint reachable (last error: {last_exc})")

    def _write(self, fn, collection=None):
        # Writes never fail over (a retried maybe-applied mutation would
        # duplicate records); the primary's cooldown only gates READS.
        c = self._connect(self._primary)
        out = fn(c)
        if collection is not None:
            # Capture the position from THE client that served the write,
            # before any concurrent failover can recycle the slot.
            self._note_position(collection, c.position(collection))
        return out

    def _note_position(self, collection: str, pos: int) -> None:
        with self._lock:
            if pos > self._positions.get(str(collection), 0):
                self._positions[str(collection)] = pos

    def _min_pos(self, collection: str, explicit):
        if explicit is not None:
            return explicit
        if not self.read_your_writes:
            return None
        with self._lock:
            return self._positions.get(str(collection)) or None

    # -- API (mirrors VrodClient) ----------------------------------------------

    def position(self, collection: str) -> int:
        with self._lock:
            return self._positions.get(str(collection), 0)

    def insert(self, collection, vector, payload: str = "") -> int:
        return self._write(
            lambda c: c.insert(collection, vector, payload), collection)

    def bulk_insert(self, collection, vectors, payloads=None) -> list[int]:
        return self._write(
            lambda c: c.bulk_insert(collection, vectors, payloads),
            collection)

    def update(self, collection, record_id, vector, payload: str = "") -> None:
        self._write(
            lambda c: c.update(collection, record_id, vector, payload),
            collection)

    def delete(self, collection, ids) -> int:
        return self._write(lambda c: c.delete(collection, ids), collection)

    def execute(self, cmd, collection=None, arg=None):
        """Verb strings are admin/mutating: always the primary. NOTE: the
        string parity path reports no durable position, so mutations made
        this way are NOT covered by the pool's automatic read-your-writes
        — use the structured methods (insert/update/delete) when a
        subsequent replica read must see the write."""
        return self._write(lambda c: c.execute(cmd, collection, arg))

    def search_similar(self, collection, vector, k: int = 10, *,
                       within_ids=None, exclude_ids=None,
                       min_position: int | None = None):
        mp = self._min_pos(collection, min_position)
        return self._read(lambda c: c.search_similar(
            collection, vector, k, within_ids=within_ids,
            exclude_ids=exclude_ids, min_position=mp))

    def search_similar_batch(self, collection, vectors, k: int = 10, *,
                             within_ids=None, exclude_ids=None,
                             min_position: int | None = None):
        mp = self._min_pos(collection, min_position)
        return self._read(lambda c: c.search_similar_batch(
            collection, vectors, k, within_ids=within_ids,
            exclude_ids=exclude_ids, min_position=mp))

    def get(self, collection, record_id, *, min_position: int | None = None):
        mp = self._min_pos(collection, min_position)
        return self._read(lambda c: c.get(collection, record_id,
                                          min_position=mp))

    def ping(self) -> str:
        return self._read(lambda c: c.ping())

    def stats(self) -> dict:
        """Primary's stats (replicas report their own via direct clients)."""
        return self._write(lambda c: c.stats())
