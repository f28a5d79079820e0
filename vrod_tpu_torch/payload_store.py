"""Live payload stores: record id -> payload string.

Payload *durability* comes from the WAL + snapshots (the payload travels
inside every insert frame and in ``payloads.bin``); these stores are the
LIVE view that serves ``get()`` and search hits. Two implementations:

- ``MemoryPayloadStore`` (default): a dict. Fastest lookups; RAM grows with
  the live set (~payload bytes + ~100 B/entry of dict overhead).
- ``DiskPayloadStore``: sqlite3-backed (stdlib, C B-tree), bounded RAM for
  10M+ records. It is a rebuildable cache: restore repopulates it from the
  snapshot + WAL tail, so sqlite durability is turned off entirely
  (journal/synchronous OFF) and a crash can never corrupt the source of
  truth.

Select with ``payload_store="memory" | "disk"`` on the collection config.
The reference's record model pairs every vector with a payload string
(the reference vRod's ``src/utils/embeddings.rs:61``); the reference never
stored them (Database is a stub), so the store design is vrod-tpu's own.
"""

from __future__ import annotations

import sqlite3
import threading
from pathlib import Path

# sqlite default host-parameter limit is 999 in older builds; stay under it
# for IN (...) batches.
_IN_BATCH = 900


class MemoryPayloadStore(dict):
    """Dict with the bulk helpers the collection hot paths use."""

    def set_many(self, ids, payloads) -> None:
        self.update(zip(ids, payloads))

    def delete_many(self, ids) -> None:
        for rid in ids:
            self.pop(rid, None)

    def get_many(self, ids) -> dict:
        return {rid: self[rid] for rid in ids if rid in self}

    def close(self) -> None:
        pass


class DiskPayloadStore:
    """sqlite3-backed payload view with bounded host memory.

    Thread-safe via an internal mutex (payload reads happen concurrently
    from searcher threads under the collection read lock). All pragmas
    favor speed over durability — the WAL/snapshot layer owns durability,
    and ``__init__`` truncates the table because restore repopulates it.
    """

    def __init__(self, path):
        self._path = Path(path)
        self._lock = threading.Lock()
        try:
            self._open()
        except sqlite3.DatabaseError:
            # With journal/synchronous OFF a crash can corrupt payloads.db
            # itself. The store is a rebuildable cache (restore repopulates
            # it from snapshot + WAL), so a corrupt file must never wedge
            # collection load: discard it and start fresh.
            try:
                self._conn.close()
            except Exception:
                pass
            self._path.unlink(missing_ok=True)
            # sqlite sidecar files from a corrupted crash state
            for suffix in ("-journal", "-wal", "-shm"):
                Path(str(self._path) + suffix).unlink(missing_ok=True)
            self._open()

    def _open(self) -> None:
        # Autocommit (isolation_level=None): with journal_mode=OFF an
        # implicit open transaction would make close()'s rollback undefined
        # behavior, and the held RESERVED lock would block other readers.
        self._conn = sqlite3.connect(str(self._path), check_same_thread=False,
                                     isolation_level=None)
        with self._lock:
            self._conn.execute("PRAGMA journal_mode=OFF")
            self._conn.execute("PRAGMA synchronous=OFF")
            self._conn.execute(
                "CREATE TABLE IF NOT EXISTS payload "
                "(id INTEGER PRIMARY KEY, p TEXT NOT NULL)")
            self._conn.execute("DELETE FROM payload")

    # -- dict-compatible surface (collection mutation paths) ---------------

    def __setitem__(self, rid: int, payload: str) -> None:
        with self._lock:
            self._conn.execute(
                "INSERT OR REPLACE INTO payload VALUES (?, ?)",
                (int(rid), payload))

    def get(self, rid: int, default: str = ""):
        with self._lock:
            row = self._conn.execute(
                "SELECT p FROM payload WHERE id = ?",
                (int(rid),)).fetchone()
        return default if row is None else row[0]

    def pop(self, rid: int, default=None):
        with self._lock:
            row = self._conn.execute(
                "SELECT p FROM payload WHERE id = ?",
                (int(rid),)).fetchone()
            self._conn.execute(
                "DELETE FROM payload WHERE id = ?", (int(rid),))
        return default if row is None else row[0]

    def __len__(self) -> int:
        with self._lock:
            (n,) = self._conn.execute(
                "SELECT COUNT(*) FROM payload").fetchone()
        return int(n)

    # -- bulk helpers -------------------------------------------------------

    def set_many(self, ids, payloads) -> None:
        with self._lock:
            self._conn.executemany(
                "INSERT OR REPLACE INTO payload VALUES (?, ?)",
                ((int(r), p) for r, p in zip(ids, payloads)))

    def delete_many(self, ids) -> None:
        with self._lock:
            self._conn.executemany(
                "DELETE FROM payload WHERE id = ?",
                ((int(r),) for r in ids))

    def get_many(self, ids) -> dict:
        """Payloads for the given ids (missing ids are absent from the
        result). Batched IN-queries, one mutex hold."""
        ids = [int(r) for r in ids]
        out: dict[int, str] = {}
        with self._lock:
            for start in range(0, len(ids), _IN_BATCH):
                chunk = ids[start:start + _IN_BATCH]
                q = ("SELECT id, p FROM payload WHERE id IN (%s)"
                     % ",".join("?" * len(chunk)))
                for rid, p in self._conn.execute(q, chunk):
                    out[int(rid)] = p
        return out

    def close(self) -> None:
        with self._lock:
            try:
                self._conn.close()
            except Exception:
                pass


def make_payload_store(kind: str, path):
    if kind == "disk":
        return DiskPayloadStore(path)
    return MemoryPayloadStore()
