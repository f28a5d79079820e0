"""Write-ahead log: C++ fast path (via ctypes) + pure-Python fallback.

Both implementations share one on-disk frame format (see
``_native/native.cpp``), so a log written by either is replayable by the
other:

    u32 magic ("WL_1") | u64 lsn | u32 payload_len
    | u32 crc32(lsn || payload_len || payload) | payload

Replay stops at the first torn or CRC-corrupt frame — the durable prefix is
exactly the frames that were fully written before a crash. ``repair()``
truncates the torn tail. ``truncate()`` implements the reference's
TRUNCATEWAL command semantics (src/command/types.rs:44-54): drop all frames
(issued after a snapshot makes them redundant).
"""

from __future__ import annotations

import ctypes
import struct
import threading
import zlib
from pathlib import Path

from .._native.build import load_native
from ..errors import WalError

WAL_MAGIC = 0x315F4C57
_HEADER = struct.Struct("<IQII")  # magic, lsn, payload_len, crc
_CRC_FIELDS = struct.Struct("<QI")  # the header fields covered by the crc


def _frame_crc(lsn: int, payload: bytes) -> int:
    c = zlib.crc32(_CRC_FIELDS.pack(lsn, len(payload)))
    return zlib.crc32(payload, c) & 0xFFFFFFFF


def iter_valid_frames(path, chunk: int = 4 << 20):
    """Read-only CRC walk of a WAL file at ``path``: yields
    ``(lsn, end_offset)`` for each CRC-clean frame of the valid prefix,
    stopping at the first torn or corrupt byte. Payloads are CRC'd in
    ``chunk``-sized pieces (bounded memory on multi-GB logs) and never
    materialized. Unlike opening a :class:`Wal`, this NEVER writes — safe
    on a file another process owns (backup of a cold collection,
    offline image verification)."""
    path = Path(path)
    file_size = path.stat().st_size
    off = 0
    with open(path, "rb") as f:
        while off + _HEADER.size <= file_size:
            f.seek(off)
            hdr = f.read(_HEADER.size)
            if len(hdr) < _HEADER.size:
                return
            magic, lsn, plen, crc = _HEADER.unpack(hdr)
            if magic != WAL_MAGIC:
                return
            end = off + _HEADER.size + plen
            if end > file_size:
                return
            c = zlib.crc32(_CRC_FIELDS.pack(lsn, plen))
            remaining = plen
            while remaining > 0:
                piece = f.read(min(remaining, chunk))
                if not piece:
                    return
                c = zlib.crc32(piece, c)
                remaining -= len(piece)
            if (c & 0xFFFFFFFF) != crc:
                return
            yield lsn, end
            off = end


def valid_prefix_size(path) -> int:
    """Byte length of the CRC-valid frame prefix of the WAL at ``path``
    (0 for an empty or immediately-torn log). Read-only — the durable-
    prefix answer without opening (and possibly repairing) the log."""
    size = 0
    for _, end in iter_valid_frames(path):
        size = end
    return size


class _NativeWal:
    def __init__(self, path: Path):
        self._lib = load_native()
        if self._lib is None:
            raise WalError(
                "Native WAL requested but the C++ runtime is unavailable "
                "(no toolchain or VROD_DISABLE_NATIVE)")
        self._h = self._lib.vrod_wal_open(str(path).encode())
        if not self._h:
            raise WalError(f"Cannot open WAL at {path}")
        self.path = Path(path)

    def append(self, payload: bytes, sync: bool = False) -> int:
        buf = (ctypes.c_uint8 * len(payload)).from_buffer_copy(payload) if payload \
            else (ctypes.c_uint8 * 1)()
        lsn = self._lib.vrod_wal_append(self._h, buf, len(payload))
        if lsn == 0:
            raise WalError("WAL append failed")
        if sync:
            self.sync()
        return lsn

    def sync(self) -> None:
        if self._lib.vrod_wal_sync(self._h) != 0:
            raise WalError("WAL fsync failed")

    def truncate(self) -> None:
        if self._lib.vrod_wal_truncate(self._h) != 0:
            raise WalError("WAL truncate failed")

    def truncate_until(self, upto_lsn: int) -> None:
        """Drop frames with lsn <= upto_lsn; keep the concurrent tail."""
        if self._lib.vrod_wal_truncate_until(self._h, upto_lsn) != 0:
            raise WalError("WAL truncate_until failed")

    def rewind(self, size: int) -> None:
        """Undo appends past ``size`` (an op whose apply failed, never acked)."""
        if self._lib.vrod_wal_rewind(self._h, size) != 0:
            raise WalError("WAL rewind failed")

    def seed_lsn(self, last_lsn: int) -> None:
        self._lib.vrod_wal_seed_lsn(self._h, last_lsn)

    def set_next_lsn(self, next_lsn: int) -> None:
        """Force the next append's lsn (replication: frames carry the
        PRIMARY's lsn, including a retried lsn the monotonic counter
        already consumed for a rewound apply)."""
        if self._lib.vrod_wal_set_next_lsn(self._h, next_lsn) != 0:
            raise WalError(
                f"set_next_lsn({next_lsn}) would duplicate an existing lsn")

    def repair(self) -> None:
        if self._lib.vrod_wal_repair(self._h) != 0:
            raise WalError("WAL repair failed")

    @property
    def valid_size(self) -> int:
        return self._lib.vrod_wal_valid_size(self._h)

    @property
    def frame_count(self) -> int:
        return self._lib.vrod_wal_frame_count(self._h)

    @property
    def last_lsn(self) -> int:
        return self._lib.vrod_wal_last_lsn(self._h)

    @property
    def has_torn_tail(self) -> bool:
        return bool(self._lib.vrod_wal_has_torn_tail(self._h))

    def replay(self):
        """Yield (lsn, payload_bytes) for every valid frame, in order."""
        return self.replay_from(0)

    def replay_from(self, after_lsn: int):
        """Yield (lsn, payload_bytes) for frames with lsn > ``after_lsn``.
        Binary search on the (strictly increasing) lsn index, so a caught-up
        replication poll costs O(log n) lsn peeks — never a payload copy."""
        n = self.frame_count
        lo, hi = 0, n
        while lo < hi:
            mid = (lo + hi) // 2
            if self._lib.vrod_wal_frame_lsn(self._h, mid) <= after_lsn:
                lo = mid + 1
            else:
                hi = mid
        for i in range(lo, n):
            ln = self._lib.vrod_wal_frame_len(self._h, i)
            buf = (ctypes.c_uint8 * max(int(ln), 1))()
            got = self._lib.vrod_wal_frame_read(self._h, i, buf, ln)
            if got < 0:
                raise WalError(f"WAL frame read failed at index {i} (rc={got})")
            yield self._lib.vrod_wal_frame_lsn(self._h, i), bytes(buf[: int(ln)])

    def close(self) -> None:
        if self._h:
            self._lib.vrod_wal_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class _PyWal:
    """Pure-Python WAL, format-compatible with the native one."""

    def __init__(self, path: Path):
        self.path = Path(path)
        # A leftover .tmp from a crashed truncate_until rewrite is garbage.
        tmp = self.path.with_name(self.path.name + ".tmp")
        if tmp.exists():
            tmp.unlink()
        # r+b (not a+b): append mode would force every write to EOF, making
        # it impossible to overwrite a torn tail at valid_size.
        if not self.path.exists():
            self.path.touch()
        self._f = open(path, "r+b")
        self._index: list[tuple[int, int, int]] = []  # (lsn, payload_off, len)
        self._valid_size = 0
        self._next_lsn = 1
        self._scan()

    def _scan(self) -> None:
        """Streaming scan: per-frame header read + chunked CRC, bounded
        memory like the native wal_scan (a one-shot read() loaded multi-GB
        logs wholesale — and truncate_until's carefully chunked rewrite
        would immediately re-read its own output in one allocation)."""
        self._index.clear()
        self._valid_size = 0
        self._next_lsn = 1
        self._f.seek(0, 2)
        file_size = self._f.tell()
        off = 0
        while off + _HEADER.size <= file_size:
            self._f.seek(off)
            hdr = self._f.read(_HEADER.size)
            if len(hdr) < _HEADER.size:
                break
            magic, lsn, plen, crc = _HEADER.unpack(hdr)
            if magic != WAL_MAGIC:
                break
            end = off + _HEADER.size + plen
            if end > file_size:
                break
            c = zlib.crc32(_CRC_FIELDS.pack(lsn, plen))
            remaining = plen
            while remaining > 0:
                chunk = self._f.read(min(remaining, 1 << 20))
                if not chunk:
                    break
                c = zlib.crc32(chunk, c)
                remaining -= len(chunk)
            if remaining > 0 or (c & 0xFFFFFFFF) != crc:
                break
            self._index.append((lsn, off + _HEADER.size, plen))
            off = end
            self._valid_size = off
            self._next_lsn = lsn + 1
        self._file_size = file_size

    def append(self, payload: bytes, sync: bool = False) -> int:
        lsn = self._next_lsn
        crc = _frame_crc(lsn, payload)
        frame = _HEADER.pack(WAL_MAGIC, lsn, len(payload), crc) + payload
        self._f.seek(self._valid_size)
        self._f.write(frame)
        self._f.flush()
        self._index.append((lsn, self._valid_size + _HEADER.size, len(payload)))
        self._valid_size += len(frame)
        self._file_size = max(self._file_size, self._valid_size)
        self._next_lsn = lsn + 1
        if sync:
            self.sync()
        return lsn

    def sync(self) -> None:
        self._f.flush()
        import os
        os.fsync(self._f.fileno())

    def truncate(self) -> None:
        self._f.truncate(0)
        self.sync()
        self._index.clear()
        self._valid_size = 0
        self._file_size = 0

    def truncate_until(self, upto_lsn: int) -> None:
        """Drop frames with lsn <= upto_lsn; keep the concurrent tail.
        Crash-safe: survivors go to a temp file renamed over the log."""
        import os
        first_kept = 0
        while (first_kept < len(self._index)
               and self._index[first_kept][0] <= upto_lsn):
            first_kept += 1
        if first_kept == 0:
            return
        if first_kept == len(self._index):
            self.truncate()
            return
        start = self._index[first_kept][1] - _HEADER.size
        tmp = self.path.with_name(self.path.name + ".tmp")
        with open(tmp, "wb") as tf:
            # Chunked copy (bounded memory, matching the native path): the
            # surviving tail can be multi-GB after a busy snapshot window.
            self._f.seek(start)
            remaining = self._valid_size - start
            while remaining > 0:
                chunk = self._f.read(min(remaining, 1 << 20))
                if not chunk:
                    raise WalError("Short read while rewriting WAL tail")
                tf.write(chunk)
                remaining -= len(chunk)
            tf.flush()
            os.fsync(tf.fileno())
        saved_next = self._next_lsn
        self._f.close()
        os.replace(tmp, self.path)
        from ..snapshot import fsync_path  # one shared fsync idiom
        fsync_path(self.path.parent)
        self._f = open(self.path, "r+b")
        self._scan()
        self._next_lsn = max(self._next_lsn, saved_next)

    def rewind(self, size: int) -> None:
        """Undo appends past ``size``; next_lsn stays monotonic. ``size``
        must be a frame boundary — a mid-frame truncation would leave an
        index entry whose payload reads short on replay."""
        if size > self._valid_size:
            raise WalError("rewind past valid size")
        if size not in (0, self._valid_size) and not any(
                off - _HEADER.size == size for _, off, _ln in self._index):
            raise WalError(f"rewind target {size} is not a frame boundary")
        self._f.truncate(size)
        self.sync()
        while self._index and self._index[-1][1] - _HEADER.size >= size:
            self._index.pop()
        self._valid_size = size
        self._file_size = size

    def seed_lsn(self, last_lsn: int) -> None:
        self._next_lsn = max(self._next_lsn, last_lsn + 1)

    def set_next_lsn(self, next_lsn: int) -> None:
        """See _NativeWal.set_next_lsn (bit-compatible contract)."""
        if self._index and next_lsn <= self._index[-1][0]:
            raise WalError(
                f"set_next_lsn({next_lsn}) would duplicate an existing lsn")
        self._next_lsn = next_lsn

    def repair(self) -> None:
        self._f.truncate(self._valid_size)
        self.sync()
        self._file_size = self._valid_size

    @property
    def valid_size(self) -> int:
        return self._valid_size

    @property
    def frame_count(self) -> int:
        return len(self._index)

    @property
    def last_lsn(self) -> int:
        return self._index[-1][0] if self._index else 0

    @property
    def has_torn_tail(self) -> bool:
        import os
        return os.fstat(self._f.fileno()).st_size > self._valid_size

    def replay(self):
        return self.replay_from(0)

    def replay_from(self, after_lsn: int):
        """See _NativeWal.replay_from (same contract)."""
        import bisect
        start = bisect.bisect_right(self._index, after_lsn,
                                    key=lambda e: e[0])
        for lsn, off, plen in self._index[start:]:
            self._f.seek(off)
            yield lsn, self._f.read(plen)

    def close(self) -> None:
        if self._f:
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class GroupCommit:
    """Shared-fsync commit protocol: concurrent writers append (under the
    collection's write lock), then call ``sync_upto(lsn)`` before acking.
    One writer becomes the leader and issues a single fsync that covers
    every append completed before it started; the rest just wait. Turns
    N concurrent inserts into ~1 fsync instead of N (the mutation-side
    analogue of the query batcher)."""

    def __init__(self, wal):
        self._wal = wal
        self._cv = threading.Condition()
        self._synced = 0       # highest lsn known durable
        self._pending = 0      # highest lsn anyone asked to make durable
        self._leader = False

    def exclusive(self):
        """Lock out leader fsyncs while the WAL's fd is being swapped
        (truncate/truncate_until rewrite the file)."""
        return _GroupCommitExclusive(self)

    def sync_upto(self, lsn: int) -> None:
        with self._cv:
            self._pending = max(self._pending, lsn)
            while self._synced < lsn:
                if not self._leader:
                    self._leader = True
                    target = self._pending
                    break
                self._cv.wait()
            else:
                return
        try:
            self._wal.sync()
        except BaseException:
            with self._cv:
                self._leader = False
                self._cv.notify_all()  # someone else retries / re-raises
            raise
        with self._cv:
            self._leader = False
            self._synced = max(self._synced, target)
            self._cv.notify_all()

    def mark_synced(self) -> None:
        """Record that the WAL was fsynced externally (e.g. snapshot cut)."""
        with self._cv:
            self._synced = max(self._synced, self._pending,
                               self._wal.last_lsn)
            self._cv.notify_all()


class _GroupCommitExclusive:
    def __init__(self, gc: GroupCommit):
        self._gc = gc

    def __enter__(self):
        cv = self._gc._cv
        # `with cv:` (not manual acquire/release): an exception out of
        # cv.wait() — e.g. KeyboardInterrupt — must release the lock, or
        # every future WAL sync deadlocks on it.
        with cv:
            while self._gc._leader:  # wait out an in-flight fsync
                cv.wait()
            self._gc._leader = True  # block new leaders; we hold no fsync
        return self

    def __exit__(self, *exc):
        cv = self._gc._cv
        with cv:
            self._gc._leader = False
            cv.notify_all()


def Wal(path, native: bool | None = None):
    """Open (creating if absent) the WAL at ``path``.

    ``native=None`` auto-selects: C++ when the toolchain built, else Python.
    """
    if native is None:
        native = load_native() is not None
    if native:
        return _NativeWal(Path(path))
    return _PyWal(Path(path))
