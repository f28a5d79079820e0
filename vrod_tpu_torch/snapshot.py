"""Streaming snapshot IO: bounded-memory writers/readers + durability helpers.

A snapshot directory holds:

    ids.npy        uint64 (n,)      record ids, ascending slot order at plan
    vectors.bin    stored-representation rows (f32/bf16/int8), raw
    aux.bin        float32 (n,)     per-row aux (inv-norm / |x|^2 / scale)
    payloads.bin   length-prefixed UTF-8 payloads, aligned with ids.npy order
    meta.json      next_id, count, last_lsn, storage dtype/dim, crc32 per
                   file, meta_crc (self-checksum of the other meta fields)

(Round-1 snapshots used vectors.npy + payloads.json; restore still reads
them, new snapshots always write the layout above.)

Writers stream chunks so a 10M x 768 snapshot never materializes a multi-GB
host array; CRCs are computed incrementally over the full file bytes, and
verification reads files back in bounded chunks. Realizes the reference's
intended checkpoint/resume subsystem (``vr_wal`` + ``Database::load`` todo,
the reference vRod's ``src/database/mod.rs:19-21``) at production scale.
"""

from __future__ import annotations

import os
import struct
import zlib
from pathlib import Path

import numpy as np

PAYLOAD_MAGIC = b"VRPL\x01"
CRC_CHUNK = 4 << 20


def fsync_path(path) -> None:
    """fsync a file OR directory by path (one shared idiom — portability
    and error-handling fixes belong in exactly one place)."""
    fd = os.open(str(path), os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


fsync_file = fsync_path
fsync_dir = fsync_path


def crc32_of_file(path, chunk: int = CRC_CHUNK) -> int:
    c = 0
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            c = zlib.crc32(b, c)
    return c & 0xFFFFFFFF


def meta_self_crc(meta: dict) -> int:
    """Self-checksum of a snapshot ``meta.json`` dict: crc32 of the
    canonical (sorted-key, compact) JSON serialization of every field
    except ``meta_crc`` itself. The per-file crc32 map inside meta
    protects the data files; this protects meta's OWN semantic fields,
    which restore keys on. Writers stamp it; ``Collection._pick_snapshot``
    and ``verify_image`` recompute it (absent = legacy snapshot,
    accepted)."""
    import json
    body = {k: v for k, v in meta.items() if k != "meta_crc"}
    s = json.dumps(body, sort_keys=True, separators=(",", ":"))
    return zlib.crc32(s.encode()) & 0xFFFFFFFF


def copy_file_prefix(src, dest, nbytes: int, chunk: int = CRC_CHUNK) -> int:
    """Copy the first ``nbytes`` of ``src`` to ``dest`` (chunked, fsynced).
    Used by backup/replication to capture exactly the durable WAL prefix —
    bytes appended to ``src`` after the capture point must not leak into
    the copy. Returns the bytes written; raises on a short source."""
    written = 0
    with open(src, "rb") as sf, open(dest, "wb") as df:
        while written < nbytes:
            b = sf.read(min(chunk, nbytes - written))
            if not b:
                raise OSError(
                    f"Short read copying {src}: wanted {nbytes} bytes, "
                    f"got {written}")
            df.write(b)
            written += len(b)
        df.flush()
        os.fsync(df.fileno())
    return written


def link_or_copy(src, dest) -> None:
    """Hardlink ``src`` to ``dest``; fall back to a byte copy when the
    link crosses filesystems (EXDEV) or the filesystem lacks hardlinks.
    Callers use this to pin immutable snapshot files (a concurrent
    snapshot swap unlinks names, never rewrites bytes in place, so a
    hardlink preserves the pinned content at zero copy cost)."""
    import shutil
    try:
        os.link(str(src), str(dest))
    except OSError:
        shutil.copy2(str(src), str(dest))


class _CrcWriter:
    """File writer that folds every byte into a running crc32 and fsyncs on
    close (snapshot files must be durable before the WAL is truncated).
    Context-manager support aborts cleanly on error (close without fsync),
    so a failed snapshot attempt does not leak fds — the auto-maintenance
    thread retries after every later mutation, so leaks would accumulate."""

    def __init__(self, path):
        self.path = Path(path)
        self._f = open(path, "wb")
        self.crc = 0

    def write(self, b: bytes) -> None:
        self.crc = zlib.crc32(b, self.crc)
        self._f.write(b)

    def close(self) -> int:
        self._f.flush()
        os.fsync(self._f.fileno())
        self._f.close()
        return self.crc & 0xFFFFFFFF

    def abort(self) -> None:
        try:
            self._f.close()
        except Exception:
            pass


def storage_dtype(name: str) -> np.dtype:
    """numpy dtype for a collection storage dtype name (bfloat16 travels as
    its raw 16-bit words, uint16, so numpy needs no bfloat16 type and the
    bytes on disk are the same; int4 rows live as packed int8 bytes — see
    ``storage_row_elems``)."""
    if name == "bfloat16":
        return np.dtype(np.uint16)
    if name == "int4":
        return np.dtype(np.int8)
    return np.dtype(name)


def storage_row_elems(name: str, dim: int) -> int:
    """Stored elements per row for a logical dim: int4 packs two dims per
    int8 byte (distances.pack_int4), every other dtype stores dim
    elements."""
    return dim // 2 if name == "int4" else dim


class RawStreamWriter:
    """Stream a flat array of a known dtype in row chunks (used for the
    stored-representation vectors: bf16/int8 rows round-trip bit-exactly
    and snapshots shrink 2-4x vs the legacy f32 layout)."""

    def __init__(self, path):
        self._w = _CrcWriter(path)

    def write_rows(self, arr: np.ndarray) -> None:
        self._w.write(np.ascontiguousarray(arr).tobytes())

    def close(self) -> int:
        return self._w.close()

    def abort(self) -> None:
        self._w.abort()


def read_raw_rows(path, dtype, row_elems: int, chunk_rows: int = 65536):
    """Yield (chunk_rows, row_elems) arrays of ``dtype`` from a raw file."""
    dt = storage_dtype(dtype) if isinstance(dtype, str) else np.dtype(dtype)
    row_bytes = dt.itemsize * row_elems
    with open(path, "rb") as f:
        while True:
            buf = f.read(row_bytes * chunk_rows)
            if not buf:
                break
            arr = np.frombuffer(buf, dtype=dt)
            yield arr.reshape(-1, row_elems) if row_elems > 1 else arr


class PayloadStreamWriter:
    """Length-prefixed payload stream, order-aligned with ids.npy."""

    def __init__(self, path, count: int):
        self._w = _CrcWriter(path)
        self._w.write(PAYLOAD_MAGIC + struct.pack("<Q", count))
        self._count = count
        self._written = 0

    def write_many(self, payloads) -> None:
        parts = []
        n = 0  # count in-loop: len() after consuming would raise on a
        for p in payloads:  # generator AFTER its bytes were written
            pb = p.encode("utf-8")
            parts.append(struct.pack("<I", len(pb)))
            parts.append(pb)
            n += 1
        self._w.write(b"".join(parts))
        self._written += n

    def close(self) -> int:
        if self._written != self._count:
            # Explicit raise, not assert: under python -O a short stream
            # would get a valid CRC recorded and only fail at restore —
            # after the covering WAL prefix was already truncated.
            raise ValueError(
                f"Payload stream wrote {self._written} records, header "
                f"promised {self._count}")
        return self._w.close()

    def abort(self) -> None:
        self._w.abort()


def read_payloads(path, chunk_records: int = 65536,
                  read_chunk: int = 8 << 20):
    """Yield lists of payload strings in bounded chunks (buffered parse —
    no per-record reads, no whole-file materialization)."""
    with open(path, "rb") as f:
        head = f.read(len(PAYLOAD_MAGIC) + 8)
        if head[:len(PAYLOAD_MAGIC)] != PAYLOAD_MAGIC:
            raise ValueError(f"Bad payload stream magic in {path}")
        (count,) = struct.unpack_from("<Q", head, len(PAYLOAD_MAGIC))
        buf = b""
        off = 0
        out = []
        remaining = count
        while remaining > 0:
            if len(buf) - off < 4:
                buf = buf[off:] + f.read(read_chunk)
                off = 0
                if len(buf) < 4:
                    raise ValueError(f"Truncated payload stream {path}")
            (ln,) = struct.unpack_from("<I", buf, off)
            off += 4
            while len(buf) - off < ln:
                more = f.read(max(read_chunk, ln))
                if not more:
                    raise ValueError(f"Truncated payload stream {path}")
                buf = buf[off:] + more
                off = 0
            out.append(buf[off:off + ln].decode("utf-8"))
            off += ln
            remaining -= 1
            if len(out) >= chunk_records:
                yield out
                out = []
        if out:
            yield out
