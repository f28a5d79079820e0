"""Logical operation encoding for WAL frames.

Compact binary layout (little-endian) so BULKINSERT of 768-dim f32 vectors
costs ~3 KB/record with a single CRC per batch frame. One frame = one op.

Collection-level WAL ops: INSERT / BULK / DELETE / UPDATE / CHECKPOINT.
Database-level WAL ops: CREATE_COLLECTION / DROP_COLLECTION.
"""

from __future__ import annotations

import dataclasses
import json
import struct

import numpy as np

from ..errors import WalCorruptionError

OP_INSERT = 1
OP_DELETE = 2
OP_UPDATE = 3
OP_CREATE_COLLECTION = 4
OP_DROP_COLLECTION = 5
# op kind 6 is reserved (was an unused CHECKPOINT placeholder)
OP_BULK = 7
OP_BULK_DELETE = 8


@dataclasses.dataclass
class InsertOp:
    record_id: int
    vector: np.ndarray
    payload: str


@dataclasses.dataclass
class BulkOp:
    record_ids: np.ndarray  # uint64 (n,)
    vectors: np.ndarray     # float32 (n, dim)
    payloads: list[str]


@dataclasses.dataclass
class DeleteOp:
    record_id: int


@dataclasses.dataclass
class BulkDeleteOp:
    record_ids: np.ndarray  # uint64 (n,)


@dataclasses.dataclass
class UpdateOp:
    record_id: int
    vector: np.ndarray
    payload: str


@dataclasses.dataclass
class CreateCollectionOp:
    config_json: dict


@dataclasses.dataclass
class DropCollectionOp:
    name: str


def _pack_vec_payload(record_id: int, vector: np.ndarray, payload: str) -> bytes:
    vec = np.ascontiguousarray(vector, dtype=np.float32)
    pb = payload.encode("utf-8")
    return (struct.pack("<QI", record_id, vec.size) + vec.tobytes()
            + struct.pack("<I", len(pb)) + pb)


def _unpack_vec_payload(buf: bytes, off: int):
    record_id, dim = struct.unpack_from("<QI", buf, off)
    off += 12
    vec = np.frombuffer(buf, dtype=np.float32, count=dim, offset=off).copy()
    off += 4 * dim
    (plen,) = struct.unpack_from("<I", buf, off)
    off += 4
    payload = buf[off: off + plen].decode("utf-8")
    off += plen
    return record_id, vec, payload, off


def encode(op) -> bytes:
    if isinstance(op, InsertOp):
        return bytes([OP_INSERT]) + _pack_vec_payload(op.record_id, op.vector, op.payload)
    if isinstance(op, UpdateOp):
        return bytes([OP_UPDATE]) + _pack_vec_payload(op.record_id, op.vector, op.payload)
    if isinstance(op, DeleteOp):
        return bytes([OP_DELETE]) + struct.pack("<Q", op.record_id)
    if isinstance(op, BulkDeleteOp):
        ids = np.ascontiguousarray(op.record_ids, dtype=np.uint64)
        return (bytes([OP_BULK_DELETE]) + struct.pack("<Q", ids.size)
                + ids.tobytes())
    if isinstance(op, BulkOp):
        ids = np.ascontiguousarray(op.record_ids, dtype=np.uint64)
        vecs = np.ascontiguousarray(op.vectors, dtype=np.float32)
        n, dim = vecs.shape
        if ids.size != n or len(op.payloads) != n:
            # Not an assert: under python -O a mismatched batch would
            # silently encode an undecodable (but CRC-valid) frame.
            raise ValueError(
                f"BulkOp shape mismatch: {ids.size} ids, {n} vectors, "
                f"{len(op.payloads)} payloads")
        payload_blob = b"".join(
            struct.pack("<I", len(pb)) + pb
            for pb in (p.encode("utf-8") for p in op.payloads)
        )
        return (bytes([OP_BULK]) + struct.pack("<QI", n, dim)
                + ids.tobytes() + vecs.tobytes() + payload_blob)
    if isinstance(op, CreateCollectionOp):
        return bytes([OP_CREATE_COLLECTION]) + json.dumps(op.config_json).encode()
    if isinstance(op, DropCollectionOp):
        return bytes([OP_DROP_COLLECTION]) + op.name.encode("utf-8")
    raise TypeError(f"Unknown WAL op {type(op)}")


def decode_effect(buf: bytes):
    """Cheap id-level summary of a collection frame WITHOUT materializing
    vectors/payloads: returns ("insert"|"delete", uint64 ids array), or
    None for ops with no id effect. Host-only counting (LISTCOLLECTIONS on
    a cold collection) replays multi-GB BULK frames; full decode() copies
    every vector just to read the ids."""
    if not buf:
        raise WalCorruptionError("Empty WAL frame")
    kind = buf[0]
    if kind in (OP_INSERT, OP_UPDATE):
        (record_id,) = struct.unpack_from("<Q", buf, 1)
        return "insert", np.array([record_id], dtype=np.uint64)
    if kind == OP_DELETE:
        (record_id,) = struct.unpack_from("<Q", buf, 1)
        return "delete", np.array([record_id], dtype=np.uint64)
    if kind == OP_BULK_DELETE:
        (n,) = struct.unpack_from("<Q", buf, 1)
        return "delete", np.frombuffer(buf, np.uint64, count=n, offset=9)
    if kind == OP_BULK:
        n, _dim = struct.unpack_from("<QI", buf, 1)
        return "insert", np.frombuffer(buf, np.uint64, count=n, offset=13)
    return None


def decode(buf: bytes):
    if not buf:
        raise WalCorruptionError("Empty WAL frame")
    kind = buf[0]
    if kind in (OP_INSERT, OP_UPDATE):
        record_id, vec, payload, _ = _unpack_vec_payload(buf, 1)
        cls = InsertOp if kind == OP_INSERT else UpdateOp
        return cls(record_id=record_id, vector=vec, payload=payload)
    if kind == OP_DELETE:
        (record_id,) = struct.unpack_from("<Q", buf, 1)
        return DeleteOp(record_id=record_id)
    if kind == OP_BULK_DELETE:
        (n,) = struct.unpack_from("<Q", buf, 1)
        ids = np.frombuffer(buf, dtype=np.uint64, count=n, offset=9).copy()
        return BulkDeleteOp(record_ids=ids)
    if kind == OP_BULK:
        n, dim = struct.unpack_from("<QI", buf, 1)
        off = 13
        ids = np.frombuffer(buf, dtype=np.uint64, count=n, offset=off).copy()
        off += 8 * n
        vecs = np.frombuffer(buf, dtype=np.float32, count=n * dim, offset=off)
        vecs = vecs.reshape(n, dim).copy()
        off += 4 * n * dim
        payloads = []
        for _ in range(n):
            (plen,) = struct.unpack_from("<I", buf, off)
            off += 4
            payloads.append(buf[off: off + plen].decode("utf-8"))
            off += plen
        return BulkOp(record_ids=ids, vectors=vecs, payloads=payloads)
    if kind == OP_CREATE_COLLECTION:
        return CreateCollectionOp(config_json=json.loads(buf[1:].decode()))
    if kind == OP_DROP_COLLECTION:
        return DropCollectionOp(name=buf[1:].decode("utf-8"))
    raise WalCorruptionError(f"Unknown WAL op kind {kind}")
