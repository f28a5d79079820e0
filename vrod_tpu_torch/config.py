"""Configuration schemas for the database and collections.

The reference creates an *empty* ``vr_config`` file at DB init
(``src/database/setup.rs:19-20``) with a commented intent to "Look for config
file" on load (``src/main.rs:65``). Here ``vr_config`` is a real JSON document:
the DB-level file records the framework version and the collection registry;
each collection has its own ``vr_config`` recording the tensor schema the TPU
engine needs (dim, metric, dtype, segment geometry, shard count).
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any

from .errors import ConfigError

VROD_VERSION = "0.1.0"

METRICS = ("cosine", "l2", "dot")
# int4 is the capacity tier: rows quantize to 4-bit nibbles packed two per
# byte (half the HBM of int8 — ~2x the rows per chip), searched with the
# same exact-vs-stored-representation contract as int8.
DTYPES = ("float32", "bfloat16", "int8", "int4")

import re

_NAME_RE = re.compile(r"[A-Za-z0-9][A-Za-z0-9_.-]{0,127}")


def validate_name(name: str, what: str = "name") -> str:
    """Collection/database names become directory names; reject separators,
    traversal and other path metacharacters. ``fullmatch``, not match-with-$:
    '$' matches before a trailing newline, which would let 'name\\n' through
    and create an unaddressable directory."""
    if not isinstance(name, str) or not _NAME_RE.fullmatch(name) or ".." in name:
        raise ConfigError(
            f"Invalid {what} {name!r}: use letters, digits, '_', '-', '.' "
            f"(must start alphanumeric, max 128 chars)")
    return name

# File names inherited from the reference on-disk layout (setup.rs:17-23).
CONFIG_FILE = "vr_config"
WAL_FILE = "vr_wal"
COLLECTIONS_DIR = "collections"
SNAPSHOT_DIR = "snapshot"
# Extension: BACKUP stamps every image with a self-checksummed file list
# so verify_image can witness DELETED files (no per-file checksum can).
BACKUP_MANIFEST_FILE = "vr_backup_manifest.json"


@dataclasses.dataclass
class CollectionConfig:
    """Tensor schema + engine geometry for one collection."""

    name: str
    dim: int
    metric: str = "cosine"
    dtype: str = "float32"
    # Rows per HBM segment; capacity always grows in whole segments so device
    # buffers keep static, MXU-aligned shapes (multiples of 8/128 lanes).
    segment_rows: int = 65536
    # Number of mesh shards the collection's rows are split over (1 = single chip).
    shards: int = 1
    # Candidate margin for the exact-precision rescore stage: the fast scan
    # returns top-(k+margin), rescore at HIGHEST precision reorders and
    # trims to k. 16 covers the tiny ordering jitter of 1-pass bf16 scans;
    # raise for adversarially tight score distributions.
    # Extra candidates the fast scan keeps beyond k for the exact rescore.
    # Measured on TPU v5e at 1M x 768 (experiments/recall_margin.py):
    # fast-precision rank jitter never exceeded 4 positions for k <= 100 in
    # f32 or bf16, so 8 is a 2x safety factor; the engine also floors the
    # margin at k_out // 8 for large k.
    rescore_margin: int = 8
    # Auto-snapshot policy: when the collection WAL exceeds this many bytes
    # after a mutation, a background snapshot runs (non-blocking — searches
    # and mutations proceed) and truncates the covered WAL prefix. Bounds
    # restart replay time. 0 disables (snapshot/reindex remain manual).
    auto_snapshot_wal_bytes: int = 0
    # Live payload view: "memory" (dict; fastest) or "disk" (sqlite-backed;
    # bounded host RAM for 10M+ records). Durability is the WAL/snapshot
    # layer's either way — the disk store is a rebuildable cache.
    payload_store: str = "memory"
    # Auto-compact policy: when live_count falls below this fraction of
    # device capacity after a deletion (and capacity exceeds one grow
    # unit), a background REINDEX packs live rows, reclaims capacity (the
    # scan pays for capacity, not live rows) and snapshots. 0 disables.
    auto_compact_fraction: float = 0.0

    def __post_init__(self) -> None:
        validate_name(self.name, "collection name")
        if self.metric not in METRICS:
            raise ConfigError(f"Unknown metric {self.metric!r}; expected one of {METRICS}")
        if self.dtype not in DTYPES:
            raise ConfigError(f"Unknown dtype {self.dtype!r}; expected one of {DTYPES}")
        if self.dtype == "int8" and self.metric == "l2" and self.dim > 1040:
            # |q8|^2 <= dim * 127^2 must stay exactly representable in f32
            # (< 2^24) for the on-the-fly |x_hat|^2 epilogue to be exact.
            # (int4's bound is dim * 8^2 — no practical cap.)
            raise ConfigError(
                "int8 + l2 supports dim <= 1040 (exact f32 norm "
                "reconstruction); use bfloat16/float32 for larger dims")
        if self.dtype == "int4" and self.dim % 2 != 0:
            raise ConfigError(
                "int4 packs two dims per byte and needs an even dim; "
                f"got {self.dim}")
        if self.dim <= 0:
            raise ConfigError(f"dim must be positive, got {self.dim}")
        if self.segment_rows <= 0 or self.segment_rows % 8 != 0:
            raise ConfigError(
                "segment_rows must be a positive multiple of 8 "
                "(TPU sublane tile)")
        if self.shards < 1:
            raise ConfigError("shards must be >= 1")
        if self.auto_snapshot_wal_bytes < 0:
            raise ConfigError("auto_snapshot_wal_bytes must be >= 0")
        if self.payload_store not in ("memory", "disk"):
            raise ConfigError(
                f"Unknown payload_store {self.payload_store!r}; "
                "expected 'memory' or 'disk'")
        if not (0.0 <= self.auto_compact_fraction < 1.0):
            raise ConfigError(
                "auto_compact_fraction must be in [0, 1)")

    def to_json(self) -> dict[str, Any]:
        d = dataclasses.asdict(self)
        d["vrod_version"] = VROD_VERSION
        return d

    @classmethod
    def from_json(cls, d: dict[str, Any]) -> "CollectionConfig":
        d = dict(d)
        d.pop("vrod_version", None)
        try:
            return cls(**d)
        except TypeError as e:
            raise ConfigError(f"Bad collection config: {e}") from e


@dataclasses.dataclass
class DatabaseConfig:
    """DB-level ``vr_config`` contents."""

    name: str
    collections: list[str] = dataclasses.field(default_factory=list)

    def to_json(self) -> dict[str, Any]:
        return {
            "vrod_version": VROD_VERSION,
            "name": self.name,
            "collections": sorted(self.collections),
        }

    @classmethod
    def from_json(cls, d: dict[str, Any]) -> "DatabaseConfig":
        try:
            return cls(name=d["name"], collections=list(d.get("collections", [])))
        except KeyError as e:
            raise ConfigError(f"Bad database config: missing {e}") from e


def write_config(path: Path, payload: dict[str, Any]) -> None:
    """Atomic + durable: the config IS the tensor schema WAL replay needs,
    so the tmp file is fsynced before the rename (a rename alone can
    persist while the data blocks do not, leaving an empty vr_config)."""
    import os
    tmp = path.with_suffix(".tmp")
    with open(tmp, "w") as f:
        f.write(json.dumps(payload, indent=2, sort_keys=True) + "\n")
        f.flush()
        os.fsync(f.fileno())
    tmp.replace(path)
    try:
        dfd = os.open(str(path.parent), os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    except OSError:
        pass


def read_config(path: Path) -> dict[str, Any]:
    text = path.read_text()
    if not text.strip():
        # An empty vr_config is valid in the reference's on-disk format
        # (setup.rs:19-20 creates it empty); treat as an empty document.
        return {}
    try:
        return json.loads(text)
    except json.JSONDecodeError as e:
        raise ConfigError(f"Corrupt config file {path}: {e}") from e
