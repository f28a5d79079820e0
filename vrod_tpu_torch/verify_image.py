"""Offline integrity verification of a backup image (or any quiesced DB dir).

Extension capability (no reference counterpart; the reference's durability
layer is an unimplemented stub — the reference vRod's ``src/command/types.rs``):
``BACKUP`` produces a point-in-time image, and this module re-walks every
checksum in that image WITHOUT restoring it — no device arrays, no engine,
no WAL repair, nothing is written. It answers "would ``Database.load``
accept this image, and are its bytes the ones the backup wrote?"

Checks performed:

- ``vr_backup_manifest.json`` (stamped by BACKUP, self-checksummed):
  every file the backup wrote still exists with its recorded size — the
  only check that can witness DELETED files (e.g. a lost snapshot
  directory, which per-file checksums cannot see because the bytes are
  simply gone). Absent manifest (pre-manifest image / live dir) is a
  warning and makes the delete-shaped ambiguities below conservative.
- ``vr_config`` parses and every listed collection has a directory
  (extra, unlisted directories are warnings — load ignores them).
- The DB-level WAL's frame prefix is CRC-clean with strictly increasing
  LSNs (read-only scan; a torn tail in an image is an error — backups copy
  only the valid prefix, so torn bytes mean the image was not produced by
  BACKUP or was itself truncated mid-copy).
- Per collection: the config parses; the newest snapshot directory whose
  ``meta.json`` validates (committed, else ``.old``, else ``.tmp`` — the
  same precedence restore uses) has every file's crc32 re-computed and
  matched, plus structural consistency (ids count == meta count, vectors/
  aux byte sizes match count x dim x storage dtype, payload stream header
  count matches); the collection WAL scans clean; and the WAL connects to
  the snapshot cut (first frame LSN <= snapshot last_lsn + 1 — a gap means
  mutations between the snapshot and the WAL are missing).

The walk is streaming (bounded memory) and safe to run on multi-GB images.
Intended for offline images: files must be static for the duration (verify
a LIVE database via ``BACKUP`` first, then verify the image). Note that
``Database.load`` MUTATES the directory it opens (DB-WAL recovery
truncation, payload-cache rebuild, lock file) — restore-test a COPY of the
image, or verify before any load, or the manifest size checks will rightly
report the load's own writes as drift.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path

from .config import (BACKUP_MANIFEST_FILE, COLLECTIONS_DIR, CONFIG_FILE,
                     SNAPSHOT_DIR, WAL_FILE, CollectionConfig,
                     DatabaseConfig)
from .snapshot import crc32_of_file as _crc32_of_file
from .wal.wal import iter_valid_frames


class ImageReport:
    """Mutable accumulator; ``to_dict()`` is the stable result shape."""

    def __init__(self) -> None:
        self.collections = 0
        self.snapshot_files = 0
        self.snapshot_bytes = 0
        self.wal_frames = 0
        self.wal_bytes = 0
        self.errors: list[str] = []
        self.warnings: list[str] = []

    @property
    def ok(self) -> bool:
        return not self.errors

    def error(self, msg: str) -> None:
        self.errors.append(msg)

    def warn(self, msg: str) -> None:
        self.warnings.append(msg)

    def to_dict(self) -> dict:
        return {
            "ok": self.ok,
            "collections": self.collections,
            "snapshot_files": self.snapshot_files,
            "snapshot_bytes": self.snapshot_bytes,
            "wal_frames": self.wal_frames,
            "wal_bytes": self.wal_bytes,
            "errors": list(self.errors),
            "warnings": list(self.warnings),
        }


def _scan_wal(path: Path, rep: ImageReport, label: str):
    """Read-only CRC walk of a WAL file (the same frame walk replay uses —
    ``wal.iter_valid_frames``). Returns (frames, first_lsn, last_lsn,
    valid_bytes); reports torn/corrupt tails as errors (an image holds
    only BACKUP-copied valid prefixes — trailing garbage means the image
    itself is damaged, unlike a live log where a torn tail is a normal
    crash artifact that repair() trims). LSN *holes* between clean frames
    are only warnings: the primary rewinds failed, never-acked ops, which
    legally leaves holes in the sequence (``Collection.replica_apply``
    documents the same rule) — but a strictly NON-increasing LSN cannot
    come from any legal writer and stays an error."""
    frames = 0
    first_lsn = last_lsn = 0
    off = 0
    file_size = path.stat().st_size
    for lsn, end in iter_valid_frames(path):
        if frames and lsn <= last_lsn:
            rep.error(f"{label}: LSN not increasing at offset {off} "
                      f"({last_lsn} -> {lsn})")
            return frames, first_lsn, last_lsn, off
        if frames and lsn != last_lsn + 1:
            rep.warn(f"{label}: LSN hole at offset {off} "
                     f"({last_lsn} -> {lsn}) — a rewound never-acked op "
                     f"(legal) or an excised frame (investigate if no "
                     f"apply ever failed here)")
        if not frames:
            first_lsn = lsn
        last_lsn = lsn
        frames += 1
        off = end
    if off != file_size:
        rep.error(f"{label}: {file_size - off} bytes of torn/corrupt tail "
                  f"after {frames} valid frames (a BACKUP image copies only "
                  f"the valid prefix — this image is damaged)")
    return frames, first_lsn, last_lsn, off


def _pick_snapshot(cdir: Path, rep: ImageReport, label: str):
    """Newest snapshot dir whose meta parses — SAME precedence as restore
    (``Collection._pick_snapshot``) so the verifier validates the dir that
    a load would actually use. Unlike restore, a CRC mismatch in the chosen
    dir is reported as an error here rather than silently falling through:
    the point of verification is to surface damaged bytes."""
    for name in (SNAPSHOT_DIR, SNAPSHOT_DIR + ".old", SNAPSHOT_DIR + ".tmp"):
        d = cdir / name
        meta_p = d / "meta.json"
        if not meta_p.exists():
            if name == SNAPSHOT_DIR and d.is_dir():
                # A COMMITTED snapshot dir always has meta.json (it is
                # written and fsynced before the dir is swapped in); only
                # .old/.tmp may legally lack one (crash mid-write).
                rep.error(f"{label}: {name}/ exists without meta.json")
            continue
        try:
            meta = json.loads(meta_p.read_text())
        except (OSError, ValueError) as e:
            rep.error(f"{label}: {name}/meta.json unreadable: {e}")
            continue
        from .snapshot import meta_self_crc
        if "meta_crc" not in meta:
            rep.warn(f"{label}: {name}/meta.json has no self-checksum "
                     f"(legacy snapshot; semantic fields unverifiable)")
        elif int(meta["meta_crc"]) != meta_self_crc(meta):
            # Restore would skip this dir (same check) and fall back or
            # fail — either way the image is not what BACKUP wrote.
            rep.error(f"{label}: {name}/meta.json self-checksum mismatch "
                      f"(a semantic field was altered)")
            continue
        return d, meta, name
    return None, None, None


def _verify_snapshot(d: Path, meta: dict, name: str, cfg, rep: ImageReport,
                     label: str) -> None:
    import numpy as np
    from .snapshot import PAYLOAD_MAGIC, storage_dtype, storage_row_elems

    checksums = meta.get("crc32", {})
    if not checksums:
        rep.error(f"{label}: {name}/meta.json has no crc32 map")
        return
    for fname, expect in sorted(checksums.items()):
        p = d / fname
        if "/" in fname or "\\" in fname or fname in ("", ".", ".."):
            rep.error(f"{label}: {name} meta names unsafe file {fname!r}")
            continue
        if not p.exists():
            rep.error(f"{label}: {name}/{fname} missing")
            continue
        got = _crc32_of_file(p)
        if got != int(expect):
            rep.error(f"{label}: {name}/{fname} crc32 {got:#010x} != "
                      f"recorded {int(expect):#010x}")
            continue
        rep.snapshot_files += 1
        rep.snapshot_bytes += p.stat().st_size

    # Structural consistency (cheap; catches a snapshot whose files all
    # match their CRCs but were recorded against a wrong count/dim).
    count = int(meta.get("count", -1))
    if count < 0:
        rep.error(f"{label}: {name}/meta.json missing count")
        return
    storage = meta.get("storage", {})
    dim = int(storage.get("dim", cfg.dim if cfg else 0))
    dt = str(storage.get("dtype", cfg.dtype if cfg else "float32"))
    try:
        itemsize = storage_dtype(dt).itemsize
    except Exception as e:
        rep.error(f"{label}: {name} has unknown storage dtype {dt!r}: {e}")
        return
    expected = {
        # int4 packs two dims per stored byte (storage_row_elems).
        "vectors.bin": count * storage_row_elems(dt, dim) * itemsize,
        "aux.bin": count * 4,  # f32 scalar lane per row
    }
    for fname, want in expected.items():
        p = d / fname
        if p.exists() and p.stat().st_size != want:
            rep.error(f"{label}: {name}/{fname} is {p.stat().st_size} B, "
                      f"expected {want} (count {count} x dim {dim} x "
                      f"{dt})")
    ids_p = d / "ids.npy"
    if ids_p.exists():
        try:
            ids = np.load(ids_p, mmap_mode="r")
            if ids.shape[0] != count:
                rep.error(f"{label}: {name}/ids.npy holds {ids.shape[0]} "
                          f"ids, meta says {count}")
        except Exception as e:
            rep.error(f"{label}: {name}/ids.npy unreadable: {e}")
    pay_p = d / "payloads.bin"
    if pay_p.exists():
        with open(pay_p, "rb") as f:
            head = f.read(len(PAYLOAD_MAGIC) + 8)
        if head[:len(PAYLOAD_MAGIC)] != PAYLOAD_MAGIC:
            rep.error(f"{label}: {name}/payloads.bin bad magic")
        elif len(head) < len(PAYLOAD_MAGIC) + 8:
            # Magic intact but the count field is torn off: a truncated
            # file must become a report error, never a struct.error out of
            # verify_image (its contract is "never raises for content").
            rep.error(f"{label}: {name}/payloads.bin truncated inside the "
                      f"header ({len(head)} B)")
        else:
            (pcount,) = struct.unpack_from("<Q", head, len(PAYLOAD_MAGIC))
            if pcount != count:
                rep.error(f"{label}: {name}/payloads.bin header says "
                          f"{pcount} records, meta says {count}")


def _verify_manifest(root: Path, rep: ImageReport) -> bool:
    """Validate the BACKUP image manifest (file list + sizes, self-
    checksummed): every listed file must exist with its recorded size —
    the ONLY check that can witness a deleted file or directory, since a
    missing file leaves no bytes for any per-file checksum to fail on.
    Returns True when a valid manifest vouched for the image's file set
    (unknown EXTRA files are warnings — load ignores them). Images from
    before the manifest existed, or bare quiesced DB dirs, return False:
    callers must then treat delete-shaped ambiguities conservatively."""
    man_p = root / BACKUP_MANIFEST_FILE
    if not man_p.exists():
        rep.warn(f"no {BACKUP_MANIFEST_FILE} (pre-manifest image or live "
                 f"DB dir): deleted files cannot be detected")
        return False
    try:
        man = json.loads(man_p.read_text())
    except (OSError, ValueError) as e:
        rep.error(f"{BACKUP_MANIFEST_FILE} unreadable: {e}")
        return False
    from .snapshot import meta_self_crc
    if ("meta_crc" not in man
            or int(man["meta_crc"]) != meta_self_crc(man)):
        rep.error(f"{BACKUP_MANIFEST_FILE} self-checksum mismatch")
        return False
    files = man.get("files")
    if not isinstance(files, dict):
        rep.error(f"{BACKUP_MANIFEST_FILE} has no files map")
        return False
    listed = set()
    for rel in sorted(files):
        parts = Path(rel).parts
        if Path(rel).is_absolute() or ".." in parts or not parts:
            rep.error(f"{BACKUP_MANIFEST_FILE} lists unsafe path {rel!r}")
            continue
        listed.add(rel)
        p = root / rel
        if not p.is_file():
            rep.error(f"{rel} is in the backup manifest but missing from "
                      f"the image (deleted file/directory)")
        elif p.stat().st_size != int(files[rel]):
            rep.error(f"{rel} is {p.stat().st_size} B, backup manifest "
                      f"recorded {int(files[rel])}")
    for p in sorted(root.rglob("*")):
        if not p.is_file():
            continue
        rel = p.relative_to(root).as_posix()
        if rel != BACKUP_MANIFEST_FILE and rel not in listed:
            rep.warn(f"{rel} is not in the backup manifest (added after "
                     f"the backup; load ignores unknown files)")
    return True


def _verify_collection(cdir: Path, rep: ImageReport,
                       manifested: bool) -> None:
    label = f"collections/{cdir.name}"
    cfg = None
    cfg_p = cdir / CONFIG_FILE
    if not cfg_p.exists():
        rep.error(f"{label}: missing {CONFIG_FILE}")
    else:
        try:
            cfg = CollectionConfig.from_json(json.loads(cfg_p.read_text()))
            if cfg.name != cdir.name:
                rep.error(f"{label}: config names {cfg.name!r}")
        except Exception as e:
            rep.error(f"{label}: config unreadable: {e}")

    snap_dir, meta, snap_name = _pick_snapshot(cdir, rep, label)
    if snap_dir is not None:
        _verify_snapshot(snap_dir, meta, snap_name, cfg, rep, label)
        if snap_name != SNAPSHOT_DIR and (cdir / SNAPSHOT_DIR).exists():
            rep.warn(f"{label}: committed snapshot dir present but its "
                     f"meta is unreadable; restore would fall back to "
                     f"{snap_name}")

    wal_p = cdir / WAL_FILE
    if not wal_p.exists():
        rep.error(f"{label}: missing {WAL_FILE}")
        return
    frames, first_lsn, last_lsn, valid = _scan_wal(
        wal_p, rep, f"{label}/{WAL_FILE}")
    rep.wal_frames += frames
    rep.wal_bytes += valid
    if frames and meta is None and first_lsn > 1:
        # No usable snapshot AND a log that does not reach back to
        # genesis. TWO writer histories produce these bytes: (a) every
        # pre-first_lsn op was rewound un-acked (legal — rewind keeps
        # next_lsn monotonic, so a failed FIRST insert leaves a healthy
        # never-snapshotted collection whose WAL starts at LSN 2), or
        # (b) the collection snapshotted-then-truncated and the snapshot
        # directory was lost from the image (data loss). The WAL alone
        # cannot distinguish them; the backup manifest can — a deleted
        # snapshot dir already errored in _verify_manifest — so with a
        # valid manifest this shape is the legal (a) and only warned.
        msg = (f"{label}: no usable snapshot and the WAL starts at "
               f"LSN {first_lsn}, not 1 — rewound never-acked genesis "
               f"ops (legal), or records lost with a deleted snapshot")
        if manifested:
            rep.warn(msg)
        else:
            rep.error(msg + " (no backup manifest to rule the loss out)")
    elif frames and meta is not None:
        snap_lsn = int(meta.get("last_lsn", 0))
        if first_lsn > snap_lsn + 1:
            # LSNs (snap_lsn+1 .. first_lsn-1) are on neither the snapshot
            # nor the log. If they were ACKED mutations the image lost
            # them — but rewound never-acked ops leave the same hole
            # legally (see _scan_wal), so this cannot soundly be an error.
            rep.warn(f"{label}: WAL starts at LSN {first_lsn}, snapshot "
                     f"covers through {snap_lsn} — LSNs "
                     f"{snap_lsn + 1}..{first_lsn - 1} are on neither "
                     f"(rewound never-acked ops, or lost frames if any "
                     f"of them was acked)")


def verify_image(path) -> dict:
    """Verify a backup image (or quiesced DB directory) at ``path``.

    Returns the report dict (see :class:`ImageReport`); never raises for
    content problems — a missing/invalid root is the only exception."""
    root = Path(path)
    rep = ImageReport()
    if not root.is_dir():
        raise FileNotFoundError(f"No database image at {root}")

    db_cfg = None
    cfg_p = root / CONFIG_FILE
    if not cfg_p.exists():
        rep.error(f"missing {CONFIG_FILE}")
    else:
        try:
            db_cfg = DatabaseConfig.from_json(json.loads(cfg_p.read_text()))
        except Exception as e:
            rep.error(f"{CONFIG_FILE} unreadable: {e}")

    manifested = _verify_manifest(root, rep)

    wal_p = root / WAL_FILE
    if wal_p.exists():
        frames, _, _, valid = _scan_wal(wal_p, rep, WAL_FILE)
        rep.wal_frames += frames
        rep.wal_bytes += valid
    else:
        rep.error(f"missing {WAL_FILE}")

    cols_dir = root / COLLECTIONS_DIR
    listed = set(db_cfg.collections) if db_cfg else set()
    present = set()
    if cols_dir.is_dir():
        for cdir in sorted(cols_dir.iterdir()):
            if not cdir.is_dir() or cdir.name.startswith("."):
                continue  # staging dirs (.repl_boot_*) are not collections
            present.add(cdir.name)
            rep.collections += 1
            _verify_collection(cdir, rep, manifested)
    elif listed:
        rep.error(f"missing {COLLECTIONS_DIR}/ directory")
    for name in sorted(listed - present):
        rep.error(f"collection {name!r} is in {CONFIG_FILE} but has no "
                  f"directory")
    for name in sorted(present - listed):
        rep.warn(f"collection dir {name!r} is not listed in {CONFIG_FILE} "
                 f"(load would recover or ignore it via the DB WAL)")
    return rep.to_dict()


def format_report(report: dict, path) -> str:
    """One-line human summary for the CLI/server result string."""
    status = "OK" if report["ok"] else "CORRUPT"
    line = (f"Backup image {path}: {status} — {report['collections']} "
            f"collections, {report['snapshot_files']} snapshot files "
            f"({report['snapshot_bytes']} B) verified, "
            f"{report['wal_frames']} WAL frames ({report['wal_bytes']} B) "
            f"scanned")
    if report["errors"]:
        line += "; errors: " + " | ".join(report["errors"][:10])
        if len(report["errors"]) > 10:
            line += f" | (+{len(report['errors']) - 10} more)"
    if report["warnings"]:
        line += "; warnings: " + " | ".join(report["warnings"][:5])
    return line
