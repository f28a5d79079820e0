"""Database: the on-disk root + collection registry.

The port's fork of ``vrod_tpu.database``, bound to the port's
``Collection``. ``devices=`` (torch devices, or a process-spanning list from
``parallel.distributed.global_devices()``; default
``runtime.default_devices()``) is passed to every collection as in the JAX
package; ``device=d`` is the shorthand of ``devices=[d]``. The on-disk
layout is the JAX package's.

Preserves the reference's on-disk contract: a database is a directory
containing ``vr_config`` and ``vr_wal``
(``src/database/setup.rs:17-23``); ``Database.new`` refuses
an existing directory (``setup.rs:6-15``); ``Database.load`` — a ``todo!()``
in the reference (``src/database/mod.rs:19-21``) — is implemented here as
config read + DB-WAL reconciliation + lazy collection loading. Collections
live under ``collections/<name>/`` with their own ``vr_config``/``vr_wal``/
``snapshot/``.
"""

from __future__ import annotations

from pathlib import Path

from .config import (
    BACKUP_MANIFEST_FILE, COLLECTIONS_DIR, CONFIG_FILE, WAL_FILE,
    CollectionConfig, DatabaseConfig, read_config, write_config,
)
from .errors import (
    CollectionExistsError, CollectionNotFoundError, DatabaseExistsError,
    DatabaseLockedError, DatabaseNotFoundError,
)
from .wal import Wal, ops

from .collection import Collection


LOCK_FILE = "vr_lock"


class Database:
    def __init__(self, path: Path, config: DatabaseConfig, *,
                 devices=None, device=None, wal_sync: bool = True):
        self.path = Path(path)
        self.config = config
        if device is not None and devices is not None:
            raise ValueError("pass device= or devices=, not both")
        self._devices = devices
        self._device = device
        self._wal_sync = wal_sync
        # Exclusive advisory lock: a second process opening the same DB
        # would interleave WAL appends and corrupt the durable prefix.
        import fcntl
        self._lock_f = open(self.path / LOCK_FILE, "w")
        try:
            fcntl.flock(self._lock_f, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError:
            self._lock_f.close()
            self._lock_f = None
            raise DatabaseLockedError(
                f"Database at {self.path} is locked by another process")
        self.wal = Wal(self.path / WAL_FILE)
        self._collections: dict[str, Collection] = {}
        # Registry mutations (create/drop/load) are serialized; per-record
        # concurrency is handled by each collection's RW lock.
        import threading
        self._registry_lock = threading.Lock()

    # -- lifecycle (reference: Database::new / Database::load) --------------

    @classmethod
    def new(cls, path, name: str, **kw) -> "Database":
        """Create ``<path>/<name>/`` with vr_config + vr_wal
        (reference: create_database_directory, setup.rs:3-26)."""
        from .config import validate_name
        root = Path(path) / validate_name(name, "database name")
        if root.exists():
            raise DatabaseExistsError(f"Database directory already exists: {root}")
        root.mkdir(parents=True)
        config = DatabaseConfig(name=name)
        write_config(root / CONFIG_FILE, config.to_json())
        (root / WAL_FILE).touch()
        (root / COLLECTIONS_DIR).mkdir()
        return cls(root, config, **kw)

    @classmethod
    def load(cls, path, **kw) -> "Database":
        root = Path(path)
        if not (root / CONFIG_FILE).exists():
            raise DatabaseNotFoundError(f"No database at {root} (missing vr_config)")
        raw = read_config(root / CONFIG_FILE)
        config = (DatabaseConfig.from_json(raw) if raw
                  else DatabaseConfig(name=root.name))
        db = cls(root, config, **kw)
        db._recover()
        return db

    def close(self) -> None:
        for col in self._collections.values():
            col.close()
        self._collections.clear()
        self.wal.close()
        if getattr(self, "_lock_f", None):
            import fcntl
            fcntl.flock(self._lock_f, fcntl.LOCK_UN)
            self._lock_f.close()
            self._lock_f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _recover(self) -> None:
        """Reconcile the registry with the DB WAL (crash between WAL append
        and config write) and with the filesystem."""
        if self.wal.has_torn_tail:
            self.wal.repair()
        changed = False
        # Apply only the LAST op per collection name: replaying
        # intermediate drops destructively (rmtree) would destroy the data
        # of a LATER create of the same name (create -> compensating drop
        # -> successful re-create is a normal sequence). Recovery restores
        # the final state, not the history.
        last_ops: dict[str, object] = {}
        for _lsn, frame in self.wal.replay():
            op = ops.decode(frame)
            if isinstance(op, ops.CreateCollectionOp):
                last_ops[op.config_json["name"]] = op
            elif isinstance(op, ops.DropCollectionOp):
                last_ops[op.name] = op
        for op in last_ops.values():
            if isinstance(op, ops.CreateCollectionOp):
                name = op.config_json["name"]
                cdir = self._collection_dir(name)
                # Idempotently COMPLETE the on-disk artifacts: a crash
                # between mkdir and the vr_config write leaves a directory
                # that exists but cannot load — the WAL op carries the
                # config, so recovery finishes the job (no device engine is
                # needed to lay down three filesystem artifacts).
                Collection.create_on_disk(
                    cdir, CollectionConfig.from_json(op.config_json),
                    exist_ok=True)
                if name not in self.config.collections:
                    self.config.collections.append(name)
                    changed = True
            elif isinstance(op, ops.DropCollectionOp):
                cdir = self._collection_dir(op.name)
                if cdir.exists():
                    import shutil
                    shutil.rmtree(cdir)
                if op.name in self.config.collections:
                    self.config.collections.remove(op.name)
                    changed = True
        if changed:
            write_config(self.path / CONFIG_FILE, self.config.to_json())
        # Registry reconciled; the WAL frames are captured by the config.
        if self.wal.frame_count:
            self.wal.truncate()
        # A replication bootstrap killed mid-build leaves a staging dir
        # (adopt_collection_dir renames it into place atomically; anything
        # still named .repl_boot_* never made it).
        import shutil
        for stale in (self.path / COLLECTIONS_DIR).glob(".repl_boot_*"):
            shutil.rmtree(stale, ignore_errors=True)

    # -- collection registry ------------------------------------------------

    def _collection_dir(self, name: str) -> Path:
        return self.path / COLLECTIONS_DIR / name

    def create_collection(self, name: str, *, dim: int = 384,
                          metric: str = "cosine", dtype: str = "float32",
                          shards: int = 1, segment_rows: int = 65536,
                          **cfg_kw) -> Collection:
        """CREATE (reference: CreateCollectionCommand, types.rs:9-19).

        Default dim 384 matches the reference's fastembed default model
        (BGESmallENV15, embeddings.rs:7)."""
        self._registry_lock.acquire()
        try:
            return self._create_collection_locked(
                name, dim=dim, metric=metric, dtype=dtype, shards=shards,
                segment_rows=segment_rows, **cfg_kw)
        finally:
            self._registry_lock.release()

    def _create_collection_locked(self, name, *, dim, metric, dtype, shards,
                                  segment_rows, **cfg_kw) -> Collection:
        if name in self.config.collections or self._collection_dir(name).exists():
            raise CollectionExistsError(f"Collection {name!r} already exists")
        cfg = CollectionConfig(name=name, dim=dim, metric=metric, dtype=dtype,
                               shards=shards, segment_rows=segment_rows,
                               **cfg_kw)
        # WAL first, then filesystem, then registry config (recovery replays
        # the WAL if we crash in between).
        pre = self.wal.valid_size
        self.wal.append(ops.encode(ops.CreateCollectionOp(cfg.to_json())),
                        sync=self._wal_sync)
        try:
            col = Collection.create(
                self._collection_dir(name), cfg,
                devices=self._devices, device=self._device,
                wal_sync=self._wal_sync)
        except FileExistsError:
            # The directory appeared between the exists() check and mkdir
            # (an external actor — in-process creates are registry-locked).
            # This call created nothing, so it must delete nothing: rewind
            # the un-acked create op and report the conflict.
            try:
                self.wal.rewind(pre)
            except Exception:
                pass
            raise CollectionExistsError(
                f"Collection {name!r} already exists")
        except BaseException:
            # The create op was never acked: rewind it (a restart must not
            # resurrect a collection the caller was told failed to create)
            # and remove the partial artifacts this call laid down.
            try:
                self.wal.rewind(pre)
                cdir = self._collection_dir(name)
                if cdir.exists():
                    import shutil
                    shutil.rmtree(cdir)
            except Exception:
                pass
            raise
        self.config.collections.append(name)
        write_config(self.path / CONFIG_FILE, self.config.to_json())
        self._collections[name] = col
        return col

    def drop_collection(self, name: str) -> None:
        """DROP (reference: DropCollectionCommand, types.rs:21-31)."""
        with self._registry_lock:
            self._drop_collection_locked(name)

    def _drop_collection_locked(self, name: str) -> None:
        if name not in self.config.collections:
            raise CollectionNotFoundError(f"No collection named {name!r}")
        self.wal.append(ops.encode(ops.DropCollectionOp(name)),
                        sync=self._wal_sync)
        col = self._collections.pop(name, None)
        if col is not None:
            col.close()
        cdir = self._collection_dir(name)
        if cdir.exists():
            import shutil
            shutil.rmtree(cdir)
        self.config.collections.remove(name)
        write_config(self.path / CONFIG_FILE, self.config.to_json())

    def list_collections(self) -> list[str]:
        """LISTCOLLECTIONS (reference: ListCollectionsCommand, types.rs:33-42)."""
        return sorted(self.config.collections)

    def collection_stats(self, name: str) -> dict:
        """Stats without forcing a device restore: already-loaded collections
        report live state; cold ones report config + snapshot metadata.

        Runs under the registry lock: the cold path opens a second WAL
        handle on the collection's vr_wal, which must never race a
        concurrent lazy load (the opener clears stale .tmp files and could
        otherwise break an in-flight truncate_until)."""
        if name in self._collections:
            return self._collections[name].stats()
        with self._registry_lock:
            if name in self._collections:  # loaded while we waited
                return self._collections[name].stats()
            if name not in self.config.collections:
                raise CollectionNotFoundError(f"No collection named {name!r}")
            cdir = self._collection_dir(name)
            cfg = CollectionConfig.from_json(read_config(cdir / CONFIG_FILE))
            # Honor the same snapshot fallbacks restore uses: a crash
            # mid-swap leaves the data in snapshot.old (or .tmp) — counting
            # only WAL-tail ids then would report e.g. 3 for a 1M-row
            # collection.
            count = None
            snap_used = None
            import json
            for snap in ("snapshot", "snapshot.old", "snapshot.tmp"):
                meta_path = cdir / snap / "meta.json"
                if meta_path.exists():
                    try:
                        count = json.loads(meta_path.read_text()).get("count")
                        snap_used = snap
                        break
                    except Exception:
                        continue
            from .wal import Wal as _Wal
            wal = _Wal(cdir / WAL_FILE)
            frames = wal.frame_count
            live = count
            if frames:
                # Exact count without a device restore: replay only the
                # WAL ops' id effects over the snapshot's id set
                # (host-only; bounded by _HOST_COUNT_MAX_IDS).
                try:
                    live = self._host_only_count(cdir, wal, snap_used)
                except Exception:
                    live = None
            wal.close()
        return {
            "name": name, "dim": cfg.dim, "metric": cfg.metric,
            "dtype": cfg.dtype, "shards": cfg.shards,
            "count": live,
            "snapshot_count": count, "wal_frames": frames, "loaded": False,
        }

    # Host-only exact counts replay id sets only (~8 B/id + set overhead):
    # 20M ids is ~a few hundred MB transiently — covers the 10M-row
    # collections the engine itself supports, with 2x headroom.
    _HOST_COUNT_MAX_IDS = 20_000_000

    def _host_only_count(self, cdir, wal, snap_dir_name="snapshot"):
        import numpy as np
        from .wal import ops as wal_ops
        # Event-stream formulation in numpy: a CPython int set at 10-20M
        # ids costs ~1.5-2 GB transiently; uint64 event arrays + one
        # stable argsort (last event per id wins) stay in the low
        # hundreds of MB at the same scale.
        id_chunks, kind_chunks, total = [], [], 0
        ids_path = cdir / (snap_dir_name or "snapshot") / "ids.npy"
        if ids_path.exists():
            arr = np.load(ids_path).astype(np.uint64, copy=False).ravel()
            id_chunks.append(arr)
            kind_chunks.append(np.ones(arr.size, dtype=np.bool_))
            total += arr.size
        for _lsn, frame in wal.replay():
            # decode_effect skips vector/payload materialization — a
            # multi-GB BULK frame costs an id-array view, not a full copy.
            eff = wal_ops.decode_effect(frame)
            if eff is None:
                continue
            kind, rids = eff
            # COPY, not a view: decode_effect returns np.frombuffer views
            # whose .base is the ENTIRE frame — keeping the view would pin
            # every BULK frame's vectors+payloads in RAM for the whole
            # replay (~GBs at 1M+ rows) instead of ~8 B/id.
            rids = np.array(rids, dtype=np.uint64, copy=True).ravel()
            id_chunks.append(rids)
            kind_chunks.append(
                np.full(rids.size, kind == "insert", dtype=np.bool_))
            total += rids.size
            # Raw-event cap bounds memory even under heavy churn (events
            # can exceed unique ids).
            if total > 4 * self._HOST_COUNT_MAX_IDS:
                raise OverflowError("too large for host-only count")
        if not id_chunks:
            return 0
        all_ids = np.concatenate(id_chunks)
        all_kind = np.concatenate(kind_chunks)
        order = np.argsort(all_ids, kind="stable")  # by id, then sequence
        sid = all_ids[order]
        last = np.ones(sid.size, dtype=np.bool_)
        last[:-1] = sid[1:] != sid[:-1]
        if int(last.sum()) > self._HOST_COUNT_MAX_IDS:
            raise OverflowError("too large for host-only count")
        return int(all_kind[order][last].sum())

    def is_loaded(self, name: str) -> bool:
        """True when the collection is resident (device engine restored).
        Lets callers choose disk-metadata paths for cold collections."""
        return name in self._collections

    def collection_config_json(self, name: str) -> dict:
        """A collection's config as stored on disk, without loading it."""
        if name in self._collections:
            return self._collections[name].config.to_json()
        with self._registry_lock:
            if name not in self.config.collections:
                raise CollectionNotFoundError(f"No collection named {name!r}")
            return read_config(self._collection_dir(name) / CONFIG_FILE)

    def collection_position(self, name: str) -> int:
        """Replication head LSN (see Collection.repl_position) without
        forcing a device restore for cold collections: the max of the
        snapshot's recorded cut and the on-disk WAL's last lsn."""
        if name in self._collections:
            return self._collections[name].repl_position()
        with self._registry_lock:
            if name in self._collections:  # loaded while we waited
                return self._collections[name].repl_position()
            if name not in self.config.collections:
                raise CollectionNotFoundError(f"No collection named {name!r}")
            cdir = self._collection_dir(name)
            import json
            from .config import SNAPSHOT_DIR
            floor = 0
            for snap in (SNAPSHOT_DIR, SNAPSHOT_DIR + ".old",
                         SNAPSHOT_DIR + ".tmp"):
                meta_path = cdir / snap / "meta.json"
                if meta_path.exists():
                    try:
                        floor = int(json.loads(
                            meta_path.read_text()).get("last_lsn", 0))
                        break
                    except Exception:
                        continue
            from .wal import Wal as _Wal
            wal = _Wal(cdir / WAL_FILE)
            try:
                return max(floor, wal.last_lsn)
            finally:
                wal.close()

    def adopt_collection_dir(self, name: str, src_dir) -> None:
        """Atomically adopt a fully-built collection directory (replication
        bootstrap): the staging dir — vr_config + vr_wal + snapshot files,
        written OUTSIDE the registry — is WAL-logged and renamed into
        place in one registry-locked step, so a concurrent search either
        sees no collection or the complete one, and a crash at any point
        either replays the create (idempotent completion) or sweeps the
        orphaned staging dir (_recover)."""
        src_dir = Path(src_dir)
        cfg_json = read_config(src_dir / CONFIG_FILE)
        cfg = CollectionConfig.from_json(cfg_json)  # validate first
        if cfg.name != name:
            raise ValueError(
                f"Staged config names {cfg.name!r}, adopting as {name!r}")
        with self._registry_lock:
            if (name in self.config.collections
                    or self._collection_dir(name).exists()):
                raise CollectionExistsError(
                    f"Collection {name!r} already exists")
            pre = self.wal.valid_size
            self.wal.append(ops.encode(ops.CreateCollectionOp(cfg_json)),
                            sync=self._wal_sync)
            try:
                src_dir.rename(self._collection_dir(name))
            except BaseException:
                try:
                    self.wal.rewind(pre)
                except Exception:
                    pass
                raise
            self.config.collections.append(name)
            write_config(self.path / CONFIG_FILE, self.config.to_json())

    def collection(self, name: str) -> Collection:
        if name in self._collections:
            return self._collections[name]
        with self._registry_lock:
            if name in self._collections:
                return self._collections[name]
            if name not in self.config.collections:
                raise CollectionNotFoundError(f"No collection named {name!r}")
            col = Collection.load(
                self._collection_dir(name),
                devices=self._devices, device=self._device,
                wal_sync=self._wal_sync)
            self._collections[name] = col
            return col

    def truncate_wal(self, target: str | None = None) -> None:
        """TRUNCATEWAL: collection WAL if a target is given, else the
        database-level WAL (reference: builder.rs:41 comment)."""
        if target is None:
            self.wal.truncate()
        else:
            self.collection(target).truncate_wal()

    # -- backup (extension verb BACKUP) --------------------------------------

    def backup(self, dest) -> dict:
        """Online point-in-time backup: copy a consistent, independently
        restorable image of the whole database (vr_config + vr_wal + every
        collection's config/snapshot/WAL prefix) into ``dest``, which must
        not exist. The result opens with ``Database.load`` like any DB dir.

        Semantics: each collection is captured at its own consistent cut
        (see ``Collection.backup_into``); searches and mutations proceed
        during the copy (mutations acked after a collection's cut may be
        absent). The registry lock is held throughout, so CREATE/DROP and
        first-use loads of cold collections block until the backup
        finishes — already-loaded collections serve normally. Crash-safe:
        the image is written to ``<dest>.tmp`` and atomically renamed, so a
        killed backup never leaves a half-image at ``dest``; rebuildable
        caches (payloads.db) are excluded."""
        import shutil
        from . import snapshot as snapio
        dest = Path(dest)
        if dest.exists():
            raise DatabaseExistsError(
                f"Backup destination already exists: {dest}")
        tmp = dest.with_name(dest.name + ".tmp")
        if tmp.exists():
            shutil.rmtree(tmp)
        stats = {"collections": 0, "wal_bytes": 0, "snapshot_files": 0}
        with self._registry_lock:
            try:
                tmp.mkdir(parents=True)
                (tmp / COLLECTIONS_DIR).mkdir()
                # Registry ops run under the lock we hold: the DB config +
                # WAL pair is static for the duration.
                shutil.copy2(self.path / CONFIG_FILE, tmp / CONFIG_FILE)
                snapio.fsync_file(tmp / CONFIG_FILE)
                self.wal.sync()
                snapio.copy_file_prefix(
                    self.path / WAL_FILE, tmp / WAL_FILE, self.wal.valid_size)
                for name in list(self.config.collections):
                    cdest = tmp / COLLECTIONS_DIR / name
                    col = self._collections.get(name)
                    if col is not None:
                        st = col.backup_into(cdest)
                    else:
                        st = self._backup_cold_collection(name, cdest)
                    stats["collections"] += 1
                    stats["wal_bytes"] += st["wal_bytes"]
                    stats["snapshot_files"] += st["snapshot_files"]
                # Last: a self-checksummed manifest of every file in the
                # image (relative path -> size). Per-file checksums cannot
                # witness a DELETED file — a lost snapshot directory looks
                # identical to a collection that never snapshotted —
                # so verify_image checks presence/size against this list
                # and can then treat a genesis LSN hole as the legal
                # rewound-op shape it is. ``Database.load`` ignores it.
                import json as _json
                files = {
                    p.relative_to(tmp).as_posix(): p.stat().st_size
                    for p in sorted(tmp.rglob("*")) if p.is_file()
                }
                manifest = {"format": 1, "files": files}
                manifest["meta_crc"] = snapio.meta_self_crc(manifest)
                (tmp / BACKUP_MANIFEST_FILE).write_text(
                    _json.dumps(manifest))
                snapio.fsync_file(tmp / BACKUP_MANIFEST_FILE)
                snapio.fsync_dir(tmp / COLLECTIONS_DIR)
                snapio.fsync_dir(tmp)
            except BaseException:
                shutil.rmtree(tmp, ignore_errors=True)
                raise
        tmp.rename(dest)
        snapio.fsync_dir(dest.parent)
        return stats

    def _backup_cold_collection(self, name: str, cdest: Path) -> dict:
        """A collection that was never loaded has no in-process writers and
        the registry lock (held by backup) blocks a concurrent lazy load:
        its files are static, so a plain copy is consistent. Snapshot
        fallback dirs (.old/.tmp — a crash mid-swap) are copied too;
        restore picks the newest CRC-valid one exactly as a local load
        would.

        Only the WAL's CRC-valid prefix is copied (like the hot path's
        ``copy_file_prefix(valid_size)``): a cold collection that last
        crashed mid-append carries a torn tail which load would repair —
        but an IMAGE must hold only valid frames, or ``verify_image``
        rightly calls it damaged."""
        import shutil
        from . import snapshot as snapio
        from .wal.wal import valid_prefix_size
        csrc = self._collection_dir(name)
        cdest.mkdir(parents=True)
        shutil.copy2(csrc / CONFIG_FILE, cdest / CONFIG_FILE)
        snapio.fsync_file(cdest / CONFIG_FILE)
        wal_bytes = snapio.copy_file_prefix(
            csrc / WAL_FILE, cdest / WAL_FILE,
            valid_prefix_size(csrc / WAL_FILE))
        snap_files = 0
        from .config import SNAPSHOT_DIR
        for snap in (SNAPSHOT_DIR, SNAPSHOT_DIR + ".old",
                     SNAPSHOT_DIR + ".tmp"):
            sdir = csrc / snap
            if sdir.is_dir():
                shutil.copytree(sdir, cdest / snap)
                for f in (cdest / snap).iterdir():
                    snapio.fsync_file(f)  # durable backup = fsynced bytes
                    snap_files += 1
                snapio.fsync_dir(cdest / snap)
        snapio.fsync_dir(cdest)
        return {"wal_bytes": wal_bytes, "snapshot_files": snap_files}
