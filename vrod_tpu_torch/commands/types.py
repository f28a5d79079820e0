"""Command layer: the reference's 12 command structs, implemented (the
port's fork of ``vrod_tpu.commands.types``, bound to the port's
``Database``).

The reference declares ``trait Command { fn execute(&self); }`` and twelve
commands whose bodies are empty stubs
(``src/command/types.rs:5-154``). Here each command's
``execute`` does the real work against a ``Database`` and returns a
human-readable result string (printed by the CLI).

Argument formats (the reference never defined them; vrod-tpu's contract):
  CREATE        -a "name[;dim=384][;metric=cosine][;dtype=float32][;shards=1][;segment_rows=65536]"
  DROP          -a "name"
  LISTCOLLECTIONS
  TRUNCATEWAL   [-c collection]          (no -c: database-level WAL)
  INSERT        -c col -a "v0,v1,...;payload"
  BULKINSERT    -c col -a <path to file of one record per line>
  UPDATE        -c col -a "id;v0,v1,...;payload"
  DELETE        -c col -a "id"
  SEARCH        -c col -a "id"           (exact lookup)
  SEARCHSIMILAR -c col -a "v0,v1,...[;k=10]"
  REINDEX       -c col
  EXPORT        -c col -a <output file path>   (extension: BULKINSERT's inverse)
  BACKUP        -a <destination directory>     (extension: online DB backup)
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..database import Database
from ..errors import MissingCommandArgError, RecordFormatError
from ..records import (
    format_record, parse_query, parse_record, parse_record_matrix,
)


@dataclasses.dataclass
class Command:
    db: Database

    def execute(self) -> str:
        raise NotImplementedError

    def _require(self, value, what: str):
        if value is None:
            raise MissingCommandArgError(f"{type(self).__name__} requires {what}")
        return value


@dataclasses.dataclass
class CreateCollectionCommand(Command):
    collection_name: str | None = None

    def execute(self) -> str:
        arg = self._require(self.collection_name, "a collection name argument (-a)")
        name, _, tail = arg.partition(";")
        kw = {}
        for part in tail.split(";") if tail else []:
            part = part.strip()
            if not part:
                continue
            key, _, val = part.partition("=")
            if key in ("dim", "shards", "segment_rows", "rescore_margin",
                       "auto_snapshot_wal_bytes"):
                try:
                    kw[key] = int(val)
                except ValueError as e:
                    raise RecordFormatError(
                        f"Bad CREATE option {key}={val!r}: expected an "
                        f"integer") from e
            elif key == "auto_compact_fraction":
                try:
                    kw[key] = float(val)
                except ValueError as e:
                    raise RecordFormatError(
                        f"Bad CREATE option {key}={val!r}: expected a "
                        f"float") from e
            elif key in ("metric", "dtype", "payload_store"):
                kw[key] = val
            else:
                raise RecordFormatError(f"Unknown CREATE option {key!r}")
        col = self.db.create_collection(name.strip(), **kw)
        return (f"Created collection {col.config.name!r} "
                f"(dim={col.config.dim}, metric={col.config.metric}, "
                f"dtype={col.config.dtype}, shards={col.config.shards})")


@dataclasses.dataclass
class DropCollectionCommand(Command):
    collection_name: str | None = None

    def execute(self) -> str:
        name = self._require(self.collection_name, "a collection name argument (-a)")
        self.db.drop_collection(name.strip())
        return f"Dropped collection {name.strip()!r}"


@dataclasses.dataclass
class ListCollectionsCommand(Command):
    def execute(self) -> str:
        names = self.db.list_collections()
        if not names:
            return "(no collections)"
        lines = []
        for n in names:
            # Lazy stats: listing must not force a device restore of every
            # collection (a cold one reports its snapshot count or '?' if
            # un-replayed WAL frames make the live count unknown).
            st = self.db.collection_stats(n)
            count = st["count"] if st["count"] is not None else "?"
            lines.append(
                f"{n}  count={count} dim={st['dim']} "
                f"metric={st['metric']} dtype={st['dtype']} shards={st['shards']}")
        return "\n".join(lines)


@dataclasses.dataclass
class TruncateWalCommand(Command):
    # If no target is provided, truncate the database's WAL
    # (reference: builder.rs:41).
    target: str | None = None

    def execute(self) -> str:
        self.db.truncate_wal(self.target)
        scope = f"collection {self.target!r}" if self.target else "database"
        return f"Truncated {scope} WAL"


@dataclasses.dataclass
class InsertCommand(Command):
    collection_name: str | None = None
    arg: str | None = None

    def execute(self) -> str:
        col = self.db.collection(
            self._require(self.collection_name, "a collection (-c)"))
        rec = parse_record(self._require(self.arg, "a record argument (-a)"))
        rid = col.insert(rec.vector, rec.payload)
        return f"Inserted record {rid}"


@dataclasses.dataclass
class BulkInsertCommand(Command):
    collection_name: str | None = None
    arg: str | None = None

    def execute(self) -> str:
        from pathlib import Path
        col = self.db.collection(
            self._require(self.collection_name, "a collection (-c)"))
        path = Path(self._require(self.arg, "a records-file path (-a)"))
        try:
            # utf-8 regardless of locale: EXPORT writes utf-8, and dumps
            # must round-trip across differently-configured hosts.
            text = path.read_text(encoding="utf-8")
        except (OSError, UnicodeDecodeError) as e:
            raise RecordFormatError(
                f"Cannot read records file {path}: {e}") from e
        vecs, payloads = parse_record_matrix(text)
        if len(payloads) == 0:
            return "Inserted 0 records"
        rids = col.bulk_insert(vecs, payloads)
        return f"Inserted {len(rids)} records (ids {rids[0]}..{rids[-1]})"


@dataclasses.dataclass
class UpdateCommand(Command):
    collection_name: str | None = None
    arg: str | None = None

    def execute(self) -> str:
        col = self.db.collection(
            self._require(self.collection_name, "a collection (-c)"))
        arg = self._require(self.arg, "an 'id;v0,v1,...;payload' argument (-a)")
        id_part, _, rest = arg.partition(";")
        try:
            rid = int(id_part)
        except ValueError as e:
            raise RecordFormatError(f"Bad record id {id_part!r}") from e
        rec = parse_record(rest)
        col.update(rid, rec.vector, rec.payload)
        return f"Updated record {rid}"


@dataclasses.dataclass
class DeleteCommand(Command):
    collection_name: str | None = None
    arg: str | None = None

    def execute(self) -> str:
        col = self.db.collection(
            self._require(self.collection_name, "a collection (-c)"))
        arg = self._require(self.arg, "a record id (or id,id,...) (-a)")
        try:
            rids = [int(tok) for tok in arg.split(",") if tok.strip()]
        except ValueError as e:
            raise RecordFormatError(f"Bad record id in {self.arg!r}") from e
        if any(r < 0 for r in rids):
            # A negative id in a LIST would crash the uint64 conversion
            # with a raw OverflowError instead of a clean error.
            raise RecordFormatError(
                f"Record ids must be non-negative, got {self.arg!r}")
        if len(rids) == 1:
            col.delete(rids[0])
            return f"Deleted record {rids[0]}"
        n = col.delete_many(rids)
        return f"Deleted {n} records"


@dataclasses.dataclass
class SearchCommand(Command):
    collection_name: str | None = None
    arg: str | None = None

    def execute(self) -> str:
        col = self.db.collection(
            self._require(self.collection_name, "a collection (-c)"))
        try:
            rid = int(self._require(self.arg, "a record id (-a)"))
        except ValueError as e:
            raise RecordFormatError(f"Bad record id {self.arg!r}") from e
        rec = col.get(rid)
        return format_record(rec.vector, rec.payload)


@dataclasses.dataclass
class SearchSimilarCommand(Command):
    collection_name: str | None = None
    arg: str | None = None

    def execute(self) -> str:
        col = self.db.collection(
            self._require(self.collection_name, "a collection (-c)"))
        vector, k, within, exclude = parse_query(
            self._require(
                self.arg,
                "a 'v0,v1,...[;k=10][;within=ids|;exclude=ids]' argument (-a)"))
        hits = col.search_similar(vector, k, within_ids=within,
                                  exclude_ids=exclude)
        if not hits:
            return "(no results)"
        return "\n".join(
            f"{h.record_id}\t{h.score:.6f}\t{h.payload}" for h in hits)


@dataclasses.dataclass
class ExportCommand(Command):
    """Extension verb (no reference counterpart): dump a collection's live
    records to a file in the ``v0,...,vD;payload`` line format — the exact
    inverse of BULKINSERT, for backup/migration through the documented
    record model. Ids are not preserved (snapshots are the id-stable
    backup); see Collection.export_records for the full contract."""

    collection_name: str | None = None
    arg: str | None = None

    def execute(self) -> str:
        from pathlib import Path
        col = self.db.collection(
            self._require(self.collection_name, "a collection (-c)"))
        path = Path(self._require(self.arg, "an output-file path (-a)"))
        try:
            n = col.export_records(path)
        except OSError as e:
            raise RecordFormatError(
                f"Cannot write records file {path}: {e}") from e
        return f"Exported {n} records to {path}"


@dataclasses.dataclass
class BackupCommand(Command):
    """Extension verb (no reference counterpart): online point-in-time
    backup of the whole database into a new directory, restorable with
    ``Database.load`` / ``vrod -n``. See ``Database.backup`` for the
    consistency contract (per-collection cuts; serving continues).

    ``BACKUP -a <path>;verify`` re-walks an EXISTING image's checksums
    (snapshot file CRCs, WAL frame CRCs, structural consistency) without
    restoring anything — see ``vrod_tpu.verify_image``. Verification of an
    image whose bytes are damaged returns a CORRUPT report (the command
    raises so scripted ``vrod -e 'BACKUP ...'`` exits nonzero).

    Only the exact trailing ``;verify`` token is special: any other
    argument — semicolons included — is a destination path (``-a`` is a
    filesystem path, so an unknown-option error here would make such
    paths unreachable; a path that itself ends in ``;verify`` can be
    verified via the ``verify_image`` API)."""

    arg: str | None = None

    def execute(self) -> str:
        from pathlib import Path
        arg = self._require(
            self.arg, "a destination directory path (-a)")
        path_part, sep, opt = arg.rpartition(";")
        if sep and opt.strip().lower() == "verify":
            from ..errors import WalCorruptionError
            from ..verify_image import format_report, verify_image
            report = verify_image(Path(path_part))
            line = format_report(report, path_part)
            if not report["ok"]:
                raise WalCorruptionError(line)
            return line
        dest = Path(arg)
        stats = self.db.backup(dest)
        return (f"Backed up {stats['collections']} collections to {dest} "
                f"({stats['wal_bytes']} WAL bytes, "
                f"{stats['snapshot_files']} snapshot files)")


@dataclasses.dataclass
class ReindexCommand(Command):
    collection_name: str | None = None

    def execute(self) -> str:
        col = self.db.collection(
            self._require(self.collection_name, "a collection (-c)"))
        moved = col.reindex()
        return f"Reindexed: compacted {moved} rows, snapshot written"


@dataclasses.dataclass
class UnrecognizedCommand(Command):
    """Fallback no-op (reference: types.rs:146-154)."""

    def execute(self) -> str:
        return "Unrecognized command (no-op)"
