"""CommandBuilder: command string -> Command object (the port's fork of
``vrod_tpu.commands.builder``, bound to the port's ``Database``).

Mirrors the reference factory (``src/command/builder.rs:6-82``):
the verb is upper-cased before dispatch (case-insensitive, builder.rs:29);
unknown verbs raise ``UnrecognizedCommandError`` (builder.rs:77-80). The verb
vocabulary is exactly the reference's dispatch table (builder.rs:30-76).
"""

from __future__ import annotations

from ..database import Database
from vrod_tpu.errors import UnrecognizedCommandError
from . import types as T

VERBS = (
    "CREATE", "DROP", "LISTCOLLECTIONS", "TRUNCATEWAL", "INSERT",
    "BULKINSERT", "UPDATE", "DELETE", "SEARCH", "SEARCHSIMILAR", "REINDEX",
)

# Verbs beyond the reference's dispatch table (documented extensions).
EXTENSION_VERBS = ("EXPORT", "BACKUP")


class CommandBuilder:
    def __init__(self, db: Database):
        self.db = db

    def build(self, collection: str | None, command: str,
              arg: str | None) -> T.Command:
        db = self.db
        verb = command.upper()
        if verb == "CREATE":
            # CREATE/DROP take the name via -a (reference: builder.rs:31-38).
            return T.CreateCollectionCommand(db, collection_name=arg)
        if verb == "DROP":
            return T.DropCollectionCommand(db, collection_name=arg)
        if verb == "LISTCOLLECTIONS":
            return T.ListCollectionsCommand(db)
        if verb == "TRUNCATEWAL":
            # No target -> truncate the database's WAL (builder.rs:41).
            return T.TruncateWalCommand(db, target=collection)
        if verb == "INSERT":
            return T.InsertCommand(db, collection_name=collection, arg=arg)
        if verb == "BULKINSERT":
            return T.BulkInsertCommand(db, collection_name=collection, arg=arg)
        if verb == "UPDATE":
            return T.UpdateCommand(db, collection_name=collection, arg=arg)
        if verb == "DELETE":
            return T.DeleteCommand(db, collection_name=collection, arg=arg)
        if verb == "SEARCH":
            return T.SearchCommand(db, collection_name=collection, arg=arg)
        if verb == "SEARCHSIMILAR":
            return T.SearchSimilarCommand(db, collection_name=collection, arg=arg)
        if verb == "REINDEX":
            return T.ReindexCommand(db, collection_name=collection)
        if verb == "EXPORT":  # extension: BULKINSERT's inverse
            return T.ExportCommand(db, collection_name=collection, arg=arg)
        if verb == "BACKUP":  # extension: online point-in-time DB backup
            return T.BackupCommand(db, arg=arg)
        raise UnrecognizedCommandError(command)
