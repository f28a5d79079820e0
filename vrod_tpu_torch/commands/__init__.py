from .builder import VERBS, CommandBuilder
from .types import (
    BulkInsertCommand, Command, CreateCollectionCommand, DeleteCommand,
    DropCollectionCommand, InsertCommand, ListCollectionsCommand,
    ReindexCommand, SearchCommand, SearchSimilarCommand, TruncateWalCommand,
    UnrecognizedCommand, UpdateCommand,
)

__all__ = [
    "VERBS", "CommandBuilder", "Command", "CreateCollectionCommand",
    "DropCollectionCommand", "ListCollectionsCommand", "TruncateWalCommand",
    "InsertCommand", "BulkInsertCommand", "UpdateCommand", "DeleteCommand",
    "SearchCommand", "SearchSimilarCommand", "ReindexCommand",
    "UnrecognizedCommand",
]
