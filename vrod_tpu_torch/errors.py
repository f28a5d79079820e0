"""Error taxonomy for vrod-tpu.

The reference (sekulas/vRod) defines three error seams: ``ArgsError``
(``src/main.rs:36-40``), ``CommandBuilderError::UnrecognizedCommand``
(``src/command/builder.rs:10-15``) and ``io::ErrorKind::AlreadyExists`` raised
by DB init (``src/database/setup.rs:6-15``). This module reproduces those
contracts and extends them to the subsystems the reference declares but does
not implement (collections, WAL, search).
"""

from __future__ import annotations


class VrodError(Exception):
    """Base class for all vrod-tpu errors."""


class ArgsError(VrodError):
    """CLI argument errors (reference: ``ArgsError``, src/main.rs:36-40)."""


class MissingInitDatabaseNameError(ArgsError):
    """Reference: ``ArgsError::MissingInitDatabaseNameFlag`` (src/main.rs:38-39)."""

    def __init__(self) -> None:
        super().__init__(
            "Missing '--init-database-name' flag with argument for "
            "'--init-database' flag."
        )


class UnrecognizedCommandError(VrodError):
    """Reference: ``CommandBuilderError::UnrecognizedCommand`` (builder.rs:12-15)."""

    def __init__(self, command: str) -> None:
        super().__init__(f"Unrecognized command: {command}")
        self.command = command


class DatabaseExistsError(VrodError):
    """DB init refuses an existing directory (reference: setup.rs:6-15)."""


class DatabaseNotFoundError(VrodError):
    """No database at the given path (reference: Database::load intent, mod.rs:19-21)."""


class DatabaseLockedError(VrodError):
    """Another process holds the database's exclusive advisory lock."""


class CollectionExistsError(VrodError):
    pass


class CollectionNotFoundError(VrodError):
    pass


class MissingCommandArgError(VrodError):
    """A command that requires ``--command-arg`` was invoked without one."""


class RecordFormatError(VrodError):
    """Malformed ``v0,v1,...;payload`` record string (reference: embeddings.rs:61)."""


class RecordNotFoundError(VrodError):
    pass


class DimensionMismatchError(VrodError):
    pass


class WalError(VrodError):
    pass


class WalCorruptionError(WalError):
    """CRC mismatch / torn frame detected during WAL replay."""


class ConfigError(VrodError):
    pass
