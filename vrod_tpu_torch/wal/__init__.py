from .wal import GroupCommit, Wal
from . import ops

__all__ = ["GroupCommit", "Wal", "ops"]
