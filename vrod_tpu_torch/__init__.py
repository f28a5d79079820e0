"""vrod_tpu_torch: the PyTorch/CUDA port of vrod-tpu.

The same exact-kNN vector store as ``vrod_tpu`` — collections, WAL-first
mutations, snapshots, the command layer and CLI — with the device side
rebuilt on PyTorch: rows live in torch tensors row-sharded over one or more
CUDA devices (``parallel``: in one process or across a process group), and
the search runs hand-written CUDA kernels (``ops/cuda_topk.py``, built from
``csrc/`` with nvcc for sm_90a). The host modules (config, errors,
records, allocator, WAL, snapshot format, payload store, image verifier,
metrics, locks, embeddings, the native runtime in ``_native/``) and the
serving side (``server``, ``frontend``, ``client``, ``pool``,
``replication``, ``netaddr``, ``utils/verify``) are this package's own
copies of ``vrod_tpu``'s, byte-compatible on disk and on the wire, so both
packages read and write the same databases and talk to each other's
servers. This package imports PyTorch and nothing of ``vrod_tpu``, JAX or
``ml_dtypes``.

Exports resolve lazily (PEP 562), like ``vrod_tpu``'s.
"""

import importlib

from .config import VROD_VERSION

__version__ = VROD_VERSION

# attribute -> submodule that defines it ("" = the submodule itself); every
# name of ``vrod_tpu.__all__``, and the engine.
_EXPORTS = {
    "Collection": ".collection",
    "SearchHit": ".collection",
    "CollectionConfig": ".config",
    "DatabaseConfig": ".config",
    "Database": ".database",
    "DeviceEngine": ".engine",
    "QueryBatcher": ".frontend",
    "Record": ".records",
    "format_record": ".records",
    "parse_record": ".records",
    "VrodServer": ".server",
    "Replicator": ".replication",
    "ReplicationError": ".replication",
    "VrodClient": ".client",
    "VrodPool": ".pool",
    "VrodServerError": ".client",
    "VrodConnectionError": ".client",
    "verify_recall": ".utils.verify",
    "metrics": "",
    "errors": "",
}

__all__ = sorted(_EXPORTS) + ["VROD_VERSION", "__version__"]


def __getattr__(name):
    target = _EXPORTS.get(name)
    if target is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    if target == "":
        val = importlib.import_module(f".{name}", __name__)
    else:
        val = getattr(importlib.import_module(target, __name__), name)
    globals()[name] = val
    return val


def __dir__():
    return sorted(set(list(globals()) + __all__))
