"""vrod_tpu_torch: the PyTorch/CUDA port of vrod-tpu.

The same exact-kNN vector store as ``vrod_tpu`` — collections, WAL-first
mutations, snapshots, the command layer and CLI — with the device side
rebuilt on PyTorch: rows live in torch tensors on one CUDA device, and the
search runs hand-written CUDA kernels (``ops/cuda_topk.py``, built from
``csrc/`` with nvcc for sm_90a). The host modules that do not touch JAX
(config, errors, records, allocator, WAL, snapshot format, payload store,
metrics, locks, the native runtime) are ``vrod_tpu``'s own, imported, so
both packages read and write the same databases. This package imports
PyTorch and never JAX.

Exports resolve lazily (PEP 562), like ``vrod_tpu``'s.
"""

import importlib

from vrod_tpu.config import VROD_VERSION

__version__ = VROD_VERSION

# attribute -> submodule that defines it
_EXPORTS = {
    "Collection": ".collection",
    "SearchHit": ".collection",
    "Database": ".database",
    "DeviceEngine": ".engine",
}

__all__ = sorted(_EXPORTS) + ["VROD_VERSION", "__version__"]


def __getattr__(name):
    target = _EXPORTS.get(name)
    if target is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    val = getattr(importlib.import_module(target, __name__), name)
    globals()[name] = val
    return val


def __dir__():
    return sorted(set(list(globals()) + __all__))
