"""Lazy, cached build of the native host runtime (WAL + slot allocator).

Compiles ``native.cpp`` into ``libvrodnative.so`` on first use; rebuilds only
when the source changes (content hash in the cached .so name). Falls back to
``None`` if no C++ toolchain is available — callers then use the pure-Python
implementations (same on-disk format, bit-for-bit compatible).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

_HERE = Path(__file__).resolve().parent
_SRC = _HERE / "native.cpp"

_lib = None
_lib_loaded = False


def _build_dir() -> Path:
    d = _HERE / "build"
    d.mkdir(exist_ok=True)
    return d


def _compile() -> Path | None:
    src_hash = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    out = _build_dir() / f"libvrodnative-{src_hash}.so"
    if out.exists():
        return out
    cxx = os.environ.get("CXX", "g++")
    with tempfile.TemporaryDirectory(dir=_build_dir()) as tmp:
        tmp_out = Path(tmp) / out.name
        cmd = [
            cxx, "-O3", "-std=c++17", "-shared", "-fPIC",
            "-o", str(tmp_out), str(_SRC),
        ]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=300)
        except (subprocess.CalledProcessError, subprocess.TimeoutExpired,
                FileNotFoundError):
            return None
        # Atomic publish so concurrent builders don't race.
        try:
            os.replace(tmp_out, out)
        except OSError:
            return None
    return out


def load_native() -> ctypes.CDLL | None:
    """Load (building if needed) the native library, or None if unavailable."""
    global _lib, _lib_loaded
    if _lib_loaded:
        return _lib
    _lib_loaded = True
    if os.environ.get("VROD_DISABLE_NATIVE"):
        return None
    so = _compile()
    if so is None:
        return None
    lib = ctypes.CDLL(str(so))

    u8p = ctypes.POINTER(ctypes.c_uint8)
    u64p = ctypes.POINTER(ctypes.c_uint64)

    lib.vrod_crc32.restype = ctypes.c_uint32
    lib.vrod_crc32.argtypes = [u8p, ctypes.c_uint64]

    lib.vrod_wal_open.restype = ctypes.c_void_p
    lib.vrod_wal_open.argtypes = [ctypes.c_char_p]
    lib.vrod_wal_close.argtypes = [ctypes.c_void_p]
    lib.vrod_wal_append.restype = ctypes.c_uint64
    lib.vrod_wal_append.argtypes = [ctypes.c_void_p, u8p, ctypes.c_uint32]
    lib.vrod_wal_sync.restype = ctypes.c_int
    lib.vrod_wal_sync.argtypes = [ctypes.c_void_p]
    lib.vrod_wal_truncate.restype = ctypes.c_int
    lib.vrod_wal_truncate.argtypes = [ctypes.c_void_p]
    lib.vrod_wal_truncate_until.restype = ctypes.c_int
    lib.vrod_wal_truncate_until.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.vrod_wal_rewind.restype = ctypes.c_int
    lib.vrod_wal_rewind.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.vrod_wal_seed_lsn.restype = None
    lib.vrod_wal_seed_lsn.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.vrod_wal_set_next_lsn.restype = ctypes.c_int
    lib.vrod_wal_set_next_lsn.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.vrod_wal_repair.restype = ctypes.c_int
    lib.vrod_wal_repair.argtypes = [ctypes.c_void_p]
    for fn in ("vrod_wal_frame_count", "vrod_wal_valid_size", "vrod_wal_last_lsn"):
        getattr(lib, fn).restype = ctypes.c_uint64
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
    lib.vrod_wal_has_torn_tail.restype = ctypes.c_int
    lib.vrod_wal_has_torn_tail.argtypes = [ctypes.c_void_p]
    lib.vrod_wal_frame_len.restype = ctypes.c_uint64
    lib.vrod_wal_frame_len.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.vrod_wal_frame_lsn.restype = ctypes.c_uint64
    lib.vrod_wal_frame_lsn.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.vrod_wal_frame_read.restype = ctypes.c_long
    lib.vrod_wal_frame_read.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, u8p, ctypes.c_uint64]

    lib.vrod_alloc_new.restype = ctypes.c_void_p
    lib.vrod_alloc_new.argtypes = [ctypes.c_uint64]
    lib.vrod_alloc_free.argtypes = [ctypes.c_void_p]
    lib.vrod_alloc_grow.restype = ctypes.c_int
    lib.vrod_alloc_grow.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.vrod_alloc_shrink.restype = ctypes.c_int
    lib.vrod_alloc_shrink.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    for fn in ("vrod_alloc_capacity", "vrod_alloc_live_count",
               "vrod_alloc_free_count", "vrod_alloc_high_water"):
        getattr(lib, fn).restype = ctypes.c_uint64
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
    lib.vrod_alloc_acquire.restype = ctypes.c_long
    lib.vrod_alloc_acquire.argtypes = [ctypes.c_void_p, ctypes.c_uint64, u64p, u64p]
    lib.vrod_alloc_release.restype = ctypes.c_uint64
    lib.vrod_alloc_release.argtypes = [ctypes.c_void_p, ctypes.c_uint64, u64p, u64p]
    lib.vrod_alloc_slot_of.restype = ctypes.c_uint64
    lib.vrod_alloc_slot_of.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.vrod_alloc_id_of.restype = ctypes.c_uint64
    lib.vrod_alloc_id_of.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.vrod_alloc_ids_of.restype = None
    lib.vrod_alloc_ids_of.argtypes = [ctypes.c_void_p, ctypes.c_uint64, u64p, u64p]
    lib.vrod_alloc_slots_of.restype = None
    lib.vrod_alloc_slots_of.argtypes = [ctypes.c_void_p, ctypes.c_uint64, u64p, u64p]
    lib.vrod_alloc_is_live.restype = ctypes.c_int
    lib.vrod_alloc_is_live.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.vrod_alloc_live_slots.restype = ctypes.c_uint64
    lib.vrod_alloc_live_slots.argtypes = [ctypes.c_void_p, u64p]
    lib.vrod_alloc_plan_compaction.restype = ctypes.c_uint64
    lib.vrod_alloc_plan_compaction.argtypes = [ctypes.c_void_p, u64p, u64p]
    lib.vrod_alloc_apply_compaction.restype = ctypes.c_int
    lib.vrod_alloc_apply_compaction.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, u64p, u64p]

    _lib = lib
    return _lib
