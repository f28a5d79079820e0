"""Host-side slot allocator for HBM collection tensors.

C++ implementation (``_native/native.cpp``) via ctypes, with a pure-Python
fallback. Owns the free-list, the live bitmap (slot -> record id binding),
and compaction planning. The reference's intended `Database.collections`
storage (the reference vRod's ``src/database/mod.rs:8``) maps to this +
the device engine: slots index rows of the collection's HBM tensor.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ._native.build import load_native

NO_ID = 2**64 - 1


def _check_full_plan(live_count, live_slots, src, dst):
    """apply_compaction is all-or-nothing: the plan must relocate EVERY
    live slot beyond the packed tail (live_count) into [0, live_count).
    Applying a partial plan would strand live rows above the reset tail,
    where live_slots()/acquire no longer see them — silent data loss at
    the next snapshot. Validated here, BEFORE any binding moves."""
    src = np.asarray(src, dtype=np.uint64).ravel()
    dst = np.asarray(dst, dtype=np.uint64).ravel()
    high = live_slots[live_slots >= live_count]
    if (not np.array_equal(np.sort(src), np.sort(high))
            or (dst >= live_count).any()):
        raise ValueError(
            "Compaction plan must be applied whole: src must cover exactly "
            "the live slots beyond the packed tail, dst must lie within it")


class _NativeAllocator:
    def __init__(self, capacity: int):
        self._lib = load_native()
        if self._lib is None:
            raise RuntimeError(
                "Native allocator requested but the C++ runtime is "
                "unavailable (no toolchain or VROD_DISABLE_NATIVE)")
        self._h = self._lib.vrod_alloc_new(capacity)
        if not self._h:
            raise MemoryError("Allocator allocation failed (host OOM)")

    def __del__(self):
        try:
            if getattr(self, "_h", None):
                self._lib.vrod_alloc_free(self._h)
                self._h = None
        except Exception:
            pass

    @staticmethod
    def _u64buf(arr: np.ndarray):
        arr = np.ascontiguousarray(arr, dtype=np.uint64)
        return arr, arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))

    @property
    def capacity(self) -> int:
        return self._lib.vrod_alloc_capacity(self._h)

    @property
    def live_count(self) -> int:
        return self._lib.vrod_alloc_live_count(self._h)

    @property
    def free_count(self) -> int:
        return self._lib.vrod_alloc_free_count(self._h)

    @property
    def high_water(self) -> int:
        return self._lib.vrod_alloc_high_water(self._h)

    def grow(self, new_capacity: int) -> None:
        rc = self._lib.vrod_alloc_grow(self._h, new_capacity)
        if rc == -2:
            raise MemoryError("Allocator grow failed (host OOM)")
        if rc != 0:
            raise ValueError("grow must not shrink capacity")

    def shrink(self, new_capacity: int) -> None:
        rc = self._lib.vrod_alloc_shrink(self._h, new_capacity)
        if rc == -1:
            raise ValueError("shrink must not grow capacity")
        if rc == -2:
            raise ValueError("live slots beyond the new capacity")

    def acquire(self, ids: np.ndarray) -> np.ndarray:
        ids, idp = self._u64buf(ids)
        out = np.empty(ids.size, dtype=np.uint64)
        rc = self._lib.vrod_alloc_acquire(
            self._h, ids.size, idp,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)))
        if rc == -1:
            raise MemoryError("Insufficient capacity (grow first)")
        if rc == -2:
            raise KeyError("A record id is already bound")
        return out

    def release(self, ids: np.ndarray) -> np.ndarray:
        ids, idp = self._u64buf(ids)
        out = np.empty(ids.size, dtype=np.uint64)
        self._lib.vrod_alloc_release(
            self._h, ids.size, idp,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)))
        return out  # NO_ID marks unknown ids

    def slot_of(self, record_id: int) -> int:
        return self._lib.vrod_alloc_slot_of(self._h, record_id)

    def id_of(self, slot: int) -> int:
        return self._lib.vrod_alloc_id_of(self._h, slot)

    def ids_of(self, slots: np.ndarray) -> np.ndarray:
        """Bulk slot->id mapping; NO_ID for unbound/out-of-range slots."""
        slots, sp = self._u64buf(slots)
        out = np.empty(slots.size, dtype=np.uint64)
        self._lib.vrod_alloc_ids_of(
            self._h, slots.size, sp,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)))
        return out

    def slots_of(self, ids: np.ndarray) -> np.ndarray:
        """Bulk id->slot mapping; NO_ID for unknown ids (filtered search)."""
        ids, idp = self._u64buf(ids)
        out = np.empty(ids.size, dtype=np.uint64)
        self._lib.vrod_alloc_slots_of(
            self._h, ids.size, idp,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)))
        return out

    def is_live(self, slot: int) -> bool:
        return bool(self._lib.vrod_alloc_is_live(self._h, slot))

    def live_slots(self) -> np.ndarray:
        out = np.empty(self.live_count, dtype=np.uint64)
        n = self._lib.vrod_alloc_live_slots(
            self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)))
        return out[:n]

    def plan_compaction(self) -> tuple[np.ndarray, np.ndarray]:
        # Moves are bounded by min(live, tail - live): only live slots
        # beyond the packed tail move, and each needs a hole below it —
        # capacity-sized scratch would transiently cost ~160 MB at 10M.
        live = self.live_count
        bound = min(live, max(self.high_water - live, 0))
        src = np.empty(bound, dtype=np.uint64)
        dst = np.empty(bound, dtype=np.uint64)
        n = self._lib.vrod_alloc_plan_compaction(
            self._h,
            src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            dst.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)))
        return src[:n].copy(), dst[:n].copy()

    def apply_compaction(self, src: np.ndarray, dst: np.ndarray) -> None:
        _check_full_plan(self.live_count, self.live_slots(), src, dst)
        src, sp = self._u64buf(src)
        dst, dp = self._u64buf(dst)
        if self._lib.vrod_alloc_apply_compaction(self._h, src.size, sp, dp) != 0:
            raise ValueError("Invalid compaction plan")


class _PyAllocator:
    """Pure-Python allocator (identical semantics to the C++ one)."""

    def __init__(self, capacity: int):
        self._capacity = capacity
        self._tail = 0
        self._free: list[int] = []
        self._slot_to_id: dict[int, int] = {}
        self._id_to_slot: dict[int, int] = {}

    @property
    def capacity(self) -> int:
        return self._capacity

    @property
    def live_count(self) -> int:
        return len(self._id_to_slot)

    @property
    def free_count(self) -> int:
        return len(self._free) + (self._capacity - self._tail)

    @property
    def high_water(self) -> int:
        return self._tail

    def grow(self, new_capacity: int) -> None:
        if new_capacity < self._capacity:
            raise ValueError("grow must not shrink capacity")
        self._capacity = new_capacity

    def shrink(self, new_capacity: int) -> None:
        if new_capacity > self._capacity:
            raise ValueError("shrink must not grow capacity")
        if any(s >= new_capacity for s in self._slot_to_id):
            raise ValueError("live slots beyond the new capacity")
        self._free = [s for s in self._free if s < new_capacity]
        self._tail = min(self._tail, new_capacity)
        self._capacity = new_capacity

    def acquire(self, ids: np.ndarray) -> np.ndarray:
        ids = np.ascontiguousarray(ids, dtype=np.uint64)
        if self.free_count < ids.size:
            raise MemoryError("Insufficient capacity (grow first)")
        seen: set[int] = set()
        for rid in ids:
            rid = int(rid)
            # Duplicates WITHIN the batch are as corrupting as collisions
            # with existing bindings (two slots would map to one id).
            if rid in self._id_to_slot or rid in seen:
                raise KeyError("A record id is already bound")
            seen.add(rid)
        out = np.empty(ids.size, dtype=np.uint64)
        for i, rid in enumerate(ids):
            rid = int(rid)
            slot = self._free.pop() if self._free else self._tail
            if slot == self._tail:
                self._tail += 1
            self._slot_to_id[slot] = rid
            self._id_to_slot[rid] = slot
            out[i] = slot
        return out

    def release(self, ids: np.ndarray) -> np.ndarray:
        ids = np.ascontiguousarray(ids, dtype=np.uint64)
        out = np.full(ids.size, NO_ID, dtype=np.uint64)
        for i, rid in enumerate(ids):
            rid = int(rid)
            slot = self._id_to_slot.pop(rid, None)
            if slot is None:
                continue
            del self._slot_to_id[slot]
            self._free.append(slot)
            out[i] = slot
        return out

    def slot_of(self, record_id: int) -> int:
        return self._id_to_slot.get(record_id, NO_ID)

    def id_of(self, slot: int) -> int:
        return self._slot_to_id.get(slot, NO_ID)

    def ids_of(self, slots: np.ndarray) -> np.ndarray:
        return np.array([self._slot_to_id.get(int(s), NO_ID)
                         for s in np.asarray(slots).ravel()], dtype=np.uint64)

    def slots_of(self, ids: np.ndarray) -> np.ndarray:
        return np.array([self._id_to_slot.get(int(r), NO_ID)
                         for r in np.asarray(ids).ravel()], dtype=np.uint64)

    def is_live(self, slot: int) -> bool:
        return slot in self._slot_to_id

    def live_slots(self) -> np.ndarray:
        return np.array(sorted(self._slot_to_id), dtype=np.uint64)

    def plan_compaction(self) -> tuple[np.ndarray, np.ndarray]:
        live = self.live_count
        holes = [s for s in range(live) if s not in self._slot_to_id]
        src, dst = [], []
        hi = 0
        for s in range(self._tail - 1, live - 1, -1):
            if s in self._slot_to_id:
                src.append(s)
                dst.append(holes[hi])
                hi += 1
        return np.array(src, dtype=np.uint64), np.array(dst, dtype=np.uint64)

    def apply_compaction(self, src: np.ndarray, dst: np.ndarray) -> None:
        _check_full_plan(self.live_count, self.live_slots(), src, dst)
        for s, d in zip(src.tolist(), dst.tolist()):
            rid = self._slot_to_id.get(int(s))
            if rid is None or int(d) in self._slot_to_id:
                raise ValueError("Invalid compaction plan")
            del self._slot_to_id[int(s)]
            self._slot_to_id[int(d)] = rid
            self._id_to_slot[rid] = int(d)
        self._tail = self.live_count
        self._free.clear()


def SlotAllocator(capacity: int, native: bool | None = None):
    if native is None:
        native = load_native() is not None
    return _NativeAllocator(capacity) if native else _PyAllocator(capacity)
