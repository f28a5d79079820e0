"""Slot allocator invariants: free-list reuse, bitmap, compaction.

Property test runs the C++ and Python implementations in lockstep on a
randomized op sequence and asserts identical observable state.

``tests/test_allocator.py`` (13 tests) over ``vrod_tpu_torch`` (its
``allocator`` and the C++ allocator of ``vrod_tpu_torch/_native``): the
same cases, oracles and parameters; imports rewritten only.
"""

import numpy as np
import pytest

from vrod_tpu_torch._native.build import load_native
from vrod_tpu_torch.allocator import NO_ID, SlotAllocator

NATIVE_AVAILABLE = load_native() is not None
IMPLS = [False] + ([True] if NATIVE_AVAILABLE else [])


@pytest.mark.parametrize("native", IMPLS)
def test_basic_acquire_release(native):
    a = SlotAllocator(8, native=native)
    slots = a.acquire(np.array([10, 11, 12], dtype=np.uint64))
    assert sorted(slots.tolist()) == [0, 1, 2]
    assert a.live_count == 3 and a.high_water == 3
    assert a.slot_of(11) == slots[1]
    assert a.id_of(int(slots[2])) == 12
    assert a.is_live(int(slots[0]))

    out = a.release(np.array([11], dtype=np.uint64))
    assert out[0] == slots[1]
    assert a.live_count == 2
    assert not a.is_live(int(slots[1]))
    assert a.slot_of(11) == NO_ID

    # Freed slot is recycled before the tail advances.
    s2 = a.acquire(np.array([13], dtype=np.uint64))
    assert s2[0] == slots[1]
    assert a.high_water == 3


@pytest.mark.parametrize("native", IMPLS)
def test_capacity_and_grow(native):
    a = SlotAllocator(2, native=native)
    a.acquire(np.array([1, 2], dtype=np.uint64))
    with pytest.raises(MemoryError):
        a.acquire(np.array([3], dtype=np.uint64))
    a.grow(4)
    a.acquire(np.array([3], dtype=np.uint64))
    assert a.capacity == 4 and a.live_count == 3
    with pytest.raises(ValueError):
        a.grow(2)


@pytest.mark.parametrize("native", IMPLS)
def test_duplicate_id_rejected(native):
    a = SlotAllocator(4, native=native)
    a.acquire(np.array([7], dtype=np.uint64))
    with pytest.raises(KeyError):
        a.acquire(np.array([7], dtype=np.uint64))


@pytest.mark.parametrize("native", IMPLS)
def test_release_unknown_is_noop(native):
    a = SlotAllocator(4, native=native)
    out = a.release(np.array([123], dtype=np.uint64))
    assert out[0] == NO_ID
    assert a.live_count == 0


@pytest.mark.parametrize("native", IMPLS)
def test_compaction(native):
    a = SlotAllocator(16, native=native)
    ids = np.arange(100, 110, dtype=np.uint64)
    a.acquire(ids)
    a.release(np.array([100, 103, 105, 109], dtype=np.uint64))
    src, dst = a.plan_compaction()
    # All moves pack into [0, live_count).
    live = a.live_count
    assert all(d < live for d in dst.tolist())
    assert all(s >= live for s in src.tolist())
    a.apply_compaction(src, dst)
    assert a.high_water == live
    assert sorted(a.live_slots().tolist()) == list(range(live))
    # id bindings survive the moves
    for rid in [101, 102, 104, 106, 107, 108]:
        assert a.id_of(int(a.slot_of(rid))) == rid


@pytest.mark.skipif(not NATIVE_AVAILABLE, reason="no C++ toolchain")
def test_property_native_matches_python(rng):
    an = SlotAllocator(64, native=True)
    ap = SlotAllocator(64, native=False)
    next_id = 0
    live = set()
    for step in range(300):
        op = rng.integers(0, 10)
        if op < 5 and len(live) < 60:
            n = int(rng.integers(1, 5))
            ids = np.arange(next_id, next_id + n, dtype=np.uint64)
            next_id += n
            sn, sp = an.acquire(ids), ap.acquire(ids)
            np.testing.assert_array_equal(sn, sp)
            live.update(ids.tolist())
        elif op < 8 and live:
            pick = rng.choice(sorted(live), size=min(len(live), 2), replace=False)
            ids = np.array(pick, dtype=np.uint64)
            np.testing.assert_array_equal(an.release(ids), ap.release(ids))
            live.difference_update(ids.tolist())
        else:
            np.testing.assert_array_equal(an.live_slots(), ap.live_slots())
            sn_src, sn_dst = an.plan_compaction()
            sp_src, sp_dst = ap.plan_compaction()
            np.testing.assert_array_equal(sn_src, sp_src)
            np.testing.assert_array_equal(sn_dst, sp_dst)
            an.apply_compaction(sn_src, sn_dst)
            ap.apply_compaction(sp_src, sp_dst)
        assert an.live_count == ap.live_count == len(live)
        assert an.high_water == ap.high_water


def test_acquire_rejects_duplicate_ids_in_batch():
    """Duplicates WITHIN one acquire batch must raise, not corrupt the
    slot<->id maps (both implementations)."""
    import numpy as np
    import pytest
    from vrod_tpu_torch.allocator import _PyAllocator, SlotAllocator
    for alloc in (_PyAllocator(16), SlotAllocator(16)):
        with pytest.raises(KeyError):
            alloc.acquire(np.array([7, 7], dtype=np.uint64))
        # state untouched: the id is bindable afterwards
        slots = alloc.acquire(np.array([7], dtype=np.uint64))
        assert alloc.live_count == 1
        assert alloc.id_of(int(slots[0])) == 7


def test_shrink_semantics():
    import numpy as np
    import pytest
    from vrod_tpu_torch.allocator import _PyAllocator, SlotAllocator
    for alloc in (_PyAllocator(64), SlotAllocator(64)):
        slots = alloc.acquire(np.arange(1, 11, dtype=np.uint64))  # 10 live
        assert slots.max() < 10
        alloc.shrink(16)
        assert alloc.capacity == 16
        assert alloc.live_count == 10
        # freed-tail slots are gone from the free list; new acquires fit
        s2 = alloc.acquire(np.array([99], dtype=np.uint64))
        assert int(s2[0]) < 16
        with pytest.raises(ValueError, match="live slots"):
            alloc.shrink(5)  # would cut live rows
        with pytest.raises(ValueError, match="must not grow"):
            alloc.shrink(1024)
