"""WAL framing/replay tests (C++ + Python implementations, cross-compatible).

``tests/test_wal.py`` (30 tests) over ``vrod_tpu_torch``: the same cases,
oracles and parameters; both implementations (``IMPLS``: the port's
Python WAL and its C++ one from ``vrod_tpu_torch/_native``) run every
case. Imports rewritten only.
"""

import numpy as np
import pytest

from vrod_tpu_torch._native.build import load_native
from vrod_tpu_torch.wal import Wal, ops

NATIVE_AVAILABLE = load_native() is not None
IMPLS = [False] + ([True] if NATIVE_AVAILABLE else [])


def test_native_built():
    # The build env has g++; the C++ fast path must actually be in play —
    # unless this run is the deliberate pure-Python fallback leg.
    import os
    if os.environ.get("VROD_DISABLE_NATIVE") == "1":
        pytest.skip("fallback leg: native disabled by env")
    assert NATIVE_AVAILABLE


@pytest.mark.parametrize("native", IMPLS)
def test_append_replay(tmp_path, native):
    w = Wal(tmp_path / "vr_wal", native=native)
    l1 = w.append(b"alpha", sync=True)
    l2 = w.append(b"beta")
    assert (l1, l2) == (1, 2)
    assert w.frame_count == 2
    assert w.last_lsn == 2
    assert [(l, p) for l, p in w.replay()] == [(1, b"alpha"), (2, b"beta")]
    w.close()


@pytest.mark.parametrize("native", IMPLS)
def test_reopen_persists(tmp_path, native):
    p = tmp_path / "vr_wal"
    w = Wal(p, native=native)
    w.append(b"one", sync=True)
    w.close()
    w2 = Wal(p, native=native)
    assert w2.frame_count == 1
    assert w2.append(b"two") == 2
    w2.close()


@pytest.mark.skipif(not NATIVE_AVAILABLE, reason="no C++ toolchain")
def test_cross_implementation_compat(tmp_path):
    p = tmp_path / "vr_wal"
    w = Wal(p, native=True)
    w.append(b"from-native", sync=True)
    w.close()
    w = Wal(p, native=False)
    w.append(b"from-python", sync=True)
    assert [p for _, p in w.replay()] == [b"from-native", b"from-python"]
    w.close()
    w = Wal(p, native=True)
    assert [p for _, p in w.replay()] == [b"from-native", b"from-python"]
    w.close()


@pytest.mark.parametrize("native", IMPLS)
def test_torn_tail_detection_and_repair(tmp_path, native):
    p = tmp_path / "vr_wal"
    w = Wal(p, native=native)
    w.append(b"good", sync=True)
    w.close()
    # Simulate a crash mid-append: a frame header with no payload behind it.
    with open(p, "ab") as f:
        f.write(b"\x57\x4c\x5f\x31" + b"\x00" * 16)  # magic + garbage header
    w = Wal(p, native=native)
    assert w.frame_count == 1  # torn frame excluded from the durable prefix
    assert w.has_torn_tail
    w.repair()
    assert not w.has_torn_tail
    # Appending after repair lands cleanly.
    w.append(b"next", sync=True)
    assert [p_ for _, p_ in w.replay()] == [b"good", b"next"]
    w.close()


@pytest.mark.parametrize("native", IMPLS)
def test_corrupt_crc_stops_replay(tmp_path, native):
    p = tmp_path / "vr_wal"
    w = Wal(p, native=native)
    w.append(b"aaaa", sync=True)
    w.append(b"bbbb", sync=True)
    w.close()
    data = bytearray(p.read_bytes())
    data[-1] ^= 0xFF  # flip a payload byte of the second frame
    p.write_bytes(bytes(data))
    w = Wal(p, native=native)
    assert w.frame_count == 1
    assert [pl for _, pl in w.replay()] == [b"aaaa"]
    w.close()


@pytest.mark.parametrize("native", IMPLS)
def test_truncate(tmp_path, native):
    w = Wal(tmp_path / "vr_wal", native=native)
    w.append(b"x", sync=True)
    w.append(b"y", sync=True)
    w.truncate()
    assert w.frame_count == 0
    # lsn keeps increasing after truncation (global replay ordering).
    assert w.append(b"z") == 3
    w.close()


@pytest.mark.parametrize("native", IMPLS)
def test_torn_tail_overwritten_by_append(tmp_path, native):
    p = tmp_path / "vr_wal"
    w = Wal(p, native=native)
    w.append(b"keep", sync=True)
    w.close()
    with open(p, "ab") as f:
        f.write(b"\xde\xad\xbe\xef" * 10)
    w = Wal(p, native=native)
    w.append(b"after-crash", sync=True)
    w.close()
    w = Wal(p, native=native)
    assert [pl for _, pl in w.replay()] == [b"keep", b"after-crash"]
    w.close()


def test_op_encoding_roundtrip():
    vec = np.arange(5, dtype=np.float32)
    for op in [
        ops.InsertOp(42, vec, "payload ; with ; semis"),
        ops.UpdateOp(7, vec * 2, ""),
        ops.DeleteOp(99),
        ops.CreateCollectionOp({"name": "c", "dim": 4}),
        ops.DropCollectionOp("c"),
    ]:
        back = ops.decode(ops.encode(op))
        assert type(back) is type(op)
        for f in op.__dataclass_fields__:
            a, b = getattr(op, f), getattr(back, f)
            if isinstance(a, np.ndarray):
                np.testing.assert_array_equal(a, b)
            else:
                assert a == b


def test_bulk_op_roundtrip():
    ids = np.array([5, 6, 7], dtype=np.uint64)
    vecs = np.random.default_rng(0).standard_normal((3, 8)).astype(np.float32)
    payloads = ["a", "", "unicode: éß"]
    back = ops.decode(ops.encode(ops.BulkOp(ids, vecs, payloads)))
    np.testing.assert_array_equal(back.record_ids, ids)
    np.testing.assert_array_equal(back.vectors, vecs)
    assert back.payloads == payloads


@pytest.mark.parametrize("native", IMPLS)
def test_truncate_until_keeps_tail(tmp_path, native):
    p = tmp_path / "vr_wal"
    w = Wal(p, native=native)
    for i in range(5):
        w.append(f"op{i}".encode(), sync=True)
    w.truncate_until(3)  # drop lsn 1..3, keep 4..5
    assert [(l, pl) for l, pl in w.replay()] == [(4, b"op3"), (5, b"op4")]
    assert w.append(b"after") == 6  # lsn continues
    w.close()
    # Survives a reopen (the rewrite was renamed durably into place).
    w2 = Wal(p, native=native)
    assert [(l, pl) for l, pl in w2.replay()] == [
        (4, b"op3"), (5, b"op4"), (6, b"after")]
    w2.close()


@pytest.mark.parametrize("native", IMPLS)
def test_truncate_until_all_and_none(tmp_path, native):
    w = Wal(tmp_path / "vr_wal", native=native)
    w.append(b"a", sync=True)
    w.append(b"b", sync=True)
    w.truncate_until(0)  # no-op
    assert w.frame_count == 2
    w.truncate_until(99)  # drops everything
    assert w.frame_count == 0
    assert w.append(b"c") == 3  # lsn still monotonic in-process
    w.close()


@pytest.mark.parametrize("native", IMPLS)
def test_rewind_unacked_append(tmp_path, native):
    w = Wal(tmp_path / "vr_wal", native=native)
    w.append(b"keep", sync=True)
    pre = w.valid_size
    w.append(b"failed-apply", sync=True)
    w.rewind(pre)
    assert [pl for _, pl in w.replay()] == [b"keep"]
    # The rewound lsn is not reused (monotonicity).
    assert w.append(b"next") == 3
    w.close()


@pytest.mark.parametrize("native", IMPLS)
def test_seed_lsn(tmp_path, native):
    w = Wal(tmp_path / "vr_wal", native=native)
    w.seed_lsn(41)
    assert w.append(b"x") == 42
    w.seed_lsn(10)  # can only move forward
    assert w.append(b"y") == 43
    w.close()


@pytest.mark.parametrize("native", IMPLS)
def test_leftover_tmp_cleaned_on_open(tmp_path, native):
    p = tmp_path / "vr_wal"
    w = Wal(p, native=native)
    w.append(b"real", sync=True)
    w.close()
    (tmp_path / "vr_wal.tmp").write_bytes(b"garbage from crashed rewrite")
    w2 = Wal(p, native=native)
    assert [pl for _, pl in w2.replay()] == [b"real"]
    assert not (tmp_path / "vr_wal.tmp").exists()
    w2.close()


@pytest.mark.parametrize("native", IMPLS)
def test_set_next_lsn_force_and_refuse(tmp_path, native):
    """Replication contract: the next lsn can be forced forward OR back to
    an unused value (a rewound apply's retry), but never onto an lsn an
    indexed frame already holds."""
    from vrod_tpu_torch.errors import WalError
    w = Wal(tmp_path / "vr_wal", native=native)
    w.append(b"a")                 # lsn 1
    w.set_next_lsn(10)
    assert w.append(b"b") == 10    # forced forward (primary gap)
    pre = w.valid_size
    w.set_next_lsn(12)
    assert w.append(b"c") == 12
    w.rewind(pre)                  # failed apply: frame 12 removed
    w.set_next_lsn(12)             # retry reuses the consumed lsn
    assert w.append(b"c2") == 12
    with pytest.raises(WalError):
        w.set_next_lsn(12)         # duplicate of an indexed frame
    with pytest.raises(WalError):
        w.set_next_lsn(5)
    assert [(l, p) for l, p in w.replay()] == \
        [(1, b"a"), (10, b"b"), (12, b"c2")]
    w.close()
    # Reopen: the forced lsns survive the rescan.
    w = Wal(tmp_path / "vr_wal", native=native)
    assert w.last_lsn == 12
    w.close()


@pytest.mark.parametrize("native", IMPLS)
def test_replay_from(tmp_path, native):
    """Replication tails must not re-read the whole log: replay_from yields
    exactly the frames with lsn > after, matching a filtered full replay."""
    w = Wal(tmp_path / "vr_wal", native=native)
    for i in range(20):
        w.append(f"p{i}".encode())
    w.set_next_lsn(50)  # lsn gap, like a primary that rewound failed ops
    w.append(b"tail")
    full = list(w.replay())
    for after in (0, 1, 7, 19, 20, 49, 50, 99):
        got = list(w.replay_from(after))
        assert got == [(l, p) for l, p in full if l > after], after
    w.close()
