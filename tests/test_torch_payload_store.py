"""Disk-backed payload store: bounded-RAM live payload view (sqlite).

Durability stays with the WAL/snapshot layer; the disk store is a
rebuildable cache, so these tests focus on view correctness across every
mutation path and on restore repopulation.

``tests/test_payload_store.py`` (8 tests) over ``vrod_tpu_torch``: the same
cases and oracles; imports rewritten, and ``tmp_db`` is the port's
database (conftest's is the JAX package's)."""

import numpy as np
import pytest

from vrod_tpu_torch.payload_store import DiskPayloadStore, MemoryPayloadStore


@pytest.fixture
def tmp_db(tmp_path):
    """The port's database (conftest's ``tmp_db`` is the JAX package's)."""
    from vrod_tpu_torch.database import Database
    db = Database.new(tmp_path, "testdb")
    yield db
    db.close()


@pytest.mark.parametrize("make", [
    lambda p: MemoryPayloadStore(),
    lambda p: DiskPayloadStore(p / "p.db"),
])
def test_store_unit_surface(tmp_path, make):
    s = make(tmp_path)
    s[1] = "one"
    s.set_many([2, 3, 4], ["two", "three", "four"])
    assert s.get(1) == "one"
    assert s.get(99, "dflt") == "dflt"
    assert s.get_many([1, 3, 99]) == {1: "one", 3: "three"}
    s.pop(1)
    s.delete_many([2, 3])
    assert s.get_many([1, 2, 3, 4]) == {4: "four"}
    assert len(s) == 1
    s[4] = "FOUR"  # overwrite
    assert s.get(4) == "FOUR"
    s.close()


def test_disk_store_truncates_on_reopen(tmp_path):
    s = DiskPayloadStore(tmp_path / "p.db")
    s.set_many([1, 2], ["a", "b"])
    s.close()
    s2 = DiskPayloadStore(tmp_path / "p.db")  # rebuildable cache semantics
    assert len(s2) == 0
    s2.close()


def test_collection_disk_payloads_end_to_end(tmp_path, rng):
    from vrod_tpu_torch.database import Database
    db = Database.new(tmp_path, "pdb")
    col = db.create_collection("c", dim=16, segment_rows=64,
                               payload_store="disk")
    assert (col.path / "payloads.db").exists()
    vecs = rng.standard_normal((120, 16)).astype(np.float32)
    payloads = [f"payéload\n{i};x" for i in range(120)]
    rids = col.bulk_insert(vecs, payloads=payloads)

    hits = col.search_similar(vecs[17], k=1)
    assert hits[0].payload == payloads[17]
    assert col.get(int(rids[3])).payload == payloads[3]

    col.update(int(rids[4]), vecs[4], "edited")
    assert col.get(int(rids[4])).payload == "edited"
    col.delete(int(rids[5]))
    col.delete_many(rids[6:9])

    col.snapshot()
    db.close()

    db2 = Database.load(tmp_path / "pdb")
    col2 = db2.collection("c")
    assert col2.config.payload_store == "disk"
    assert col2.count == 120 - 4
    assert col2.get(int(rids[3])).payload == payloads[3]
    assert col2.get(int(rids[4])).payload == "edited"
    hits = col2.search_similar(vecs[17], k=1)
    assert hits[0].payload == payloads[17]
    db2.close()


def test_cli_create_payload_store_option(tmp_db):
    from vrod_tpu_torch.commands.builder import CommandBuilder
    cb = CommandBuilder(tmp_db)
    cb.build(None, "CREATE", "dsk;dim=8;payload_store=disk").execute()
    assert tmp_db.collection("dsk").config.payload_store == "disk"
    from vrod_tpu_torch.errors import ConfigError
    with pytest.raises(ConfigError):
        cb.build(None, "CREATE", "bad;dim=8;payload_store=nope").execute()


def test_disk_pop_returns_removed_value(tmp_path):
    s = DiskPayloadStore(tmp_path / "q.db")
    s[7] = "seven"
    assert s.pop(7) == "seven"
    assert s.pop(7, "gone") == "gone"
    s.close()


def test_disk_store_recovers_from_corrupt_file(tmp_path):
    """journal/synchronous are OFF, so a crash can corrupt payloads.db.
    The store is a rebuildable cache: opening over a corrupt file must
    discard it and start empty, not wedge collection load forever."""
    p = tmp_path / "p.db"
    p.write_bytes(b"definitely not a sqlite database" * 64)
    s = DiskPayloadStore(p)
    assert len(s) == 0
    s[1] = "alive"
    assert s.get(1) == "alive"
    s.close()


def test_disk_store_recovers_from_corrupt_header_with_valid_magic(tmp_path):
    """Corruption that keeps the 16-byte sqlite magic but breaks the
    schema page surfaces on the first statement, not connect()."""
    p = tmp_path / "p.db"
    s = DiskPayloadStore(p)
    s.set_many([1, 2], ["a", "b"])
    s.close()
    raw = bytearray(p.read_bytes())
    raw[100:] = b"\xff" * (len(raw) - 100)  # keep header magic, trash pages
    p.write_bytes(bytes(raw))
    s2 = DiskPayloadStore(p)
    assert len(s2) == 0
    s2[3] = "c"
    assert s2.get(3) == "c"
    s2.close()
