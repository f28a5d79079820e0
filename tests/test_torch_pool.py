"""The port's read-scaling pool (``vrod_tpu_torch.pool``): the cases of
``tests/test_pool.py`` over the port's servers and replicas on the CPU.
"""

import numpy as np
import pytest

from vrod_tpu_torch.client import VrodClient, VrodConnectionError
from vrod_tpu_torch.database import Database
from vrod_tpu_torch.pool import VrodPool
from vrod_tpu_torch.replication import Replicator
from vrod_tpu_torch.server import VrodServer

DIM = 8


@pytest.fixture
def tmp_db(tmp_path):
    """The port's Database (conftest's ``tmp_db`` is the JAX package's)."""
    db = Database.new(tmp_path, "testdb")
    yield db
    db.close()


@pytest.fixture
def cluster(tmp_db, tmp_path):
    """Primary + two replicas, all live, replication slow enough that
    read-your-writes actually exercises min_position."""
    col = tmp_db.create_collection("c", dim=DIM, segment_rows=64)
    col.bulk_insert(np.eye(DIM, dtype=np.float32),
                    [f"e{i}" for i in range(DIM)])
    pserver = VrodServer(tmp_db, f"unix:{tmp_path}/p.sock").start()
    reps, rservers, rdbs = [], [], []
    for i in range(2):
        rdb = Database.new(tmp_path / f"r{i}", "rdb")
        rep = Replicator(rdb, pserver.address, poll_interval_s=0.4).start()
        rs = VrodServer(rdb, f"unix:{tmp_path}/r{i}.sock",
                        read_only=True).start()
        rs.attach_replicator(rep)
        rep.wait_caught_up()
        reps.append(rep); rservers.append(rs); rdbs.append(rdb)
    yield pserver, rservers
    for rs in rservers:
        rs.close()
    for rdb in rdbs:
        rdb.close()
    pserver.close()


def test_pool_reads_spread_and_ryw(cluster):
    pserver, rservers = cluster
    with VrodPool(pserver.address,
                  [rs.address for rs in rservers]) as pool:
        # Read-your-writes: the fresh insert is immediately visible via a
        # replica read (the pool threads min_position automatically).
        vec = np.full(DIM, 0.5, np.float32)
        rid = pool.insert("c", vec, "fresh")
        hits = pool.search_similar("c", vec, k=1)
        assert hits[0].record_id == rid and hits[0].payload == "fresh"
        v, payload = pool.get("c", rid)
        assert payload == "fresh"
        assert pool.position("c") > 0


def test_pool_failover_and_recovery(cluster, tmp_path):
    pserver, rservers = cluster
    with VrodPool(pserver.address, [rs.address for rs in rservers],
                  cooldown_s=0.3) as pool:
        rid = pool.insert("c", np.ones(DIM, np.float32), "x")
        # Kill one replica server: reads keep working via the other.
        rservers[0].close()
        for _ in range(6):
            assert pool.get("c", rid)[1] == "x"
        # Kill the second too: reads fall back to the primary.
        rservers[1].close()
        for _ in range(3):
            assert pool.get("c", rid)[1] == "x"


def test_pool_all_down_is_clean(tmp_path):
    pool = VrodPool(f"unix:{tmp_path}/nope.sock",
                    [f"unix:{tmp_path}/nope2.sock"])
    with pytest.raises(VrodConnectionError, match="No endpoint reachable"):
        pool.ping()


def test_pool_writes_never_fail_over(cluster):
    """A dead primary must fail writes loudly — never retry them against
    a replica (duplicate-mutation hazard) or silently drop them."""
    pserver, rservers = cluster
    with VrodPool(pserver.address,
                  [rs.address for rs in rservers]) as pool:
        pserver.close()
        with pytest.raises((VrodConnectionError, OSError)):
            pool.insert("c", np.ones(DIM, np.float32), "lost")
        # Reads still work off the replicas.
        assert pool.search_similar(
            "c", np.eye(DIM, dtype=np.float32)[0], k=1)[0].payload == "e0"


def test_read_order_puts_cooling_after_primary(tmp_path):
    import time
    pool = VrodPool(f"unix:{tmp_path}/p.sock",
                    [f"unix:{tmp_path}/a.sock", f"unix:{tmp_path}/b.sock"])
    a, b = pool._replicas
    a.down_until = time.monotonic() + 60  # cooling
    order = pool._read_order()
    assert order.index(pool._primary) < order.index(a)
    assert order.index(b) < order.index(pool._primary)


def test_pool_fails_over_on_graceful_shutdown_answer(tmp_db, tmp_path):
    """A draining replica answers ok:false 'shutting down' on a live,
    ALREADY-ESTABLISHED connection (its handler entered readline before
    the flag was set); idempotent reads must fail over, not error out."""
    col = tmp_db.create_collection("c", dim=DIM, segment_rows=64)
    rid = int(col.bulk_insert(np.eye(DIM, dtype=np.float32)[:1], ["x"])[0])
    pserver = VrodServer(tmp_db, f"unix:{tmp_path}/p.sock").start()
    rdb = Database.new(tmp_path / "r", "rdb")
    rep = Replicator(rdb, pserver.address, poll_interval_s=0.05).start()
    rserver = VrodServer(rdb, f"unix:{tmp_path}/r.sock",
                         read_only=True).start()
    try:
        rep.wait_caught_up()
        with VrodPool(pserver.address, [rserver.address]) as pool:
            # Establish the replica connection with a successful read
            # (rotation order with one replica: [replica, primary]).
            assert pool.get("c", rid)[1] == "x"
            # Drain: the blocked handler answers in-flight requests with
            # the ok:false shutdown error on the live socket.
            rserver._closing.set()
            for _ in range(3):
                assert pool.get("c", rid)[1] == "x"  # failed over
            assert pool._replicas[0].down_until > 0  # replica cooled
    finally:
        rserver.close()
        rep.stop()
        rdb.close()
        pserver.close()
