"""Replication convergence fuzz (random op mixes incl. maintenance).

The port of ``experiments/fuzz_replication.py``: the same op mix, seeds and
invariants over ``vrod_tpu_torch``, on ``runtime.default_device()`` (the
card, or the CPU under ``VROD_PLATFORM=cpu``).

Usage:
    VROD_PLATFORM=cpu python3 tools/fuzz_replication.py 0 20

Each seed: 80 random ops on a served primary (bulk insert / bulk delete /
update / snapshot / REINDEX / replica restart) with auto-snapshot enabled,
asserting the replica is bit-identical every 20 steps.

The JAX harness records seeds 0-199 passing after the fix below (this
harness's campaigns are in PERF.md); before it, seed 6 hung forever — snapshots cut on an ALREADY-EMPTY WAL recorded
last_lsn=0 (losing the durable LSN high-water), which reset LSN assignment
after restore and trapped replication in a drop/bootstrap/resync loop
(909 cycles observed). Fixed in collection._snapshot_impl
(max(wal.last_lsn, _wal_floor)); regression tests in tests/.
"""
import os, sys, time
import pathlib, sys as _s; _s.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import tempfile
from pathlib import Path
import numpy as np
from vrod_tpu_torch.database import Database
from vrod_tpu_torch.replication import Replicator
from vrod_tpu_torch.server import VrodServer

DIM = 8

def assert_identical(p, r, seed, step):
    assert r.count == p.count, (seed, step, r.count, p.count)
    pi = np.sort(p.alloc.ids_of(p.alloc.live_slots().astype(np.uint64)))
    ri = np.sort(r.alloc.ids_of(r.alloc.live_slots().astype(np.uint64)))
    np.testing.assert_array_equal(pi, ri)
    for rid in pi[:: max(1, len(pi) // 6)].tolist():
        a, b = p.get(int(rid)), r.get(int(rid))
        np.testing.assert_array_equal(a.vector, b.vector)
        assert a.payload == b.payload, (seed, step, rid)

def run_seed(seed, steps=80):
    tmp = Path(tempfile.mkdtemp(prefix=f"fuzz{seed}_"))
    db = Database.new(tmp, "pdb")
    # Rotate the storage tier by seed: replication ships stored bytes, so
    # every dtype (incl. the packed int4 tier) must stay bit-identical
    # across bootstrap + tail + resync.
    dtype = ("float32", "bfloat16", "int8", "int4")[seed % 4]
    col = db.create_collection("c", dim=DIM, segment_rows=64, dtype=dtype,
                               auto_snapshot_wal_bytes=6000)
    server = VrodServer(db, f"unix:{tmp}/p.sock").start()
    rng = np.random.default_rng(seed)
    rdb = Database.new(tmp / "r", "rdb")
    rep = Replicator(rdb, server.address, poll_interval_s=0.02).start()
    live = []
    try:
        for step in range(steps):
            roll = rng.random()
            if roll < 0.40 or not live:
                n = int(rng.integers(1, 8))
                ids = col.bulk_insert(
                    rng.standard_normal((n, DIM)).astype(np.float32),
                    [f"s{step}-{i}" for i in range(n)])
                live.extend(int(i) for i in ids)
            elif roll < 0.58:
                k = min(len(live), int(rng.integers(1, 4)))
                victims = [live.pop(int(rng.integers(0, len(live))))
                           for _ in range(k)]
                col.delete_many(victims)
            elif roll < 0.72:
                t = live[int(rng.integers(0, len(live)))]
                col.update(t, rng.standard_normal(DIM).astype(np.float32),
                           f"u{step}")
            elif roll < 0.80:
                col.snapshot()
            elif roll < 0.86:
                col.reindex()
            else:
                rep.stop(); rdb.close()
                rdb = Database.load(tmp / "r" / "rdb")
                rep = Replicator(rdb, server.address,
                                 poll_interval_s=0.02).start()
            if step % 20 == 19:
                rep.wait_caught_up(timeout=120)
                assert_identical(col, rdb.collection("c"), seed, step)
        rep.wait_caught_up(timeout=120)
        assert_identical(col, rdb.collection("c"), seed, steps)
    finally:
        rep.stop(); rdb.close(); server.close(); db.close()
        import shutil; shutil.rmtree(tmp, ignore_errors=True)

if __name__ == "__main__":
    t0 = time.time()
    for seed in range(int(sys.argv[1]), int(sys.argv[2])):
        s = time.time()
        run_seed(seed)
        print(f"seed {seed} OK ({time.time()-s:.1f}s)", flush=True)
    print(f"ALL SEEDS PASSED in {time.time()-t0:.0f}s", flush=True)
