"""Cold-stats count fuzz: host-only WAL id-replay vs ground truth.

LISTCOLLECTIONS reports exact counts for collections that were never
loaded by replaying only the WAL ops' id effects over the snapshot's id
set (database._host_only_count — no device restore). This fuzz churns a
collection (bulk inserts, deletes, updates, snapshots, reindex,
auto-snapshot), closes the DB, and checks the cold count against the
authoritative model for many random schedules.

The port of ``experiments/fuzz_cold_count.py``: the same op mix, seeds and
invariants over ``vrod_tpu_torch``, on ``runtime.default_device()`` (the
card, or the CPU under ``VROD_PLATFORM=cpu``).

Usage:
    VROD_PLATFORM=cpu python3 tools/fuzz_cold_count.py 0 30

The JAX harness records seeds 0-129 passing; this harness's campaigns
are in PERF.md.
"""
import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

import pathlib
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
from vrod_tpu_torch.database import Database  # noqa: E402

DIM = 6


def run_seed(seed, steps=60):
    rng = np.random.default_rng(seed)
    tmp = Path(tempfile.mkdtemp(prefix=f"ccfuzz{seed}_"))
    db = Database.new(tmp, "db")
    col = db.create_collection(
        "c", dim=DIM, segment_rows=64,
        auto_snapshot_wal_bytes=int(rng.integers(0, 2)) * 4000)
    live = set()
    for step in range(steps):
        roll = rng.random()
        if roll < 0.5 or not live:
            n = int(rng.integers(1, 7))
            ids = col.bulk_insert(
                rng.standard_normal((n, DIM)).astype(np.float32))
            live.update(int(i) for i in ids)
        elif roll < 0.7:
            k = min(len(live), int(rng.integers(1, 5)))
            victims = rng.choice(sorted(live), size=k, replace=False)
            col.delete_many(victims.tolist())
            live.difference_update(int(v) for v in victims)
        elif roll < 0.8:
            rid = sorted(live)[int(rng.integers(0, len(live)))]
            col.update(rid, rng.standard_normal(DIM).astype(np.float32))
        elif roll < 0.9:
            col.snapshot()
        else:
            col.reindex()
    expect = col.count
    assert expect == len(live), (seed, expect, len(live))
    db.close()

    db = Database.load(tmp / "db")
    try:
        assert not db.is_loaded("c")
        stats = db.collection_stats("c")
        assert not db.is_loaded("c")  # stats must stay host-only
        assert stats["count"] == expect, (seed, stats, expect)
        # And the real restore agrees with the host-only answer.
        assert db.collection("c").count == expect
    finally:
        db.close()
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    lo, hi = int(sys.argv[1]), int(sys.argv[2])
    t0 = time.time()
    for seed in range(lo, hi):
        s = time.time()
        run_seed(seed)
        print(f"seed {seed} OK ({time.time()-s:.1f}s)", flush=True)
    print(f"ALL {hi - lo} SEEDS PASSED in {time.time()-t0:.0f}s", flush=True)
