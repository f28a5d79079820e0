"""Backup-under-chaos fuzz: every image must load and contain every
record acked before the backup began.

The port of ``experiments/fuzz_backup.py``: the same op mix, seeds and
invariants over ``vrod_tpu_torch``, on ``runtime.default_device()`` (the
card, or the CPU under ``VROD_PLATFORM=cpu``).

Usage:
    VROD_PLATFORM=cpu python3 tools/fuzz_backup.py 0 25

Each seed: 50 random ops (insert/delete/update/snapshot/REINDEX with
auto-snapshot AND auto-compact enabled); ~10% of steps take an online
BACKUP while a background inserter hammers the collection, then load the
image and verify the pre-backup model exactly.

The JAX harness records seeds 0-99 passing (417 backups verified); this
harness's campaigns are in PERF.md.
"""
import os, sys, time, shutil, threading, tempfile
from pathlib import Path
import numpy as np
import pathlib, sys as _s; _s.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
from vrod_tpu_torch.database import Database

DIM = 8

def run_seed(seed, steps=50):
    tmp = Path(tempfile.mkdtemp(prefix=f"bfuzz{seed}_"))
    db = Database.new(tmp, "db")
    # Rotate the storage tier by seed so backup images + restores are
    # fuzzed across every dtype, incl. the packed int4 tier.
    dtype = ("float32", "bfloat16", "int8", "int4")[seed % 4]
    col = db.create_collection("c", dim=DIM, segment_rows=64, dtype=dtype,
                               auto_snapshot_wal_bytes=5000,
                               auto_compact_fraction=0.4)
    rng = np.random.default_rng(seed)
    live = {}   # rid -> payload (authoritative model)
    stop = threading.Event()
    errs = []

    def mutate():
        r2 = np.random.default_rng(seed + 1000)
        i = 0
        while not stop.is_set():
            try:
                col.insert(r2.standard_normal(DIM).astype(np.float32),
                           f"bg{i}")
                i += 1
            except Exception as e:
                errs.append(e); return

    n_backups = 0
    for step in range(steps):
        roll = rng.random()
        if roll < 0.5 or not live:
            n = int(rng.integers(1, 6))
            ids = col.bulk_insert(
                rng.standard_normal((n, DIM)).astype(np.float32),
                [f"s{step}-{i}" for i in range(n)])
            for j, rid in enumerate(int(x) for x in ids):
                live[rid] = f"s{step}-{j}"
        elif roll < 0.68:
            rid = list(live)[int(rng.integers(0, len(live)))]
            col.delete(rid); live.pop(rid)
        elif roll < 0.78:
            rid = list(live)[int(rng.integers(0, len(live)))]
            col.update(rid, rng.standard_normal(DIM).astype(np.float32),
                       f"u{step}")
            live[rid] = f"u{step}"
        elif roll < 0.86:
            col.snapshot()
        elif roll < 0.92:
            col.reindex()
        else:
            # Backup while a background mutator hammers inserts.
            model = dict(live)  # acked BEFORE the backup starts
            t = threading.Thread(target=mutate); t.start()
            dest = tmp / f"bk{step}"
            try:
                db.backup(dest)
            finally:
                stop.set(); t.join(); stop.clear()
            assert not errs, errs
            n_backups += 1
            db2 = Database.load(dest)
            try:
                c2 = db2.collection("c")
                for rid, payload in model.items():
                    got = c2.get(rid).payload
                    assert got == payload, (seed, step, rid, got, payload)
            finally:
                db2.close()
            shutil.rmtree(dest)
    db.close()
    shutil.rmtree(tmp, ignore_errors=True)
    return n_backups

if __name__ == "__main__":
    t0 = time.time()
    total = 0
    for seed in range(int(sys.argv[1]), int(sys.argv[2])):
        s = time.time()
        total += run_seed(seed)
        print(f"seed {seed} OK ({time.time()-s:.1f}s)", flush=True)
    print(f"ALL SEEDS PASSED ({total} backups verified) in {time.time()-t0:.0f}s",
          flush=True)
