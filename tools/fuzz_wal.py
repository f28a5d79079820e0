"""WAL corruption fuzz: native (C++) and Python scanners must agree.

For random frame sequences with random byte corruption / truncation /
garbage appends, both implementations must recover the SAME durable
prefix (replay stops at the first torn/invalid frame), repair() must
make the file clean, and post-repair appends must replay.

The port of ``experiments/fuzz_wal.py``: the same op mix, seeds and
invariants over ``vrod_tpu_torch`` (engine-free: no device).

Usage:
    python3 tools/fuzz_wal.py 0 200

The JAX harness records 200,000 seeds passing; this harness's campaigns
are in PERF.md.
"""
import os
import shutil
import sys
import tempfile
from pathlib import Path

import numpy as np

import pathlib
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
from vrod_tpu_torch.wal.wal import Wal, iter_valid_frames, valid_prefix_size  # noqa: E402


def build_log(path, rng):
    w = Wal(path, native=True)
    n = int(rng.integers(1, 12))
    for i in range(n):
        payload = rng.bytes(int(rng.integers(0, 2000)))
        w.append(payload, sync=(i % 3 == 0))
        if rng.random() < 0.2:
            w.rewind(w.valid_size)  # no-op rewind keeps lsn counter moving
        if rng.random() < 0.15 and w.frame_count:
            # Simulate a snapshot cut dropping a prefix.
            keep_from = int(rng.integers(0, w.last_lsn + 1))
            w.truncate_until(keep_from)
    w.sync()
    w.close()


def corrupt(path, rng):
    data = bytearray(path.read_bytes())
    mode = rng.random()
    if not data:
        return
    if mode < 0.4:   # flip random bytes
        for _ in range(int(rng.integers(1, 6))):
            data[int(rng.integers(0, len(data)))] ^= int(rng.integers(1, 256))
    elif mode < 0.7:  # truncate mid-frame
        data = data[: int(rng.integers(0, len(data)))]
    elif mode < 0.9:  # append garbage (torn tail shape)
        data += rng.bytes(int(rng.integers(1, 64)))
    else:             # both
        data = data[: int(rng.integers(0, len(data)))] + rng.bytes(7)
    path.write_bytes(bytes(data))


def scan(path, native):
    w = Wal(path, native=native)
    frames = [(lsn, p) for lsn, p in w.replay()]
    out = (frames, w.valid_size, w.frame_count, w.last_lsn,
           w.has_torn_tail)
    w.close()
    return out


def run_seed(seed):
    rng = np.random.default_rng(seed)
    tmp = Path(tempfile.mkdtemp(prefix=f"walfuzz{seed}_"))
    try:
        log = tmp / "vr_wal"
        build_log(log, rng)
        corrupt(log, rng)
        img = log.read_bytes()

        (tmp / "n").mkdir(); (tmp / "p").mkdir()
        (tmp / "n" / "vr_wal").write_bytes(img)
        (tmp / "p" / "vr_wal").write_bytes(img)
        rn = scan(tmp / "n" / "vr_wal", native=True)
        rp = scan(tmp / "p" / "vr_wal", native=False)
        assert rn == rp, (seed, rn[1:], rp[1:])

        # The read-only walker (backup of cold collections, verify_image)
        # must agree with both scanners on the durable prefix — same
        # valid size, same LSN sequence — without touching the file.
        ro_frames = list(iter_valid_frames(tmp / "n" / "vr_wal"))
        assert valid_prefix_size(tmp / "n" / "vr_wal") == rn[1], seed
        assert [lsn for lsn, _ in ro_frames] == [lsn for lsn, _ in rn[0]], \
            seed
        assert (tmp / "n" / "vr_wal").read_bytes() == img, \
            (seed, "read-only walker wrote!")

        # repair() then append on both: identical bytes end to end.
        outs = []
        for sub, native in (("n", True), ("p", False)):
            w = Wal(tmp / sub / "vr_wal", native=native)
            if w.has_torn_tail:
                w.repair()
            w.append(b"post-repair", sync=True)
            frames = [(lsn, p) for lsn, p in w.replay()]
            w.close()
            outs.append((frames, (tmp / sub / "vr_wal").read_bytes()))
        assert outs[0] == outs[1], seed
        assert outs[0][0][-1][1] == b"post-repair"
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    import time
    lo, hi = int(sys.argv[1]), int(sys.argv[2])
    t0 = time.time()
    for seed in range(lo, hi):
        run_seed(seed)
        if (seed - lo) % 50 == 49:
            print(f"...{seed + 1 - lo}/{hi - lo} seeds", flush=True)
    print(f"ALL {hi - lo} SEEDS PASSED in {time.time()-t0:.0f}s", flush=True)
