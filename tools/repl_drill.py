#!/usr/bin/env python3
"""10M-row replication drill of the PyTorch/CUDA port:
``experiments/repl_drill.py`` over ``vrod_tpu_torch``. An end-to-end timed
exercise of the durability + replication stack at config-5 volume (10M x
768 int8 cosine), both servers on one card.

Phases (all wall-clock timed, JSON summary at the end):

  A. ingest    - bulk-insert ROWS x DIM int8 rows into a fresh primary
                 (library path, chunked; 7.68 GB of rows on the device at
                 10M x 768)
  B. snapshot  - non-blocking streaming snapshot + WAL truncation
  C. bootstrap - launch ``python -m vrod_tpu_torch.cli --serve`` primary
                 and ``--replica-of`` replica as OS processes; time the
                 snapshot-ship bootstrap to caught-up
  D. kill/resume - push a mutation tail through the serving path, SIGKILL
                 the replica MID-TAIL, restart it, time resume-to-caught-up
                 and assert it resumed WITHOUT re-bootstrapping (its WAL is
                 the primary's byte-identical suffix)
  E. verify    - spot records bit-identical across the pair

Run:  python tools/repl_drill.py [--rows 10000000] [--tail-rows 100000]
      [--chunk 1000000] [--dim 768] [--workdir DIR]

Every process runs on ``cuda:0`` (``VROD_PLATFORM=cpu``, which the
servers inherit, runs the drill on the CPU). The summary adds the ingest's
rows/s, the snapshot's GB/s, each process's RSS and device memory
(allocated and reserved, now and at their peaks; the servers report
theirs in STATS), the card's ``memory.used`` by phase (nvidia-smi,
sampled every second) and the work directory's peak disk use, with the
card's name and power limit.

Disk: the WAL logs float32 rows (about 4 * DIM bytes a row: 31 GB at 10M
x 768) until the snapshot truncates it, beside the snapshot (7.8 GB), and
the replica keeps its own copy of the snapshot. The drill checks the free
space of the work directory first and stops, naming what it needs,
instead of filling the disk.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

ENV = dict(os.environ, PYTHONPATH=str(REPO))
# Bytes a row on disk, from a run at 20,000 x 32 and the frame layouts:
# a WAL bulk frame holds the float32 row and its 8-byte id; a snapshot
# the stored row (int8: DIM bytes), its float32 scale and its id.
WAL_ROW_EXTRA, SNAP_ROW_EXTRA = 16, 16
DISK_SLACK = 1.1


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


def disk_need(rows: int, dim: int, tail_rows: int) -> int:
    """Peak bytes the drill writes under its work directory: the WAL of
    every row beside the snapshot (before the truncation), or both
    snapshots and both tails afterwards."""
    wal_row = 4 * dim + WAL_ROW_EXTRA
    snap = rows * (dim + SNAP_ROW_EXTRA)
    return int(DISK_SLACK * max(rows * wal_row + snap,
                                2 * snap + 2 * tail_rows * wal_row))


def du(path: Path) -> int:
    """Bytes of the files under ``path``; a file removed while the walk
    runs (a WAL segment, a snapshot's temp file) counts as gone."""
    total = 0
    for root, _, files in os.walk(path):
        for name in files:
            try:
                total += os.lstat(os.path.join(root, name)).st_size
            except FileNotFoundError:
                pass
    return total


class Sampler:
    """Every second: the card's memory.used (nvidia-smi, MiB), its peak by
    phase, and the work directory's disk use above its start: the bytes of
    its own files, not the file system's use, which other processes'
    writes to the same disk would inflate."""

    def __init__(self, work: Path, cuda: bool):
        self.work, self.cuda = work, cuda
        self.phase = "A"
        self.card_used: dict[str, float] = {}
        self.disk0 = du(work)
        self.disk_peak = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def sample(self) -> None:
        self.disk_peak = max(self.disk_peak, du(self.work) - self.disk0)
        if not self.cuda:
            return
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=memory.used",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30).stdout.split()
        if out:
            self.card_used[self.phase] = max(
                self.card_used.get(self.phase, 0.0), float(out[0]))

    def _run(self) -> None:
        while not self._stop.wait(1.0):
            self.sample()

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=60)
        self.sample()


def wait_socket(path: Path, proc, timeout: float = 900) -> None:
    deadline = time.time() + timeout
    while time.time() < deadline:
        if path.is_socket():
            return
        if proc.poll() is not None:
            raise RuntimeError(f"server exited with {proc.returncode} before "
                               f"binding {path}")
        time.sleep(0.25)
    raise TimeoutError(f"Server socket {path} never appeared")


def wait_caught_up(rc, names, timeout: float = 3600) -> float:
    """Poll replica STATS until every collection in `names` reports lag 0."""
    t0 = time.time()
    deadline = t0 + timeout
    while time.time() < deadline:
        st = rc.stats().get("replication", {})
        lag = st.get("lag", {})
        if (set(lag) >= set(names)
                and all(lag[n] <= 0 for n in names)
                and st.get("last_error") is None):
            return time.time() - t0
        time.sleep(0.5)
    raise TimeoutError(f"Replica never caught up: {rc.stats()}")




def log_tail(path: Path, n: int = 40) -> str:
    try:
        return "\n".join(path.read_text(errors="replace").splitlines()[-n:])
    except OSError:
        return ""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=10_000_000)
    ap.add_argument("--dim", type=int, default=768)
    ap.add_argument("--chunk", type=int, default=1_000_000)
    ap.add_argument("--tail-rows", type=int, default=100_000)
    ap.add_argument("--workdir", default=None)
    args = ap.parse_args(argv)

    import torch
    from vrod_tpu_torch.client import VrodClient
    from vrod_tpu_torch.database import Database
    from vrod_tpu_torch.server import process_memory

    work = Path(args.workdir or tempfile.mkdtemp(prefix="repl_drill_"))
    work.mkdir(parents=True, exist_ok=True)
    need = disk_need(args.rows, args.dim, args.tail_rows)
    free = shutil.disk_usage(work).free
    if free < need:
        print(f"repl_drill: {args.rows:,} x {args.dim} rows need about "
              f"{need / 1e9:.1f} GB free under {work} (a float32 WAL of "
              f"{4 * args.dim} B a row beside the int8 snapshot, then a "
              f"replica's copy); {free / 1e9:.1f} GB are free. Cut --rows "
              f"or give --workdir on a larger disk.", file=sys.stderr)
        if args.workdir is None:
            shutil.rmtree(work, ignore_errors=True)
        return 2
    times: dict[str, float] = {}
    summary: dict = {"rows": args.rows, "dim": args.dim,
                     "tail_rows": args.tail_rows,
                     "bytes_int8": args.rows * args.dim,
                     "disk_need_bytes": need, "disk_free_bytes": free}
    rng = np.random.default_rng(0)
    primary = replica = None
    p_log, r_log = work / "primary.log", work / "replica.log"
    try:
        # -- A: ingest -----------------------------------------------------
        db = Database.new(work, "pdb")
        col = db.create_collection("big", dim=args.dim, dtype="int8",
                                   metric="cosine", segment_rows=1_048_576)
        dev = col.engine.device
        cuda = dev.type == "cuda"
        summary["device"] = str(dev)
        summary["card"] = card_line() if cuda else None
        with Sampler(work, cuda) as sampler:
            t0 = time.time()
            done = 0
            while done < args.rows:
                n = min(args.chunk, args.rows - done)
                vecs = rng.random((n, args.dim), dtype=np.float32) - 0.5
                col.bulk_insert(vecs)
                done += n
                el = time.time() - t0
                print(f"[ingest] {done / 1e6:.1f}M rows in {el:.0f}s "
                      f"({done / el:.0f} rows/s)", flush=True)
            times["ingest_s"] = time.time() - t0
            summary["ingest_rows_per_s"] = args.rows / times["ingest_s"]
            summary["disk_after_ingest_bytes"] = du(work)
            memory = {"drill_ingest": process_memory()}

            # -- B: snapshot (the bytes the bootstrap will ship) -----------
            sampler.phase = "B"
            t0 = time.time()
            col.snapshot()
            times["snapshot_s"] = time.time() - t0
            snap_bytes = sum(f.stat().st_size
                             for f in (col.path / "snapshot").iterdir())
            summary["snapshot_bytes"] = snap_bytes
            summary["snapshot_gb_per_s"] = snap_bytes / times["snapshot_s"] \
                / 1e9
            print(f"[snapshot] {snap_bytes / 1e9:.2f} GB in "
                  f"{times['snapshot_s']:.0f}s "
                  f"({summary['snapshot_gb_per_s']:.3f} GB/s)", flush=True)
            db.close()
            del db, col
            if cuda:
                torch.cuda.empty_cache()

            # -- C: bootstrap ship over the serving protocol ---------------
            sampler.phase = "C"
            p_sock, r_sock = work / "p.sock", work / "r.sock"
            cli = [sys.executable, "-m", "vrod_tpu_torch.cli"]

            def spawn(argv, log_path):
                with open(log_path, "ab") as out:
                    return subprocess.Popen(cli + argv, env=ENV, stdout=out,
                                            stderr=subprocess.STDOUT)

            def spawn_replica():
                return spawn(["-d", str(work / "rdb"), "--serve",
                              f"unix:{r_sock}", "--replica-of",
                              f"unix:{p_sock}"], r_log)

            primary = spawn(["-d", str(work / "pdb"), "--serve",
                             f"unix:{p_sock}"], p_log)

            t0 = time.time()
            wait_socket(p_sock, primary)
            times["primary_load_s"] = time.time() - t0
            subprocess.run(cli + ["--init-database", str(work), "-n", "rdb"],
                           env=ENV, check=True, capture_output=True)
            t0 = time.time()
            replica = spawn_replica()
            wait_socket(r_sock, replica)
            with VrodClient(f"unix:{r_sock}") as rc:
                times["bootstrap_s"] = wait_caught_up(rc, ["big"])
                boot_stats = rc.stats()
            memory["replica"] = boot_stats["memory"]
            assert boot_stats["counters"].get("repl.bootstraps", 0) == 1, \
                boot_stats["counters"]
            summary["bootstrap_gb_per_s"] = snap_bytes / \
                times["bootstrap_s"] / 1e9
            print(f"[bootstrap] caught up in {times['bootstrap_s']:.0f}s "
                  f"({summary['bootstrap_gb_per_s']:.3f} GB/s end-to-end)",
                  flush=True)

            # -- D: mutation tail, SIGKILL mid-tail, resume ----------------
            sampler.phase = "D"
            tail_chunks = []
            with VrodClient(f"unix:{p_sock}", timeout=600) as pc:
                t0 = time.time()
                for i in range(0, args.tail_rows, 10_000):
                    n = min(10_000, args.tail_rows - i)
                    vecs = rng.random((n, args.dim), dtype=np.float32) - 0.5
                    tail_chunks.append(
                        pc.bulk_insert("big", vecs,
                                       [f"t{i + j}" for j in range(n)]))
                times["tail_ack_s"] = time.time() - t0
                primary_pos = pc.position("big")
            # Give the tail a moment to START flowing, then kill mid-apply.
            time.sleep(2.0)
            replica.kill()
            replica.wait(timeout=60)
            # The SIGKILL leaves a stale socket file; the new server
            # reclaims it, but wait_socket would match the STALE file:
            # remove it so the wait below observes the new bind.
            r_sock.unlink(missing_ok=True)
            print(f"[kill] replica SIGKILLed mid-tail "
                  f"(primary position {primary_pos})", flush=True)

            t0 = time.time()
            replica = spawn_replica()
            wait_socket(r_sock, replica)
            with VrodClient(f"unix:{r_sock}") as rc:
                times["resume_s"] = wait_caught_up(rc, ["big"])
                resume_stats = rc.stats()
            memory["replica_resumed"] = resume_stats["memory"]
            # Resumed by TAILING ONLY: a resync/bootstrap in the new
            # process would mean the durable-suffix contract broke.
            assert resume_stats["counters"].get("repl.bootstraps", 0) == 0, \
                resume_stats["counters"]
            assert resume_stats["counters"].get("repl.resyncs", 0) == 0
            print(f"[resume] caught up in {times['resume_s']:.0f}s without "
                  f"re-bootstrap", flush=True)

            # -- E: verify -------------------------------------------------
            sampler.phase = "E"
            with VrodClient(f"unix:{p_sock}", timeout=600) as pc, \
                    VrodClient(f"unix:{r_sock}", timeout=600) as rc:
                some = [int(tail_chunks[0][0]), int(tail_chunks[-1][-1]), 1,
                        args.rows // 2]
                for rid in some:
                    pv, pp = pc.get("big", rid)
                    rv, rp = rc.get("big", rid)
                    assert pp == rp and np.array_equal(pv, rv), \
                        f"record {rid}"
                memory["primary"] = pc.stats()["memory"]
            summary["verified_records"] = len(some)
        summary["memory"] = memory
        summary["card_used_peak_mb"] = sampler.card_used
        summary["disk_peak_bytes"] = max(sampler.disk_peak,
                                         summary["disk_after_ingest_bytes"])
    except BaseException:
        for name, path in (("primary", p_log), ("replica", r_log)):
            print(f"--- {name} log tail ---\n{log_tail(path)}",
                  file=sys.stderr)
        raise
    finally:
        for proc in (replica, primary):
            if proc is not None and proc.poll() is None:
                proc.send_signal(signal.SIGINT)
        for proc in (replica, primary):
            if proc is not None:
                try:
                    proc.wait(timeout=60)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait(timeout=60)
        if args.workdir is None:
            shutil.rmtree(work, ignore_errors=True)

    summary["times"] = times
    summary["ok"] = True
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
