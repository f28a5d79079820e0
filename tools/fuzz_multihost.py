#!/usr/bin/env python3
"""Multi-process collective-path fuzz over the port: random op mixes
(mutations, searches, collective snapshot / REINDEX / truncate_wal,
close + collective reload) on a two-process row mesh, model-checked on
BOTH ranks.

The port of ``experiments/fuzz_multihost.py``: the same op mix, seed
streams and invariants over ``vrod_tpu_torch.parallel.distributed``. Each
seed spawns two ranks that join one process group (``initialize`` with the
``VROD_*`` variables, rank 0 serving the ``TCPStore``), each holding 4
shards of one 8-shard mesh (``global_devices([own device] * 4)``). The
backend follows the package's rule: gloo on the CPU (``VROD_PLATFORM=cpu``)
and with both ranks on one card, NCCL with a card each. Both ranks run the
IDENTICAL seeded op stream (the SPMD contract) against a host model dict;
every 8 ops and at the end, exact search results and counts are checked
against the model on both ranks, and a final collective reload must
reproduce the model.

One difference from the JAX harness: half of the collective snapshots
(chosen by the seeded stream, so on both ranks alike) run on a thread of
their own while the main thread makes a bulk insert. The port agrees on a
count of started mutations before each gather of a snapshot
(``Collection._mh_agreed_write``, where the JAX package retries under its
lock), and these interleavings are the ones that gate orders.

    python3 tools/fuzz_multihost.py LO HI [--jobs N] [--timeout S]

runs seeds LO..HI-1 (default 0-9), N seeds at a time (default 1), each
rank with a time limit of S seconds (default 600).
"""

from __future__ import annotations

import argparse
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import textwrap
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

WORKER = textwrap.dedent("""
    import os, sys, threading
    pid = int(sys.argv[1]); port = sys.argv[2]
    workdir = sys.argv[3]; seed = int(sys.argv[4])
    os.environ["VROD_COORDINATOR"] = f"localhost:{port}"
    os.environ["VROD_NUM_PROCESSES"] = "2"
    os.environ["VROD_PROCESS_ID"] = str(pid)

    import numpy as np
    from vrod_tpu_torch.parallel import distributed
    distributed.initialize()

    from pathlib import Path
    from vrod_tpu_torch.collection import Collection
    from vrod_tpu_torch.config import CollectionConfig

    def devices():
        return distributed.global_devices([distributed.local_device()] * 4)

    DIM = 16
    cfg = CollectionConfig(name="mh", dim=DIM, metric="cosine",
                           segment_rows=64, shards=8)
    path = Path(workdir) / f"rank{pid}" / "mh"
    col = Collection.create(path, cfg, devices=devices())
    assert col.engine.multiprocess and col.engine.shards == 8

    rng = np.random.default_rng(seed)  # IDENTICAL stream on both ranks
    model = {}  # rid -> (vector, payload)

    def vec():
        return rng.standard_normal(DIM).astype(np.float32)

    def check():
        assert col.count == len(model), (pid, col.count, len(model))
        if not model:
            return
        keys = np.array(sorted(model))
        mat = np.stack([model[int(k)][0] for k in keys])
        mat = mat / np.linalg.norm(mat, axis=1, keepdims=True)
        q = vec()  # consumed identically on both ranks
        qn = q / np.linalg.norm(q)
        want = keys[np.argsort(-(mat @ qn), kind="stable")[:5]]
        hits = col.search_similar(q, k=5)  # 1-D query -> list[Hit]
        got = [h.record_id for h in hits]
        assert got == [int(w) for w in want], (pid, got, list(want))
        # payload spot check on the top hit
        assert hits[0].payload == model[got[0]][1]

    def bulk(step):
        k = int(rng.integers(1, 24))
        vs = rng.standard_normal((k, DIM)).astype(np.float32)
        rids = col.bulk_insert(vs, [f"s{step}-{i}" for i in range(k)])
        for i, r in enumerate(rids):
            model[int(r)] = (vs[i], f"s{step}-{i}")

    n_ops = 60
    wal_base = 0  # follower WAL frames (nonzero only after adopting the
    #               leader's dir; mutations never append on the follower)
    concurrent = 0
    for step in range(n_ops):
        roll = float(rng.random())
        live = sorted(model)
        if roll < 0.30 or not live:
            bulk(step)
        elif roll < 0.45:
            v = vec()
            rid = col.insert(v, f"one{step}")
            model[int(rid)] = (v, f"one{step}")
        elif roll < 0.60:
            k = min(len(live), int(rng.integers(1, 16)))
            victims = [int(live[int(i)]) for i in
                       rng.choice(len(live), size=k, replace=False)]
            col.delete_many(victims)
            for r in victims:
                model.pop(r, None)
        elif roll < 0.70:
            t = int(live[int(rng.integers(0, len(live)))])
            v = vec()
            col.update(t, v, f"u{step}")
            model[t] = (v, f"u{step}")
        elif roll < 0.80:
            if rng.random() < 0.5:
                col.snapshot()
            else:
                # A collective snapshot with a concurrent writer on both
                # ranks: the insert lands before the agreed cut or between
                # two chunk gathers, at the same place on both ranks.
                errs = []

                def snap():
                    try:
                        col.snapshot()
                    except BaseException as e:
                        errs.append(e)

                th = threading.Thread(target=snap)
                th.start()
                bulk(step)
                th.join(300)
                assert not th.is_alive(), (pid, "snapshot hung")
                assert not errs, errs
                concurrent += 1
            wal_base = 0  # snapshot cuts + truncates on EVERY rank
        elif roll < 0.88:
            col.reindex()
            wal_base = 0
        elif roll < 0.94:
            col.truncate_wal()
            wal_base = 0
        else:
            # Collective close + reload in place. Contract: in-place
            # reload needs byte-identical rank state. Rank 0 owns WAL
            # durability, so mid-WAL rank dirs NEVER match — load must
            # REFUSE them (exercised below), after which the follower
            # adopts the leader's bytes (same host in this harness —
            # the documented recovery recipe) and the collective load
            # must accept the now-identical mid-WAL state.
            # Both ranks agree on accept-vs-refuse without coordination:
            # the fingerprint check is itself a collective all-gather,
            # so either every rank raises or every rank loads.
            col.close()
            leader = Path(workdir) / "rank0" / "mh"
            try:
                col = Collection.load(path, devices=devices())
                accepted = True
            except RuntimeError as e:
                assert "byte-identical" in str(e), e
                accepted = False
            if not accepted:
                # diverged mid-WAL: follower adopts the leader's dir,
                # then the collective load must succeed with identical
                # NON-empty WALs on both ranks.
                import shutil as _sh
                import time as _t
                if pid == 1:
                    _sh.rmtree(path)
                    _sh.copytree(leader, path)
                marker = Path(workdir) / f"copied{step}.{pid}"
                marker.touch()
                other = Path(workdir) / f"copied{step}.{1 - pid}"
                for _ in range(1200):
                    if other.exists():
                        break
                    _t.sleep(0.05)
                else:
                    raise SystemExit(f"rank {pid}: copy barrier timeout")
                col = Collection.load(path, devices=devices())
            assert col.engine.multiprocess
            wal_base = col.wal.frame_count if pid == 1 else wal_base
        if step % 8 == 7:
            check()
        # Leader owns WAL durability: mutations never append on the
        # follower (its frames only change via adoption/maintenance).
        if pid == 1:
            assert col.wal.frame_count == wal_base, \\
                (step, col.wal.frame_count, wal_base)

    check()
    col.snapshot()  # restore rank-dir identity for the in-place reload
    col.close()
    col = Collection.load(path, devices=devices())
    assert col.count == len(model)
    # Full-model spot verification after the final reload.
    for rid in sorted(model)[:50]:
        rec = col.get(rid)
        np.testing.assert_allclose(np.asarray(rec.vector, np.float32),
                                   model[rid][0], rtol=2e-2, atol=2e-2)
        assert rec.payload == model[rid][1]
    check()
    col.close()
    print(f"RANK{pid}_OK backend={distributed.backend()} "
          f"device={distributed.local_device()} "
          f"concurrent_snapshots={concurrent}", flush=True)
""")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_seed(seed: int, timeout: float = 600.0) -> str:
    """One seed on two ranks; returns rank 0's last line (backend, device,
    concurrent snapshots). Raises with the failing rank's output."""
    tmp = Path(tempfile.mkdtemp(prefix=f"mhfuzz{seed}_"))
    try:
        script = tmp / "worker.py"
        script.write_text(WORKER)
        env = dict(os.environ)
        env["PYTHONPATH"] = str(REPO) + (
            os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
        port = _free_port()
        procs = [subprocess.Popen(
            [sys.executable, str(script), str(i), str(port), str(tmp),
             str(seed)],
            env=env, cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for i in range(2)]
        outs = []
        try:
            for p in procs:
                out, _ = p.communicate(timeout=timeout)
                outs.append(out)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for i, (p, out) in enumerate(zip(procs, outs)):
            if p.returncode != 0 or f"RANK{i}_OK" not in out:
                raise AssertionError(
                    f"seed {seed} rank {i} failed (rc={p.returncode}):\n"
                    f"{out[-4000:]}")
        return [ln for ln in outs[0].splitlines()
                if ln.startswith("RANK0_OK")][0]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("lo", type=int, nargs="?", default=0)
    ap.add_argument("hi", type=int, nargs="?", default=None)
    ap.add_argument("--jobs", type=int, default=1)
    ap.add_argument("--timeout", type=float, default=600.0)
    args = ap.parse_args(argv)
    hi = args.lo + 10 if args.hi is None else args.hi
    t0 = time.time()

    def one(seed):
        s = time.time()
        line = run_seed(seed, args.timeout)
        print(f"seed {seed} OK ({time.time() - s:.1f}s): {line}",
              flush=True)

    with ThreadPoolExecutor(max(1, args.jobs)) as ex:
        for f in [ex.submit(one, s) for s in range(args.lo, hi)]:
            f.result()
    print(f"ALL {hi - args.lo} SEEDS PASSED in {time.time() - t0:.0f}s",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
