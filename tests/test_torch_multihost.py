"""The four cases of ``tests/test_multihost.py`` over the port: two OS
processes join one process group (gloo, the ``VROD_*`` variables, rank 0
serving the ``TCPStore``), each holds 4 CPU shards of one 8-shard row mesh
(``distributed.global_devices([cpu] * 4)``), and every rank runs the same
program with the same inputs. The assertions are the JAX file's:

- exact search on the process-spanning mesh;
- collective mutations with rank 0 alone writing the WAL, collective
  snapshot (the leader's LSN cut on both ranks), reload in place, REINDEX
  and TRUNCATEWAL;
- collective load: identical copies load; a rank whose WAL diverged makes
  the load fail fast on every rank;
- a snapshot with a concurrent writer on both ranks: mutations land between
  the chunk gathers, and both ranks write byte-identical ``meta.json``.

Each subprocess has its own timeout, as in the JAX file.
"""

import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
TIMEOUT_S = 300

PREAMBLE = textwrap.dedent("""
    import os, sys
    pid = int(sys.argv[1])
    port = sys.argv[2]
    workdir = sys.argv[3]
    os.environ["VROD_PLATFORM"] = "cpu"
    os.environ["VROD_COORDINATOR"] = f"localhost:{port}"
    os.environ["VROD_NUM_PROCESSES"] = "2"
    os.environ["VROD_PROCESS_ID"] = str(pid)

    import numpy as np
    import torch
    from vrod_tpu_torch.parallel import distributed
    distributed.initialize()
    assert distributed.process_count() == 2
    assert distributed.backend() == "gloo"
    DEVICES = distributed.global_devices([torch.device("cpu")] * 4)
    assert len(DEVICES) == 8, DEVICES
""")

WORKER = PREAMBLE + textwrap.dedent("""
    from vrod_tpu_torch.config import CollectionConfig
    from vrod_tpu_torch.engine import DeviceEngine

    cfg = CollectionConfig(name="mh", dim=64, metric="cosine",
                           segment_rows=64, shards=8)
    eng = DeviceEngine(cfg, devices=DEVICES)
    assert eng.shards == 8 and eng.multiprocess

    rng = np.random.default_rng(7)  # same data in both processes (SPMD)
    n = 512
    vecs = rng.standard_normal((n, cfg.dim)).astype(np.float32)
    eng.ensure_capacity(n)
    eng.write(np.arange(n, dtype=np.uint64), vecs)
    eng.erase(np.arange(0, n, 7))

    q = vecs[8:12]
    vals, idx = eng.search(q, k=5)
    assert idx.shape == (4, 5)
    assert (idx % 7 != 0).all(), "deleted rows leaked"
    for i, qi in enumerate(range(8, 12)):
        assert idx[i, 0] == qi, (pid, i, idx[i])
        assert abs(vals[i, 0] - 1.0) < 1e-4
    print(f"RANK{pid}_OK", flush=True)
""")

MUTATION_WORKER = PREAMBLE + textwrap.dedent("""
    from pathlib import Path
    from vrod_tpu_torch.collection import Collection
    from vrod_tpu_torch.config import CollectionConfig

    # Per-rank paths: the follower's WAL stays empty (rank 0 owns
    # durability); live state is the process-spanning mesh's shards.
    cfg = CollectionConfig(name="mh", dim=32, metric="cosine",
                           segment_rows=64, shards=8)
    col = Collection.create(Path(workdir) / f"rank{pid}" / "mh", cfg,
                            devices=DEVICES)
    assert col.engine.multiprocess

    rng = np.random.default_rng(11)  # identical mutation stream (SPMD)
    vecs = rng.standard_normal((300, cfg.dim)).astype(np.float32)
    rids = col.bulk_insert(vecs, [f"p{i}" for i in range(300)])
    col.delete_many(rids[:50])
    one = rng.standard_normal(cfg.dim).astype(np.float32)
    one_id = col.insert(one, "single")
    col.update(int(rids[60]), vecs[70] * 0.5, "updated")
    col.delete(int(rids[55]))

    # Exactness vs a host oracle of the surviving set, on BOTH ranks.
    def norm(a):
        return a / np.linalg.norm(a, axis=-1, keepdims=True)
    live = {int(r): vecs[i] for i, r in enumerate(rids)}
    for r in rids[:50]:
        live.pop(int(r), None)
    live.pop(int(rids[55]), None)
    live[int(rids[60])] = vecs[70] * 0.5
    live[one_id] = one
    assert col.count == len(live)

    q = vecs[100:104]
    oracle_ids = []
    keys = np.array(sorted(live))
    mat = norm(np.stack([live[int(k)] for k in keys]))
    for qi in norm(q):
        oracle_ids.append(keys[np.argsort(-(mat @ qi))[:5]])
    for hits, want in zip(col.search_similar(q, k=5), oracle_ids):
        got = [h.record_id for h in hits]
        assert got == [int(w) for w in want], (pid, got, want)
    assert col.search_similar(one, k=1)[0].payload == "single"

    # Durability ownership: leader logs, follower does not.
    if pid == 0:
        assert col.wal.frame_count > 0
    else:
        assert col.wal.frame_count == 0

    import json

    def snap_meta():
        return json.loads(
            (Path(workdir) / f"rank{pid}" / "mh" / "snapshot" /
             "meta.json").read_text())

    # Collective snapshot: every rank persists its own identical image
    # stamped with the LEADER's LSN cut; both WALs drop to empty.
    col.snapshot()
    meta = snap_meta()
    assert meta["count"] == len(live), (pid, meta["count"], len(live))
    assert meta["last_lsn"] > 0, (pid, meta)
    assert col.wal.frame_count == 0, (pid, col.wal.frame_count)
    cut0 = meta["last_lsn"]
    col.close()

    # Collective reload IN PLACE: the fingerprint check passes because
    # each rank's snapshot is identical.
    col = Collection.load(Path(workdir) / f"rank{pid}" / "mh",
                          devices=DEVICES)
    assert col.engine.multiprocess and col.count == len(live)
    for hits, want in zip(col.search_similar(q, k=5), oracle_ids):
        assert [h.record_id for h in hits] == [int(w) for w in want]

    # Collective REINDEX: compaction (moves across shards and ranks) +
    # capacity shrink + snapshot.
    cap_before = col.engine.capacity
    col.reindex()
    assert col.engine.capacity <= cap_before
    assert col.count == len(live)
    for hits, want in zip(col.search_similar(q, k=5), oracle_ids):
        assert [h.record_id for h in hits] == [int(w) for w in want]
    assert snap_meta()["last_lsn"] >= cut0

    # Mutate again, then collective TRUNCATEWAL (snapshot-first).
    extra = rng.standard_normal(cfg.dim).astype(np.float32)
    extra_id = col.insert(extra, "extra")
    col.truncate_wal()
    assert col.wal.frame_count == 0
    assert snap_meta()["last_lsn"] > cut0, (pid, snap_meta(), cut0)
    assert col.search_similar(extra, k=1)[0].record_id == extra_id
    col.close()

    # Final reload proves the truncated state is complete and loadable.
    col = Collection.load(Path(workdir) / f"rank{pid}" / "mh",
                          devices=DEVICES)
    assert col.count == len(live) + 1
    assert col.search_similar(extra, k=1)[0].payload == "extra"
    print(f"RANK{pid}_OK", flush=True)
""")

LOAD_WORKER = PREAMBLE + textwrap.dedent("""
    import shutil, time
    from pathlib import Path
    from vrod_tpu_torch.collection import Collection
    from vrod_tpu_torch.config import CollectionConfig
    from vrod_tpu_torch.wal import Wal, ops

    base = Path(workdir)
    src = base / "src" / "mh"
    marker = base / "src_ready"
    mine = base / f"rank{pid}" / "mh"
    cfg = CollectionConfig(name="mh", dim=16, metric="cosine",
                           segment_rows=64, shards=8)
    rng = np.random.default_rng(3)
    vecs = rng.standard_normal((20, 16)).astype(np.float32)
    if pid == 0:
        # A one-process collection of rank 0's own.
        col = Collection.create(src, cfg, devices=[torch.device("cpu")])
        col.bulk_insert(vecs, [f"p{i}" for i in range(20)])
        col.close()
        marker.touch()
    else:
        for _ in range(600):
            if marker.exists():
                break
            time.sleep(0.1)
        assert marker.exists()
    shutil.copytree(src, mine)

    # Identical copies: collective load + search works on both ranks.
    col = Collection.load(mine, devices=DEVICES)
    assert col.engine.multiprocess and col.count == 20
    assert col.search_similar(vecs[5], k=1)[0].record_id == 6
    col.close()

    # Diverge rank 1's WAL (one extra frame) -> BOTH ranks fail fast.
    if pid == 1:
        w = Wal(mine / "vr_wal")
        w.append(ops.encode(ops.DeleteOp(1)))
        w.close()
    try:
        Collection.load(mine, devices=DEVICES)
        raise AssertionError("diverged load should have failed fast")
    except RuntimeError as e:
        assert "byte-identical" in str(e), e
    print(f"RANK{pid}_OK", flush=True)
""")

CONCURRENT_SNAPSHOT_WORKER = PREAMBLE + textwrap.dedent("""
    import threading, time, zlib
    from pathlib import Path
    from vrod_tpu_torch.collection import Collection
    from vrod_tpu_torch.config import CollectionConfig

    cfg = CollectionConfig(name="mh", dim=16, metric="cosine",
                           segment_rows=64, shards=8)
    col = Collection.create(Path(workdir) / f"rank{pid}" / "mh", cfg,
                            devices=DEVICES)
    assert col.engine.multiprocess

    rng = np.random.default_rng(21)
    vecs = rng.standard_normal((1024, cfg.dim)).astype(np.float32)
    rids = col.bulk_insert(vecs, [f"p{i}" for i in range(1024)])
    col.SNAPSHOT_CHUNK_ROWS = 64    # 1024 rows -> 16 gather chunks

    # Instrument gather-chunk times.
    chunk_times = []
    real_gather = col.engine.gather_raw
    def spying_gather(slots, **kw):
        chunk_times.append(time.monotonic())
        return real_gather(slots, **kw)
    col.engine.gather_raw = spying_gather

    # Writer thread: the IDENTICAL collective mutation stream on both
    # ranks (inserts + deletes; the inserts grow the capacity once, a
    # collective), running throughout the snapshot.
    wvecs = rng.standard_normal((60, cfg.dim)).astype(np.float32)
    done_times = []
    def writer():
        for _ in range(5000):
            if chunk_times:
                break
            time.sleep(0.001)
        for i in range(60):
            col.insert(wvecs[i], f"w{i}")
            if i % 7 == 3:
                col.delete(int(rids[i]))
            done_times.append(time.monotonic())
            time.sleep(0.001)
    t = threading.Thread(target=writer)
    t.start()
    snap = col.snapshot()
    t.join()

    assert len(chunk_times) >= 16, len(chunk_times)
    between = [d for d in done_times
               if chunk_times[0] < d < chunk_times[-1]]
    assert len(between) >= 1, (pid, len(between), len(done_times))
    print(f"BETWEEN{pid}={len(between)}", flush=True)

    # meta.json embeds the crc32 of every file, so comparing meta bytes
    # compares the whole image.
    meta_crc = zlib.crc32((snap / "meta.json").read_bytes())
    print(f"METACRC{pid}={meta_crc}", flush=True)

    # Quiesce, snapshot again (both WALs empty -> rank dirs
    # byte-identical), collective reload, verify against the host model.
    col.snapshot()
    assert col.wal.frame_count == 0
    col.close()

    col = Collection.load(Path(workdir) / f"rank{pid}" / "mh",
                          devices=DEVICES)
    live = {int(r): vecs[i] for i, r in enumerate(rids)}
    next_id = 1025
    for i in range(60):
        live[next_id] = wvecs[i]
        next_id += 1
        if i % 7 == 3:
            live.pop(int(rids[i]), None)
    assert col.count == len(live), (pid, col.count, len(live))
    def norm(a):
        return a / np.linalg.norm(a, axis=-1, keepdims=True)
    keys = np.array(sorted(live))
    mat = norm(np.stack([live[int(k)] for k in keys]))
    q = wvecs[10:14]
    for qi, hits in zip(norm(q), col.search_similar(q, k=5)):
        want = keys[np.argsort(-(mat @ qi))[:5]]
        got = [h.record_id for h in hits]
        assert got == [int(w) for w in want], (pid, got, want)

    # A process-spanning mesh cannot be a replica.
    from vrod_tpu_torch.wal import ops as wal_ops
    try:
        col.replica_apply(10**9, wal_ops.encode(wal_ops.DeleteOp(1)))
        raise AssertionError("replica_apply must refuse on a global mesh")
    except RuntimeError as e:
        assert "process-spanning" in str(e), e

    col.close()
    print(f"RANK{pid}_OK", flush=True)
""")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_two_ranks(tmp_path, worker_src):
    """Run ``worker_src`` as ranks 0 and 1; both must exit 0 and print
    their RANK<i>_OK line. Returns their outputs."""
    port = _free_port()
    script = tmp_path / "worker.py"
    # The port's processes never load the JAX package or JAX.
    script.write_text(worker_src + textwrap.dedent("""
        assert not {m.split(".")[0] for m in sys.modules} & {
            "jax", "jaxlib", "vrod_tpu"}, "the port loaded JAX"
    """))
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    for k in ("VROD_COORDINATOR", "VROD_NUM_PROCESSES", "VROD_PROCESS_ID"):
        env.pop(k, None)
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(i), str(port), str(tmp_path)],
        env=env, cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for i in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {i} failed:\n{out[-3000:]}"
        assert f"RANK{i}_OK" in out
        assert "backend gloo" in out, out[-2000:]
    return outs


def test_two_process_global_mesh_search(tmp_path):
    _run_two_ranks(tmp_path, WORKER)


def test_two_process_global_mesh_mutations(tmp_path):
    _run_two_ranks(tmp_path, MUTATION_WORKER)


def test_two_process_collective_load(tmp_path):
    _run_two_ranks(tmp_path, LOAD_WORKER)


def test_two_process_snapshot_with_concurrent_writer(tmp_path):
    outs = _run_two_ranks(tmp_path, CONCURRENT_SNAPSHOT_WORKER)
    # The concurrently captured snapshot must be byte-identical on both
    # ranks (same agreed generation per chunk).
    crcs = []
    for i, out in enumerate(outs):
        line = [l for l in out.splitlines() if l.startswith(f"METACRC{i}=")]
        assert line, out[-2000:]
        crcs.append(line[0].split("=")[1])
    assert crcs[0] == crcs[1], crcs
