"""The port's slice end to end against the JAX package, on the CPU:
Database -> create_collection -> bulk_insert -> delete -> search_similar ->
snapshot -> reopen, through both ``vrod_tpu.Database`` and
``vrod_tpu_torch.Database``; databases written by one package loading in
the other; the forked CLI in a subprocess; and the port's imports staying
free of JAX.

Tie-aware id comparison: the two packages quantize through different norm
kernels, so a stored byte may differ by one at a rounding edge; where the
ids at a rank differ, the scores there must agree to 1e-4.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import vrod_tpu
import vrod_tpu_torch
from vrod_tpu_torch.client import VrodClient
from conftest import numpy_topk_oracle

REPO = Path(__file__).resolve().parent.parent


def hits_arrays(hits):
    ids = np.array([[h.record_id for h in hs] for hs in hits], np.int64)
    scores = np.array([[h.score for h in hs] for hs in hits], np.float64)
    return ids, scores


def assert_same_hits(a, b, tol=1e-4):
    ia, sa = hits_arrays(a)
    ib, sb = hits_arrays(b)
    assert ia.shape == ib.shape
    np.testing.assert_allclose(sa, sb, rtol=0, atol=tol)
    differ = ia != ib
    assert (np.abs(sa - sb)[differ] <= tol).all()


def assert_recall_one(col, hits, queries, k):
    """Recall 1.0 against conftest's exact oracle over the STORED rows,
    tie-aware. An int8 cosine collection scores the normalized query
    against the dequantized stored row (the contract of an int8
    collection), which is the oracle's "dot" on those two."""
    live = col.alloc.live_slots().astype(np.int64)
    rows = np.zeros((col.engine.capacity, col.config.dim), np.float32)
    rows[live] = col.engine.gather(live)
    qn = queries / np.linalg.norm(queries, axis=1, keepdims=True)
    _, oscores = numpy_topk_oracle(rows, live, qn, k, "dot")
    ids, scores = hits_arrays(hits)
    kth = oscores[:, -1]
    assert (scores >= kth[:, None] - 1e-5).all()
    for r in ids:
        assert len(set(r.tolist())) == len(r)


def run_sequence(pkg, path, vecs, queries, k=10, **create_kw):
    db = pkg.Database.new(path, "db")
    col = db.create_collection("docs", dim=vecs.shape[1], metric="cosine",
                               dtype="int8", segment_rows=512, **create_kw)
    ids = col.bulk_insert(vecs, [f"p{i}" for i in range(len(vecs))])
    col.delete_many(ids[::7])
    first = col.search_similar(queries, k)
    assert_recall_one(col, first, queries, k)
    col.snapshot()
    col.delete(int(ids[1]))
    db.close()
    db = pkg.Database.load(Path(path) / "db")
    col = db.collection("docs")
    second = col.search_similar(queries, k)
    assert_recall_one(col, second, queries, k)
    gone = set(ids[::7].tolist()) | {int(ids[1])}
    assert not gone & set(hits_arrays(second)[0].ravel().tolist())
    assert col.count == len(vecs) - len(gone)
    db.close()
    return first, second


def test_same_sequence_through_both_packages(tmp_path, rng):
    vecs = rng.standard_normal((1500, 48)).astype(np.float32)
    queries = np.concatenate([vecs[[1, 2, 3]],
                              rng.standard_normal((5, 48)).astype(np.float32)])
    j1, j2 = run_sequence(vrod_tpu, tmp_path / "jax", vecs, queries)
    t1, t2 = run_sequence(vrod_tpu_torch, tmp_path / "torch", vecs, queries)
    assert_same_hits(t1, j1)
    assert_same_hits(t2, j2)
    # Query 2 is vecs[3], record id 4: it finds itself at cosine ~1.
    assert t1[2][0].record_id == 4 and t1[2][0].score > 0.99
    assert t1[2][0].payload == "p3"


@pytest.mark.parametrize("writer,reader", [(vrod_tpu, vrod_tpu_torch),
                                           (vrod_tpu_torch, vrod_tpu)])
def test_snapshot_written_by_one_package_loads_in_the_other(
        tmp_path, rng, writer, reader):
    vecs = rng.standard_normal((900, 32)).astype(np.float32)
    queries = rng.standard_normal((6, 32)).astype(np.float32)
    db = writer.Database.new(tmp_path, "db")
    col = db.create_collection("docs", dim=32, metric="cosine",
                               dtype="int8", segment_rows=256)
    ids = col.bulk_insert(vecs)
    col.snapshot()
    col.delete_many(ids[:50])       # WAL tail after the snapshot
    db.close()
    # Both packages restore the same directory: snapshot bytes go in raw,
    # the delete replays from the WAL.
    states, results = [], []
    for pkg in (writer, reader):
        db = pkg.Database.load(tmp_path / "db")
        col = db.collection("docs")
        eng = col.engine
        states.append([np.asarray(a.cpu() if hasattr(a, "cpu") else a)
                       for a in (eng.x, eng.aux, eng.valid)])
        results.append(col.search_similar(queries, 8))
        db.close()
    for a, b in zip(*states):
        np.testing.assert_array_equal(a, b)
    ia, sa = hits_arrays(results[0])
    ib, sb = hits_arrays(results[1])
    np.testing.assert_array_equal(ia, ib)
    np.testing.assert_allclose(sa, sb, rtol=1e-6)
    assert not set(ids[:50].tolist()) & set(ia.ravel().tolist())


def _env():
    env = dict(os.environ, VROD_PLATFORM="cpu")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    return env


def test_cli_init_create_insert_searchsimilar(tmp_path):
    def cli(*args):
        res = subprocess.run(
            [sys.executable, "-m", "vrod_tpu_torch.cli", *args],
            cwd=tmp_path, env=_env(), capture_output=True, text=True,
            timeout=120)
        assert res.returncode == 0, res.stderr
        return res.stdout

    assert "Initialized" in cli("--init-database", ".", "-n", "mydb")
    out = cli("-d", "mydb", "-e", "create", "-a",
              "c;dim=4;metric=cosine;dtype=int8;segment_rows=64")
    assert "dtype=int8" in out
    assert "Inserted record 1" in cli("-d", "mydb", "-c", "c", "-e",
                                      "insert", "-a", "0.1,-0.2,0.3,0.4;a")
    assert "Inserted record 2" in cli("-d", "mydb", "-c", "c", "-e",
                                      "insert", "-a", "-1,0,0,0;b")
    out = cli("-d", "mydb", "-c", "c", "-e", "searchsimilar", "-a",
              "0.1,-0.2,0.3,0.4;k=2")
    first = out.splitlines()[0].split("\t")
    assert first[0] == "1" and float(first[1]) > 0.99 and first[2] == "a"
    # --serve: the same collection over the wire, then SHUTDOWN.
    sock = tmp_path / "serve.sock"
    errlog = open(tmp_path / "serve.err", "w+")  # a file: never blocks
    proc = subprocess.Popen(
        [sys.executable, "-m", "vrod_tpu_torch.cli", "-d", "mydb",
         "--serve", f"unix:{sock}"], cwd=tmp_path, env=_env(),
        stdout=subprocess.PIPE, stderr=errlog, text=True)
    try:
        assert proc.stdout.readline().startswith("Serving ")
        with VrodClient(f"unix:{sock}") as c:
            hits = c.search_similar("c", [0.1, -0.2, 0.3, 0.4], k=2)
            assert [h.record_id for h in hits] == [1, 2]
            assert hits[0].payload == "a" and hits[0].score > 0.99
            c.shutdown_server()
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stdout.close()
        errlog.close()


def test_port_imports_no_jax():
    code = ("import sys\n"
            "import vrod_tpu_torch, vrod_tpu_torch.database, "
            "vrod_tpu_torch.cli, vrod_tpu_torch.engine, "
            "vrod_tpu_torch.convert\n"
            "from vrod_tpu_torch import Database, Collection, SearchHit, "
            "DeviceEngine\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'jaxlib')))\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


def test_cli_default_float32_collection(tmp_path):
    """``create`` without a dtype makes a float32 collection (the
    default), which the port searches through K1/K3's float32 leg."""
    def cli(*args):
        res = subprocess.run(
            [sys.executable, "-m", "vrod_tpu_torch.cli", *args],
            cwd=tmp_path, env=_env(), capture_output=True, text=True,
            timeout=120)
        assert res.returncode == 0, res.stderr
        return res.stdout

    cli("--init-database", ".", "-n", "mydb")
    assert "dtype=float32" in cli("-d", "mydb", "-e", "create", "-a",
                                  "c;dim=4")
    for vec, name in (("0.1,-0.2,0.3,0.4", "a"), ("-1,0,0,0", "b"),
                      ("0.5,0.5,0.5,0.5", "c")):
        cli("-d", "mydb", "-c", "c", "-e", "insert", "-a", f"{vec};{name}")
    out = cli("-d", "mydb", "-c", "c", "-e", "searchsimilar", "-a",
              "0.1,-0.2,0.3,0.4;k=3").splitlines()
    assert [line.split("\t")[2] for line in out] == ["a", "c", "b"]
    assert float(out[0].split("\t")[1]) > 0.9999


@pytest.mark.parametrize("writer,reader", [(vrod_tpu, vrod_tpu_torch),
                                           (vrod_tpu_torch, vrod_tpu)])
def test_int8_l2_snapshot_loads_in_the_other_package(tmp_path, rng, writer,
                                                     reader):
    """An int8 l2 database written by one package (snapshot plus a WAL
    tail) restores in both with identical rows, aux and norms lane (which
    is rebuilt, never stored), and answers the same queries identically:
    ids equal, squared distances to rtol 1e-6."""
    vecs = rng.standard_normal((900, 32)).astype(np.float32)
    queries = rng.standard_normal((6, 32)).astype(np.float32)
    db = writer.Database.new(tmp_path, "db")
    col = db.create_collection("docs", dim=32, metric="l2", dtype="int8",
                               segment_rows=256)
    ids = col.bulk_insert(vecs)
    col.snapshot()
    col.delete_many(ids[:50])
    db.close()
    states, results = [], []
    for pkg in (writer, reader):
        db = pkg.Database.load(tmp_path / "db")
        col = db.collection("docs")
        eng = col.engine
        states.append([np.asarray(a.cpu() if hasattr(a, "cpu") else a)
                       for a in (eng.x, eng.aux, eng.norms, eng.valid)])
        results.append(col.search_similar(queries, 8))
        db.close()
    for a, b in zip(*states):
        np.testing.assert_array_equal(a, b)
    ia, sa = hits_arrays(results[0])
    ib, sb = hits_arrays(results[1])
    np.testing.assert_array_equal(ia, ib)
    np.testing.assert_allclose(sa, sb, rtol=1e-6)
    assert not set(ids[:50].tolist()) & set(ia.ravel().tolist())
    assert (np.diff(sa, axis=1) >= 0).all()     # l2: ascending distances
