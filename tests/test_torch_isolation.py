"""The port stands alone: it imports nothing of ``vrod_tpu``, JAX or
``ml_dtypes``, and the databases it writes are byte-compatible with the
JAX package's.

- In a subprocess whose import system refuses ``vrod_tpu`` (exactly that
  package, not ``vrod_tpu_torch``), ``jax``, ``jaxlib`` and ``ml_dtypes``,
  every module of ``vrod_tpu_torch`` (the serving modules and ``parallel``
  among them), ``chip_smoke``, ``tools/kexp_floor.py``,
  ``tools/kexp_extract.py``, ``tools/recall_margin.py``, every
  ``tools/fuzz_*.py``, the port's bench ``bench_torch.py`` (which must not
  import ``bench.py`` either), the tools ``tools/filter_bench.py``,
  ``tools/soak_serve.py`` and ``tools/repl_drill.py``, and the port's
  examples ``examples/torch_quickstart.py``, ``torch_serving.py`` and
  ``torch_replication.py`` import (each loaded as a module, so no
  ``main()`` runs; no import statement of theirs, inside ``main()`` too,
  names a refused package), a collection (int8, bfloat16) goes
  create -> bulk_insert -> search -> snapshot -> delete -> load -> serve ->
  verify on the CPU, and the row-sharding dry run runs over 2 CPU shards,
  in the refusing process itself and as ``dryrun_multichip(2)``.
- A database written by either package loads in the other and answers the
  same queries; for the same operations both packages write the same WAL
  bytes.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import vrod_tpu
import vrod_tpu_torch
from vrod_tpu_torch import convert
from test_torch_distances import norms_agree

REPO = Path(__file__).resolve().parent.parent

# Runs in a fresh interpreter: refuse the forbidden packages, import the
# whole port and chip_smoke, then drive one collection of dtype argv[1]
# through the entry points in directory argv[2].
_ISOLATED = r'''
import importlib, importlib.abc, pkgutil, sys

BANNED = ("vrod_tpu", "jax", "jaxlib", "ml_dtypes", "bench")


class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BANNED:
            raise ImportError(f"the port imported {name}")
        return None


sys.meta_path.insert(0, Refuse())
import numpy as np
import vrod_tpu_torch

mods = ["vrod_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(vrod_tpu_torch.__path__,
                                          "vrod_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
assert {"vrod_tpu_torch.wal.wal", "vrod_tpu_torch._native.build",
        "vrod_tpu_torch.snapshot", "vrod_tpu_torch.ops.cuda_topk",
        "vrod_tpu_torch.ops.cuda_extract",
        "vrod_tpu_torch.utils.embeddings", "vrod_tpu_torch.netaddr",
        "vrod_tpu_torch.client", "vrod_tpu_torch.pool",
        "vrod_tpu_torch.frontend", "vrod_tpu_torch.server",
        "vrod_tpu_torch.replication", "vrod_tpu_torch.utils.verify",
        "vrod_tpu_torch.parallel", "vrod_tpu_torch.parallel.mesh",
        "vrod_tpu_torch.parallel.distributed",
        "vrod_tpu_torch.parallel.dryrun"} <= set(mods), mods
import chip_smoke  # noqa: F401
import runpy
runpy.run_path("tools/kexp_floor.py", run_name="kexp_floor")
runpy.run_path("tools/kexp_extract.py", run_name="kexp_extract")
runpy.run_path("tools/recall_margin.py", run_name="recall_margin")
import glob
fuzz = sorted(glob.glob("tools/fuzz_*.py"))
assert len(fuzz) == 8, fuzz
for f in fuzz:
    runpy.run_path(f, run_name=f.split("/")[-1][:-3])
programs = ["bench_torch.py", "tools/filter_bench.py",
            "tools/soak_serve.py", "tools/repl_drill.py",
            "examples/torch_quickstart.py", "examples/torch_serving.py",
            "examples/torch_replication.py"]
import ast
for f in programs:
    ns = runpy.run_path(f, run_name=f.split("/")[-1][:-3])
    assert callable(ns["main"]), f
    # Their imports inside main() too: every import statement of the file.
    for node in ast.walk(ast.parse(open(f).read())):
        names = [a.name for a in node.names] if isinstance(
            node, ast.Import) else [node.module or ""] if isinstance(
            node, ast.ImportFrom) else []
        assert not [n for n in names if n.split(".")[0] in BANNED], (f, names)

from vrod_tpu_torch import Database, VrodClient, VrodServer
from vrod_tpu_torch.verify_image import verify_image

dtype, root = sys.argv[1], sys.argv[2]
rng = np.random.default_rng(7)
vecs = rng.standard_normal((600, 24)).astype(np.float32)
queries = rng.standard_normal((5, 24)).astype(np.float32)
db = Database.new(root, "db", device="cpu")
col = db.create_collection("docs", dim=24, metric="cosine", dtype=dtype,
                           segment_rows=256)
ids = col.bulk_insert(vecs, [f"p{i}" for i in range(600)])
before = col.search_similar(queries, 5)
assert [h.record_id for h in before[0]][0] in ids
col.snapshot()
gone = [hs[0].record_id for hs in before]
assert col.delete_many(gone) == len(gone)
db.close()
db = Database.load(f"{root}/db", device="cpu")
col = db.collection("docs")
assert col.count == 600 - len(gone), col.count
after = col.search_similar(queries, 5)
for was, got in zip(before, after):
    kept = [(h.record_id, h.score) for h in was if h.record_id not in gone]
    assert [(h.record_id, h.score) for h in got][:len(kept)] == kept
with VrodServer(db, ("127.0.0.1", 0)).start() as srv:
    with VrodClient(srv.address) as c:
        wire = c.search_similar("docs", queries[0], k=5)
assert [(h.record_id, h.score) for h in wire] == \
    [(h.record_id, h.score) for h in after[0]]
db.close()
report = verify_image(f"{root}/db")
assert report["ok"], report
from vrod_tpu_torch.parallel import dryrun
dryrun._dryrun_impl(2)
dryrun.dryrun_multichip(2)
bad = sorted(m for m in sys.modules if m.split(".")[0] in BANNED)
assert not bad, bad
print("ok", len(mods))
'''


def _env():
    env = dict(os.environ, VROD_PLATFORM="cpu")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    return env


@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
def test_port_runs_with_vrod_tpu_jax_and_ml_dtypes_refused(tmp_path, dtype):
    res = subprocess.run(
        [sys.executable, "-c", _ISOLATED, dtype, str(tmp_path)], cwd=REPO,
        env=_env(), capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    word, count = res.stdout.split()
    assert word == "ok" and int(count) > 20


def _stored(a):
    """An engine array of either package as numpy with its stored bytes."""
    return convert.to_numpy(a) if hasattr(a, "cpu") else np.asarray(a)


def _hits(hits):
    ids = np.array([[h.record_id for h in hs] for hs in hits], np.int64)
    scores = np.array([[h.score for h in hs] for hs in hits], np.float64)
    return ids, scores


@pytest.mark.parametrize("dtype", ["int8", "bfloat16", "int4"])
@pytest.mark.parametrize("writer,reader", [(vrod_tpu, vrod_tpu_torch),
                                           (vrod_tpu_torch, vrod_tpu)])
def test_database_loads_in_the_other_package(tmp_path, rng, writer, reader,
                                             dtype):
    """A database written by one package (snapshot, deletes and inserts in
    the WAL tail) loads in both with the same stored row bytes at the live
    slots and the same aux (to an ulp), and both answer the same queries
    with the same ids and scores."""
    vecs = rng.standard_normal((700, 32)).astype(np.float32)
    extra = rng.standard_normal((40, 32)).astype(np.float32)
    queries = rng.standard_normal((6, 32)).astype(np.float32)
    db = writer.Database.new(tmp_path, "db")
    col = db.create_collection("docs", dim=32, metric="cosine", dtype=dtype,
                               segment_rows=256)
    ids = col.bulk_insert(vecs, [f"v{i}" for i in range(700)])
    col.snapshot()
    col.delete_many(ids[::7])
    extra_ids = col.bulk_insert(extra)
    db.close()
    rows, results = [], []
    for pkg in (writer, reader):
        db = pkg.Database.load(tmp_path / "db")
        col = db.collection("docs")
        live = np.sort(col.alloc.live_slots().astype(np.int64))
        rows.append((_stored(col.engine.x)[live].tobytes(),
                     _stored(col.engine.aux)[live],
                     col.alloc.ids_of(live.astype(np.uint64))))
        results.append(col.search_similar(queries, 8))
        db.close()
    assert rows[0][0] == rows[1][0]
    np.testing.assert_array_equal(rows[0][2], rows[1][2])
    # Replayed rows requantize in the reader's package. The port quantizes
    # as XLA does under jit, so every scale is the same bits wherever the
    # two packages' norms of the row agree; where the last ulp of a cosine
    # norm differs (tests/test_torch_search_options.py measures how
    # often), the scale, x_max / |x| / 127 or 1 / |x|, moves within rtol
    # 2^-22.
    by_id = dict(zip(ids.tolist(), vecs)) | dict(zip(extra_ids.tolist(),
                                                    extra))
    live_vecs = np.stack([by_id[int(r)] for r in rows[0][2]])
    agree = norms_agree(live_vecs)
    assert agree.mean() > 0.25
    np.testing.assert_array_equal(rows[0][1][agree], rows[1][1][agree])
    np.testing.assert_allclose(rows[0][1], rows[1][1], rtol=2.0 ** -22,
                               atol=0)
    ia, sa = _hits(results[0])
    ib, sb = _hits(results[1])
    np.testing.assert_array_equal(ia, ib)
    np.testing.assert_allclose(sa, sb, rtol=1e-6, atol=1e-6)
    assert not set(ids[::7].tolist()) & set(ia.ravel().tolist())


@pytest.mark.parametrize("dtype", ["int8", "float32"])
def test_same_ops_write_the_same_wal_bytes(tmp_path, rng, dtype):
    """The same operations through either package leave byte-equal WAL
    segments: the database's and the collection's."""
    vecs = rng.standard_normal((300, 16)).astype(np.float32)
    for pkg in (vrod_tpu, vrod_tpu_torch):
        db = pkg.Database.new(tmp_path / pkg.__name__, "db")
        col = db.create_collection("docs", dim=16, metric="l2", dtype=dtype,
                                   segment_rows=128)
        ids = col.bulk_insert(vecs[:200], [f"a{i}" for i in range(200)])
        col.delete_many(ids[:30])
        col.bulk_insert(vecs[200:])
        db.close()
    wals = []
    for pkg in (vrod_tpu, vrod_tpu_torch):
        root = tmp_path / pkg.__name__ / "db"
        wals.append([(root / "vr_wal").read_bytes(),
                     (root / "collections" / "docs" / "vr_wal").read_bytes()])
    assert all(len(w) > 0 for w in wals[0])
    assert wals[0] == wals[1]
