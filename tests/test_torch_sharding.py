"""The port's row sharding against the JAX package's, on the CPU.

The port shards over ``[cpu] * 8`` (torch has one CPU device; the list
stands in for XLA's 8 forced host devices, which ``conftest.py`` gives the
JAX engine). On the same seeded rows, deletes and queries:

- ``capacity`` and ``rows_local`` equal the JAX engine's after every growth
  and shrink, and every slot sits where XLA's re-sharding puts it (the
  port's gathered state equals ``np.asarray(jax_engine.x)``);
- with the JAX engine's stored state carried over
  (``convert.engine_state_from_numpy`` + ``load_state``), every dtype x
  metric returns the JAX engine's ids in the same order, tied rows lowest
  slot first, and the same ``-inf``/``-1`` empty ranks, through the kernels'
  path (JAX: Pallas in interpret mode) and the plain scan, with and without
  the rescore. Values agree to rtol 1e-6 and atol 2e-6 (the tolerance of
  ``test_torch_search_options.py``: the rescore's float32 sums run in
  another order than XLA's, at one shard as at eight); l2's finalize
  ``|q|^2 - s`` cancels, so its atol is 1e-6 * |q|^2 (at least 1e-5, the
  other file's), which a query equal to a stored row reaches. The port at
  eight shards and at one return bit-equal values and ids;
- the JAX sharded cases over the port (``test_search.py``'s exact recall
  at 8 shards and growth, ``test_collection.py``'s sharded collection and
  restore on a smaller topology), ``filter_mask`` and ``move`` across
  shards, and ``dryrun_multichip(8)``.

float32 rows through the kernels' path are compared at precision "high"
when the rescore is off: at "fast" the port scores float32 in TF32 (its
kernels' leg) where the Pallas kernel in interpret mode does not.
"""

import dataclasses
import warnings

import jax
import numpy as np
import pytest
import torch

from vrod_tpu.collection import Collection as JaxCollection
from vrod_tpu.config import CollectionConfig
from vrod_tpu.engine import DeviceEngine as JaxEngine
from vrod_tpu_torch import convert
from vrod_tpu_torch.collection import Collection
from vrod_tpu_torch.config import CollectionConfig as PortConfig
from vrod_tpu_torch.engine import DeviceEngine
from vrod_tpu_torch.parallel import make_mesh, replicated
from vrod_tpu_torch.parallel.dryrun import dryrun_multichip
from vrod_tpu_torch.runtime import default_devices

from conftest import numpy_topk_oracle

CPU8 = [torch.device("cpu")] * 8
DTYPES = ("float32", "bfloat16", "int8", "int4")
METRICS = ("cosine", "dot", "l2")


def pair(dtype="float32", metric="cosine", dim=32, segment_rows=64,
         shards=8):
    """A JAX engine over 8 CPU devices and the port's over [cpu] * 8."""
    cfg = CollectionConfig(name="s", dim=dim, metric=metric, dtype=dtype,
                           segment_rows=segment_rows, shards=shards)
    je = JaxEngine(cfg, devices=jax.devices("cpu")[:shards])
    pe = DeviceEngine(PortConfig(**dataclasses.asdict(cfg)),
                      devices=CPU8[:shards])
    assert je.shards == pe.shards == shards
    return je, pe


def carry(je, pe):
    """Install the JAX engine's stored state in the port's engine."""
    pe.load_state(*convert.engine_state_from_numpy(
        pe.cfg, np.asarray(je.x), np.asarray(je.aux), np.asarray(je.valid),
        "cpu"))
    assert pe.capacity == je.capacity and pe.rows_local == je.rows_local


def assert_same(got, want, metric, q, err=""):
    v, i = got
    jv, ji = (np.asarray(a) for a in want)
    np.testing.assert_array_equal(i, ji, err_msg=err)
    atol = 2e-6
    if metric == "l2":
        atol = max(1e-5, 1e-6 * float((q.astype(np.float64) ** 2).sum(1)
                                      .max()))
    np.testing.assert_allclose(v, jv, rtol=1e-6, atol=atol, err_msg=err)


def test_mesh_and_devices():
    with pytest.raises(ValueError, match="only 2 devices"):
        make_mesh(3, CPU8[:2])
    mesh = make_mesh(4, CPU8)
    assert mesh.size == 4 and mesh.local == (0, 1, 2, 3)
    assert not mesh.multiprocess
    assert mesh.shards_of(0) == (0, 1, 2, 3)
    assert replicated(mesh) == torch.device("cpu")
    assert default_devices() == [torch.device("cpu")]
    cfg = PortConfig(name="m", dim=16, segment_rows=64, shards=4)
    with pytest.raises(ValueError, match="not both"):
        DeviceEngine(cfg, devices=CPU8, device="cpu")
    # No warning when the devices suffice; the JAX warning when not.
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        eng = DeviceEngine(cfg, devices=CPU8)
    assert eng.shards == 4
    # No one tensor holds a sharded state: reading one raises.
    with pytest.raises(AttributeError, match="gather_state"):
        eng.x
    with pytest.warns(UserWarning, match="configured for 4 shards"):
        assert DeviceEngine(cfg).shards == 1
    with pytest.warns(UserWarning, match="configured for 4 shards"):
        assert DeviceEngine(cfg, device="cpu").shards == 1


def test_capacity_and_layout_follow_jax(rng):
    """Growth and shrink keep the JAX engine's capacity, rows_local and
    slot layout, for each lane (x, aux, valid; int8 + l2's norms too)."""
    je, pe = pair("int8", "l2", segment_rows=64)
    steps = [("grow", 100), ("grow", 1000), ("grow", 2400),
             ("shrink", 700), ("shrink", 10), ("grow", 1500)]
    written = 0
    for what, n in steps:
        for e in (je, pe):
            (e.ensure_capacity if what == "grow" else e.shrink_capacity)(n)
        assert (pe.capacity, pe.rows_local) == (je.capacity, je.rows_local)
        if what == "grow" and n > written:
            vecs = rng.standard_normal((n - written, 32)).astype(np.float32)
            for e in (je, pe):
                e.write(np.arange(written, n), vecs)
            written = n
        else:
            written = min(written, je.capacity)
        px, _, pvalid, pnorms = (t.numpy() for t in pe.gather_state())
        np.testing.assert_array_equal(pvalid, np.asarray(je.valid))
        np.testing.assert_array_equal(pnorms != 0, np.asarray(je.norms) != 0)
        jx = np.asarray(je.x)
        live = np.asarray(je.valid)
        # Stored bytes equal wherever the rows' norms agree (the stated
        # last-ulp rate of the cosine/l2 quantizer is 5.4e-7; at these
        # sizes every byte agrees within 1).
        assert np.abs(px[live].astype(int)
                      - jx[live].astype(int)).max(initial=0) <= 1
        assert (px[~live] == jx[~live]).all()


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_search_matches_jax(rng, dtype, metric):
    """Same ids in the same order, tie order and empty ranks as the JAX
    engine at 8 shards, on the JAX engine's own stored state."""
    je, pe = pair(dtype, metric)
    n = 430
    vecs = rng.standard_normal((n, 32)).astype(np.float32)
    vecs[200:206] = vecs[5]          # ties spread over shards 0 and 3
    je.ensure_capacity(n)
    je.write(np.arange(n), vecs)
    je.erase(np.arange(0, n, 9))
    carry(je, pe)
    q = rng.standard_normal((6, 32)).astype(np.float32)
    q[0] = vecs[5]
    for impl in ("pallas", "scan"):
        for k in (5, 100):
            for rescore in (True, False):
                precision = "high" if (dtype == "float32" and not rescore
                                       and impl == "pallas") else "fast"
                kw = dict(impl=impl, rescore=rescore, precision=precision)
                got = pe.search(q, k, **kw)
                assert_same(got, je.search(q, k, **kw), metric, q,
                            err=str(kw))
    # Ties: the six equal rows come lowest slot first.
    _, idx = pe.search(q[:1], 7, impl="pallas")
    tied = [i for i in idx[0] if i in (5, 200, 201, 202, 203, 204, 205)]
    assert tied == sorted(tied) and len(tied) >= 6
    # Empty ranks: k beyond the live rows (-inf, or +inf for l2, and -1).
    je2, pe2 = pair(dtype, metric)
    je2.write(np.arange(3), vecs[:3])
    carry(je2, pe2)
    for impl in ("pallas", "scan"):
        got = pe2.search(q[:2], 10, impl=impl)
        assert_same(got, je2.search(q[:2], 10, impl=impl), metric, q)
        assert (got[1][:, 3:] == -1).all()
        assert np.isinf(got[0][:, 3:]).all()


@pytest.mark.parametrize("dtype", DTYPES)
def test_eight_shards_equal_one_shard(rng, dtype):
    """The port at 8 shards returns bit for bit the port at 1 shard, for
    each metric, on the same writes (each chunk is quantized whole)."""
    for metric in METRICS:
        cfg = PortConfig(name="e", dim=32, metric=metric, dtype=dtype,
                         segment_rows=64, shards=8)
        e8 = DeviceEngine(cfg, devices=CPU8)
        e1 = DeviceEngine(dataclasses.replace(cfg, segment_rows=512,
                                              shards=1), device="cpu")
        vecs = rng.standard_normal((500, 32)).astype(np.float32)
        for e in (e8, e1):
            e.ensure_capacity(500)
            e.write(np.arange(500), vecs)
            e.erase(np.arange(0, 500, 6))
        assert e8.capacity == e1.capacity == 512
        x8, aux8 = e8.gather_state()[:2]
        assert (x8 == e1.x).all() and (aux8 == e1.aux).all()
        q = rng.standard_normal((9, 32)).astype(np.float32)
        for impl in ("pallas", "scan"):
            for k in (1, 16, 100):
                a, b = e8.search(q, k, impl=impl), e1.search(q, k, impl=impl)
                np.testing.assert_array_equal(a[1], b[1])
                np.testing.assert_array_equal(a[0], b[0])


def test_filter_mask_and_move_across_shards(rng):
    je, pe = pair("int8", "cosine")
    n = 512
    vecs = rng.standard_normal((n, 32)).astype(np.float32)
    je.write(np.arange(n), vecs)
    carry(je, pe)
    q = vecs[[3, 70, 300]]
    allow = np.array([3, 8, 70, 130, 300, 511])
    fm, jfm = (e.filter_mask_from_slots(allow, mode="within")
               for e in (pe, je))
    assert_same(pe.search(q, 4, filter_mask=fm),
                je.search(q, 4, filter_mask=jfm, impl="pallas"), "cosine", q)
    fx, jfx = (e.filter_mask_from_slots(allow, mode="exclude")
               for e in (pe, je))
    assert_same(pe.search(q, 4, filter_mask=fx),
                je.search(q, 4, filter_mask=jfx, impl="pallas"), "cosine", q)
    # Moves from shard 7 and 4 into shards 0 and 1, as compaction does.
    src, dst = np.array([500, 300, 301]), np.array([0, 64, 65])
    for e in (je, pe):
        e.erase(dst)
        e.move(src, dst)
    px, paux, pvalid, _ = (None if t is None else t.numpy()
                           for t in pe.gather_state())
    np.testing.assert_array_equal(pvalid, np.asarray(je.valid))
    np.testing.assert_array_equal(px, np.asarray(je.x))
    np.testing.assert_array_equal(paux, np.asarray(je.aux))
    for impl in ("pallas", "scan"):
        assert_same(pe.search(q, 5, impl=impl),
                    je.search(q, 5, impl=impl), "cosine", q)
    _, idx = pe.search(vecs[500:501], 1)
    assert idx[0, 0] == 0
    np.testing.assert_array_equal(pe.gather(np.array([0, 64])),
                                  np.asarray(je.gather(np.array([0, 64]))))
    rows, aux = pe.gather_raw(np.array([64, 0, 511]))
    jrows, jaux = je.gather_raw(np.array([64, 0, 511]))
    np.testing.assert_array_equal(rows, jrows)
    np.testing.assert_array_equal(aux, jaux)


# -- the JAX suites' sharded cases, over the port ---------------------------


def make_engine(metric="cosine", shards=1, dim=48, segment_rows=128):
    cfg = PortConfig(name="t", dim=dim, metric=metric, dtype="float32",
                     segment_rows=segment_rows, shards=shards)
    return DeviceEngine(cfg, devices=CPU8)


def fill(eng, rng, n, dim):
    vecs = rng.standard_normal((n, dim)).astype(np.float32)
    eng.ensure_capacity(n)
    eng.write(np.arange(n, dtype=np.uint64), vecs)
    return vecs


@pytest.mark.parametrize("metric", ["cosine", "l2", "dot"])
def test_exact_recall_eight_shards(metric, rng):
    """``test_search.py::test_exact_recall`` at shards=8."""
    eng = make_engine(metric=metric, shards=8)
    assert eng.shards == 8
    n, dim, k = 1500, 48, 10
    vecs = fill(eng, rng, n, dim)
    q = rng.standard_normal((4, dim)).astype(np.float32)
    vals, idx = eng.search(q, k)
    oracle_idx, _ = numpy_topk_oracle(vecs, np.arange(n), q, k, metric)
    for b in range(q.shape[0]):
        assert set(idx[b]) == set(oracle_idx[b]), (metric, b)


def test_growth_recompiles_and_stays_exact(rng):
    """``test_search.py::test_growth_recompiles_and_stays_exact``."""
    eng = make_engine(shards=8, segment_rows=64)
    dim = 48
    vecs1 = rng.standard_normal((400, dim)).astype(np.float32)
    eng.ensure_capacity(400)
    eng.write(np.arange(400, dtype=np.uint64), vecs1)
    cap1 = eng.capacity
    vecs2 = rng.standard_normal((2000, dim)).astype(np.float32)
    eng.ensure_capacity(2400)
    assert eng.capacity > cap1
    assert eng.capacity % 8 == 0
    eng.write(np.arange(400, 2400, dtype=np.uint64), vecs2)
    allv = np.concatenate([vecs1, vecs2])
    q = rng.standard_normal((2, dim)).astype(np.float32)
    vals, idx = eng.search(q, 10)
    oracle_idx, _ = numpy_topk_oracle(allv, np.arange(2400), q, 10, "cosine")
    for b in range(2):
        assert set(idx[b]) == set(oracle_idx[b])


def new_col(tmp_path, name="c", devices=CPU8, **kw):
    kw.setdefault("dim", 16)
    kw.setdefault("segment_rows", 64)
    cfg = PortConfig(name=name, **kw)
    return Collection.create(tmp_path / name, cfg, devices=devices)


def test_sharded_collection(tmp_path, rng):
    """``test_collection.py::test_sharded_collection``; the snapshot also
    loads in the JAX package at 8 shards."""
    col = new_col(tmp_path, shards=8)
    vecs = rng.standard_normal((500, 16)).astype(np.float32)
    rids = col.bulk_insert(vecs)
    hits = col.search_similar(vecs[123], k=3)
    assert hits[0].record_id == rids[123]
    col.snapshot()
    col.close()
    col2 = Collection.load(tmp_path / "c", devices=CPU8)
    assert col2.engine.shards == 8
    hits = col2.search_similar(vecs[123], k=3)
    assert hits[0].record_id == rids[123]
    col2.close()
    jcol = JaxCollection.load(tmp_path / "c")
    assert jcol.engine.shards == 8
    assert jcol.search_similar(vecs[123], k=3)[0].record_id == rids[123]
    jcol.close()


def test_restore_on_smaller_topology(tmp_path, rng):
    """``test_collection.py::test_restore_on_smaller_topology``: an 8-shard
    snapshot restores on 2 devices with the warning."""
    col = new_col(tmp_path, name="pod", shards=8)
    vecs = rng.standard_normal((300, 16)).astype(np.float32)
    rids = col.bulk_insert(vecs)
    col.snapshot()
    col.close()
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        col2 = Collection.load(tmp_path / "pod", devices=CPU8[:2])
        assert any("shards" in str(x.message) for x in w)
    assert col2.engine.shards == 2
    assert col2.count == 300
    hits = col2.search_similar(vecs[123], k=1)
    assert hits[0].record_id == rids[123]


def test_collection_eight_shards_answers_as_one(tmp_path, rng):
    """One collection at shards=8 and one at shards=1 (same inserts,
    deletes and queries) give the same hits, scores bit-equal; a
    ``Database`` passes ``devices=`` to its collections."""
    from vrod_tpu_torch.database import Database
    db8 = Database.new(tmp_path, "d8", devices=CPU8)
    db1 = Database.new(tmp_path, "d1", device="cpu")
    c8 = db8.create_collection("c", dim=24, metric="cosine", dtype="int8",
                               segment_rows=64, shards=8)
    c1 = db1.create_collection("c", dim=24, metric="cosine", dtype="int8",
                               segment_rows=512, shards=1)
    assert c8.engine.shards == 8 and c1.engine.shards == 1
    vecs = rng.standard_normal((450, 24)).astype(np.float32)
    for c in (c8, c1):
        rids = c.bulk_insert(vecs)
        c.delete_many(rids[::5])
    q = rng.standard_normal((12, 24)).astype(np.float32)
    for k in (1, 10, 40):
        a, b = c8.search_similar(q, k=k), c1.search_similar(q, k=k)
        assert [[(h.record_id, h.score) for h in hs] for hs in a] == \
            [[(h.record_id, h.score) for h in hs] for hs in b]
    db8.close()
    db1.close()
    db8 = Database.load(tmp_path / "d8", devices=CPU8[:4])
    with pytest.warns(UserWarning, match="configured for 8 shards"):
        assert db8.collection("c").engine.shards == 4
    db8.close()


def test_dryrun_multichip():
    dryrun_multichip(8)
