"""int4 packed collections: the capacity tier (two dims per stored byte —
half of int8's HBM per row, ~2x the rows per chip).

Contract: identical to int8 — rows quantize symmetrically per row (scale =
max|base|/7, values in [-7, 7]) and pack two-per-byte in a dim-half nibble
split (``distances.pack_int4``); the fast scan unpacks in-kernel and runs
two half-dim integer MXU dots against the int8-quantized query; the exact
rescore scores dequantized candidates against the full f32 query.
recall@k = 1.0 is with respect to the stored (4-bit) representation — the
same exact-vs-stored-representation contract as int8/bf16 storage.

``tests/test_int4.py`` (15 cases) over ``vrod_tpu_torch``, the same cases
and oracles; ``impl="pallas"`` is the port's K1 path (its plain version on
the CPU). Rewritten to the port's API: ``pack_int4``/``unpack_int4``/
``prepare_rows`` take and return torch tensors where JAX's take ``jnp``
arrays, and an 8-shard engine is ``DeviceEngine(cfg, devices=[cpu] * 8)``.
"""

import numpy as np
import pytest
import torch

from vrod_tpu_torch.config import CollectionConfig, ConfigError
from vrod_tpu_torch.engine import DeviceEngine
from vrod_tpu_torch.ops import distances as D


def unpack_rows_np(packed: np.ndarray) -> np.ndarray:
    """NumPy reference unpack: byte j -> (lo nibble = dim j,
    hi nibble = dim j + D/2), sign-extended."""
    p = np.asarray(packed, dtype=np.int8)
    lo = ((p.astype(np.int32) << 28) >> 28).astype(np.int8)
    hi = (p.astype(np.int32) >> 4).astype(np.int8)
    return np.concatenate([lo, hi], axis=-1)


def dequant_rows(eng) -> np.ndarray:
    """The engine's stored rows, dequantized to f64 (the oracle domain)."""
    full = unpack_rows_np(np.asarray(eng.x)).astype(np.float64)
    return full * np.asarray(eng.aux, dtype=np.float64)[:, None]


def brute_force_on_dequant(eng, q, k, metric):
    """Oracle over the engine's own dequantized rows (f64)."""
    rows = dequant_rows(eng)
    valid = np.asarray(eng.valid)
    q64 = np.asarray(q, dtype=np.float64)
    if metric == "l2":
        d2 = ((q64[:, None, :] - rows[None, :, :]) ** 2).sum(axis=2)
        d2[:, ~valid] = np.inf
        order = np.argsort(d2, axis=1, kind="stable")
        return order[:, :k], np.take_along_axis(d2, order[:, :k], axis=1)
    if metric == "cosine":
        q64 = q64 / np.linalg.norm(q64, axis=1, keepdims=True)
    s = q64 @ rows.T
    s[:, ~valid] = -np.inf
    order = np.argsort(-s, axis=1, kind="stable")
    return order[:, :k], np.take_along_axis(s, order[:, :k], axis=1)


def test_pack_unpack_roundtrip(rng):
    vals = rng.integers(-8, 8, size=(37, 64), dtype=np.int64).astype(np.int8)
    packed = D.pack_int4(torch.from_numpy(vals)).numpy()
    assert packed.shape == (37, 32) and packed.dtype == np.int8
    np.testing.assert_array_equal(unpack_rows_np(packed), vals)
    lo, hi = (a.numpy() for a in D.unpack_int4(torch.from_numpy(packed)))
    np.testing.assert_array_equal(lo, vals[:, :32])
    np.testing.assert_array_equal(hi, vals[:, 32:])


def test_pack_odd_dim_rejected():
    with pytest.raises(ValueError, match="even dim"):
        D.pack_int4(torch.zeros((2, 7), dtype=torch.int8))


@pytest.mark.parametrize("metric", ["cosine", "dot", "l2"])
def test_prepare_rows_int4(rng, metric):
    vecs = rng.standard_normal((20, 32)).astype(np.float32)
    rows, aux = D.prepare_rows(torch.from_numpy(vecs), metric=metric,
                               dtype="int4")
    assert rows.shape == (20, 16) and rows.dtype == torch.int8
    vals = unpack_rows_np(np.asarray(rows))
    assert np.abs(vals).max() <= 7
    # dequantized rows approximate the (normalized, for cosine) input to
    # within half a quantization step per component
    base = vecs if metric != "cosine" else (
        vecs / np.linalg.norm(vecs, axis=1, keepdims=True))
    deq = vals.astype(np.float64) * np.asarray(aux)[:, None]
    step = np.asarray(aux)[:, None]
    assert np.abs(deq - base).max() <= (0.5 + 1e-6) * step.max()


@pytest.mark.parametrize("metric", ["cosine", "dot", "l2"])
def test_int4_search_exact_vs_dequant_oracle(rng, metric):
    cfg = CollectionConfig(name="q4", dim=32, metric=metric, dtype="int4",
                           segment_rows=256, shards=1)
    eng = DeviceEngine(cfg)
    assert eng.x.shape[1] == 16  # packed storage: dim/2 bytes per row
    n = 256
    vecs = rng.standard_normal((n, 32)).astype(np.float32)
    eng.ensure_capacity(n)
    eng.write(np.arange(n, dtype=np.uint64), vecs)
    eng.erase(np.arange(0, n, 9))
    q = rng.standard_normal((8, 32)).astype(np.float32)
    vals, idx = eng.search(q, k=10)
    oi, ov = brute_force_on_dequant(eng, q, 10, metric)
    for b in range(8):
        np.testing.assert_allclose(vals[b], ov[b], rtol=1e-4, atol=1e-4)
        assert (idx[b] % 9 != 0).all()


@pytest.mark.parametrize("metric", ["cosine", "l2"])
def test_int4_sharded_matches_single(rng, metric):
    cfg1 = CollectionConfig(name="s1", dim=16, metric=metric, dtype="int4",
                            segment_rows=64, shards=1)
    cfg8 = CollectionConfig(name="s8", dim=16, metric=metric, dtype="int4",
                            segment_rows=64, shards=8)
    e1 = DeviceEngine(cfg1)
    e8 = DeviceEngine(cfg8, devices=[torch.device("cpu")] * 8)
    n = 512
    vecs = rng.standard_normal((n, 16)).astype(np.float32)
    for e in (e1, e8):
        e.ensure_capacity(n)
        e.write(np.arange(n, dtype=np.uint64), vecs)
    q = rng.standard_normal((4, 16)).astype(np.float32)
    v1, i1 = e1.search(q, k=5)
    v8, i8 = e8.search(q, k=5)
    np.testing.assert_allclose(v1, v8, rtol=1e-6)
    np.testing.assert_array_equal(i1, i8)


@pytest.mark.parametrize("metric", ["cosine", "dot", "l2"])
def test_int4_pallas_interpret_matches_scan(rng, metric):
    """The packed fused kernel (interpreted) agrees with the scan path —
    the same program the engine compiles on real TPU."""
    cfg = CollectionConfig(name="pk", dim=256, metric=metric, dtype="int4",
                           segment_rows=512)
    eng = DeviceEngine(cfg)
    n = 512
    vecs = rng.standard_normal((n, 256)).astype(np.float32)
    eng.ensure_capacity(n)
    eng.write(np.arange(n, dtype=np.uint64), vecs)
    q = rng.standard_normal((8, 256)).astype(np.float32)
    vp, ip = eng.search(q, k=12, impl="pallas")
    vs, is_ = eng.search(q, k=12, impl="scan")
    np.testing.assert_array_equal(ip, is_)
    np.testing.assert_allclose(vp, vs, rtol=1e-5, atol=1e-5)


def test_int4_l2_norms_lane_lifecycle(tmp_path, rng):
    """int4+l2 maintains the derivable |x_hat|^2 lane through mutations,
    compaction and restore — pallas == scan after every step (the int8+l2
    lifecycle guard, on the packed tier)."""
    from vrod_tpu_torch.collection import Collection
    cfg = CollectionConfig(name="n4", dim=64, metric="l2", dtype="int4",
                           segment_rows=64)
    col = Collection.create(tmp_path / "n4", cfg)
    assert col.engine.has_norms and col.engine.packed
    ids = list(col.bulk_insert(
        rng.standard_normal((96, 64)).astype(np.float32)))
    q = rng.standard_normal((4, 64)).astype(np.float32)

    def check():
        vp, ip = col.engine.search(q, k=8, impl="pallas")
        vs, is_ = col.engine.search(q, k=8, impl="scan")
        np.testing.assert_array_equal(ip, is_)
        np.testing.assert_allclose(vp, vs, rtol=1e-5, atol=1e-5)

    check()
    for r in ids[::3]:
        col.delete(int(r))
    check()
    col.update(int(ids[1]), rng.standard_normal(64).astype(np.float32))
    check()
    col.reindex()
    check()
    col.snapshot()
    col.close()
    col = Collection.load(tmp_path / "n4")
    check()
    col.close()


def test_int4_collection_durability_roundtrip(tmp_path, rng):
    from vrod_tpu_torch.collection import Collection
    cfg = CollectionConfig(name="dur", dim=16, metric="cosine", dtype="int4",
                           segment_rows=64)
    col = Collection.create(tmp_path / "dur", cfg)
    vecs = rng.standard_normal((40, 16)).astype(np.float32)
    rids = col.bulk_insert(vecs, [f"p{i}" for i in range(40)])
    hits_before = col.search_similar(vecs[3], k=3)
    col.snapshot()
    col.insert(rng.standard_normal(16), "tail")
    col.close()
    col2 = Collection.load(tmp_path / "dur")
    assert col2.count == 41
    hits_after = col2.search_similar(vecs[3], k=3)
    assert hits_before[0].record_id == hits_after[0].record_id == int(rids[3])
    # get() returns the dequantized stored row: 4 bits/dim still keeps a
    # stored vector its own nearest direction at dim 16
    got = col2.get(int(rids[3])).vector
    assert got.shape == (16,)  # full dim, not the packed byte width
    cos = float(got @ vecs[3] / (np.linalg.norm(got) * np.linalg.norm(vecs[3])))
    assert cos > 0.97
    col2.close()


def test_int4_snapshot_roundtrip_bit_exact(tmp_path, rng):
    """Stored-representation snapshots restore packed rows and scales
    bit-exactly (no requantization drift across cycles)."""
    from vrod_tpu_torch.collection import Collection
    cfg = CollectionConfig(name="bx", dim=16, metric="cosine", dtype="int4",
                           segment_rows=64)
    col = Collection.create(tmp_path / "bx", cfg)
    col.bulk_insert(rng.standard_normal((30, 16)).astype(np.float32))
    x_before = np.asarray(col.engine.x)[:30].copy()
    aux_before = np.asarray(col.engine.aux)[:30].copy()
    col.snapshot()
    col.close()
    for cycle in range(3):
        col = Collection.load(tmp_path / "bx")
        col.snapshot()
        col.close()
    col = Collection.load(tmp_path / "bx")
    slots = [col.alloc.slot_of(r) for r in range(1, 31)]
    np.testing.assert_array_equal(x_before, np.asarray(col.engine.x)[slots])
    np.testing.assert_array_equal(aux_before,
                                  np.asarray(col.engine.aux)[slots])
    col.close()


def test_int4_snapshot_verifies(tmp_path, rng):
    """BACKUP image verification understands the packed row width (a
    count x dim x int8 size check would flag every int4 snapshot)."""
    from vrod_tpu_torch.database import Database
    db = Database.new(tmp_path, "v4db")
    col = db.create_collection("c", dim=32, dtype="int4", segment_rows=64)
    col.bulk_insert(rng.standard_normal((20, 32)).astype(np.float32))
    db.backup(tmp_path / "img")
    from vrod_tpu_torch.verify_image import verify_image
    rep = verify_image(tmp_path / "img")
    assert rep["ok"], rep["errors"]
    db.close()


def test_int4_odd_dim_rejected():
    with pytest.raises(ConfigError, match="even dim"):
        CollectionConfig(name="odd", dim=33, dtype="int4")


def test_int4_cli_create_and_search(tmp_path, rng):
    """CREATE ...;dtype=int4 through the command layer, then the full
    insert -> search round trip (the reference's verb surface on the
    capacity tier)."""
    from vrod_tpu_torch.database import Database
    from vrod_tpu_torch.commands.builder import CommandBuilder
    db = Database.new(tmp_path, "clidb")
    cb = CommandBuilder(db)
    cb.build(None, "CREATE", "c4;dim=8;metric=cosine;dtype=int4;"
             "segment_rows=64").execute()
    col = db.collection("c4")
    assert col.config.dtype == "int4"
    vec = rng.standard_normal(8).astype(np.float32)
    cb.build("c4", "INSERT", ",".join(f"{v:.6f}" for v in vec)
             + ";hello").execute()
    hits = col.search_similar(vec, k=1)
    assert hits[0].record_id == 1 and hits[0].payload == "hello"
    db.close()


def test_int4_filtered_search(rng):
    """Filter masks AND into the validity stream identically on the
    packed tier."""
    cfg = CollectionConfig(name="f4", dim=16, metric="cosine", dtype="int4",
                           segment_rows=256)
    eng = DeviceEngine(cfg)
    n = 256
    eng.ensure_capacity(n)
    eng.write(np.arange(n, dtype=np.uint64),
              rng.standard_normal((n, 16)).astype(np.float32))
    q = rng.standard_normal((4, 16)).astype(np.float32)
    allow = np.arange(0, n, 5)
    mask = eng.filter_mask_from_slots(allow, mode="within")
    _, idx = eng.search(q, k=6, filter_mask=mask)
    assert (idx % 5 == 0).all()


def test_int4_exact_lookup_dequantizes(rng):
    """engine.gather (the SEARCH exact-lookup path) returns the
    dequantized stored row for packed collections: f32(unpacked nibble)
    * f32(scale), bit-for-bit — the same value the rescore scores
    against."""
    cfg = CollectionConfig(name="g4", dim=32, metric="cosine", dtype="int4",
                           segment_rows=64)
    eng = DeviceEngine(cfg)
    n = 48
    eng.ensure_capacity(n)
    eng.write(np.arange(n, dtype=np.uint64),
              rng.standard_normal((n, 32)).astype(np.float32))
    slots = np.array([0, 7, 31, 47], dtype=np.int64)
    got = eng.gather(slots)
    assert got.shape == (4, 32) and got.dtype == np.float32
    expect = unpack_rows_np(np.asarray(eng.x)[slots]).astype(np.float32) \
        * np.asarray(eng.aux)[slots][:, None].astype(np.float32)
    np.testing.assert_array_equal(got, expect)
    # And through the collection layer: Record.vector is the same bytes.
    from vrod_tpu_torch.database import Database
    import tempfile
    with tempfile.TemporaryDirectory() as td:
        db = Database.new(td, "lkp")
        col = db.create_collection("c", dim=32, dtype="int4",
                                   segment_rows=64)
        vecs = rng.standard_normal((8, 32)).astype(np.float32)
        col.bulk_insert(vecs, [f"p{i}" for i in range(8)])
        rec = col.get(3)
        stored = unpack_rows_np(np.asarray(col.engine.x)) \
            .astype(np.float32) * np.asarray(col.engine.aux)[:, None] \
            .astype(np.float32)
        slot = int(col.alloc.slots_of(np.array([3], np.uint64))[0])
        np.testing.assert_array_equal(rec.vector, stored[slot])
        db.close()


def test_int4_engine_count_floor_gate_open(rng, monkeypatch):
    """The sampled-floor warm start runs on packed collections with the
    gate ACTUALLY OPEN (a spy proves the count threshold computed), and
    results stay bit-identical to the exact scan. Gate arithmetic
    mirrors test_engine_count_floor_results_exact (int8): rows 32768,
    k=16 -> k_scan 28, blk 2048 -> n_sample 6144, nsub 384 >= 2*28,
    rows >= 4*6144 — OPEN; int4 inherits the int8 theta0 gate (quant
    tier). dim=96 keeps the trace unique from every other int4 test."""
    monkeypatch.setenv("VROD_THETA0_METHOD", "count")
    monkeypatch.setenv("VROD_THETA0_BLK", "2048")
    seen = {}
    orig = D.kth_largest_count

    def spy(sub, k):
        seen["k"] = k
        return orig(sub, k)

    monkeypatch.setattr(D, "kth_largest_count", spy)
    cfg = CollectionConfig(name="cnt4", dim=96, metric="cosine",
                           dtype="int4", segment_rows=32768, shards=1)
    eng = DeviceEngine(cfg)
    n = 32768
    vecs = rng.standard_normal((n, 96)).astype(np.float32)
    eng.ensure_capacity(n)
    eng.write(np.arange(n, dtype=np.uint64), vecs)
    eng.erase(np.arange(0, n, 11))
    q = rng.standard_normal((8, 96)).astype(np.float32)
    vp, ip = eng.search(q, k=16, impl="pallas")
    vs, is_ = eng.search(q, k=16, impl="scan")
    np.testing.assert_array_equal(ip, is_)
    np.testing.assert_allclose(vp, vs, rtol=1e-6)
    assert seen.get("k") == 28, "count threshold never ran (gate closed?)"
