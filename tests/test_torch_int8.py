"""int8 quantized-scan collections: exactness vs the stored (quantized)
representation, pallas/scan agreement, config rules, durability round-trip.

Contract: rows are symmetrically quantized per row at insert; the fast scan
runs on the integer MXU with a quantized query; the exact rescore scores
dequantized candidates against the full f32 query. recall@k = 1.0 is with
respect to the stored representation — the same contract as bf16 storage.

``tests/test_int8.py`` (16 cases) over ``vrod_tpu_torch``, the same cases
and oracles; ``impl="pallas"`` is the port's K1 path (its plain version on
the CPU). Rewritten to the port's API: an 8-shard engine is
``DeviceEngine(cfg, devices=[cpu] * 8)``; the kernel that must refuse l2
without its extras is ``ops.cuda_topk.fused_topk`` on torch tensors (JAX:
``pallas_topk.fused_topk`` in interpret mode); the direct fill writes the
one-shard engine's torch ``x``/``aux``/``valid`` in place (JAX rebinds
``eng.x = eng.x.at[:n].set(...)``).
"""

import numpy as np
import pytest
import torch

from vrod_tpu_torch.config import CollectionConfig, ConfigError
from vrod_tpu_torch.engine import DeviceEngine


def brute_force_on_dequant(eng, q, k, metric):
    """Oracle over the engine's own dequantized rows (f64)."""
    n = eng.capacity
    x = np.asarray(eng.x).astype(np.float64)
    aux = np.asarray(eng.aux).astype(np.float64)
    valid = np.asarray(eng.valid)
    rows = x * aux[:, None]
    q64 = np.asarray(q, dtype=np.float64)
    if metric == "l2":
        # User-facing l2 scores are squared distances, ascending.
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


@pytest.mark.parametrize("metric", ["cosine", "dot", "l2"])
def test_int8_search_exact_vs_dequant_oracle(rng, metric):
    cfg = CollectionConfig(name="q8", dim=32, metric=metric, dtype="int8",
                           segment_rows=256, shards=1)
    eng = DeviceEngine(cfg)
    n = 256
    vecs = rng.standard_normal((n, 32)).astype(np.float32)
    eng.ensure_capacity(n)
    eng.write(np.arange(n, dtype=np.uint64), vecs)
    eng.erase(np.arange(0, n, 9))
    q = rng.standard_normal((8, 32)).astype(np.float32)
    vals, idx = eng.search(q, k=10)
    oi, ov = brute_force_on_dequant(eng, q, 10, metric)
    for b in range(8):
        # tie-aware: scores must match the oracle's to fp tolerance
        np.testing.assert_allclose(vals[b], ov[b], rtol=1e-4, atol=1e-4)
        assert (idx[b] % 9 != 0).all()


def test_int8_l2_sharded_matches_single(rng):
    cfg1 = CollectionConfig(name="l1", dim=16, metric="l2", dtype="int8",
                            segment_rows=64, shards=1)
    cfg8 = CollectionConfig(name="l8", dim=16, metric="l2", dtype="int8",
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


def test_int8_l2_collection_roundtrip(tmp_path, rng):
    """int8 + l2 end to end: nearest neighbor of a stored vector is itself
    (quantization noise ~1/127 per component never flips the self-match),
    and durability restores bit-exactly."""
    from vrod_tpu_torch.collection import Collection
    cfg = CollectionConfig(name="l2d", dim=16, metric="l2", dtype="int8",
                           segment_rows=64)
    col = Collection.create(tmp_path / "l2d", cfg)
    vecs = (rng.standard_normal((40, 16)) * 3).astype(np.float32)
    rids = col.bulk_insert(vecs, [f"p{i}" for i in range(40)])
    hits = col.search_similar(vecs[7], k=1)
    assert hits[0].record_id == int(rids[7])
    assert hits[0].score < 0.05  # squared quantization error, near zero
    col.snapshot()
    col.close()
    col2 = Collection.load(tmp_path / "l2d")
    assert col2.search_similar(vecs[7], k=1)[0].record_id == int(rids[7])
    col2.close()


def test_int8_sharded_matches_single(rng):
    cfg1 = CollectionConfig(name="s1", dim=16, metric="cosine", dtype="int8",
                            segment_rows=64, shards=1)
    cfg8 = CollectionConfig(name="s8", dim=16, metric="cosine", dtype="int8",
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


def test_int8_pallas_interpret_matches_scan(rng):
    cfg = CollectionConfig(name="pl", dim=128, metric="cosine", dtype="int8",
                           segment_rows=256, shards=1)
    eng = DeviceEngine(cfg)
    n = 1024
    vecs = rng.standard_normal((n, 128)).astype(np.float32)
    eng.ensure_capacity(n)
    eng.write(np.arange(n, dtype=np.uint64), vecs)
    q = rng.standard_normal((8, 128)).astype(np.float32)
    vs, is_ = eng.search(q, k=7, impl="scan")
    vp, ip = eng.search(q, k=7, impl="pallas")
    np.testing.assert_allclose(vs, vp, rtol=1e-6)
    np.testing.assert_array_equal(is_, ip)


def test_int8_l2_dim_cap():
    """|q8|^2 must stay exactly representable in f32: dim caps at 1040."""
    with pytest.raises(ConfigError, match="1040"):
        CollectionConfig(name="bad", dim=1152, metric="l2", dtype="int8")
    CollectionConfig(name="ok", dim=1024, metric="l2", dtype="int8")


def test_int8_l2_pallas_requires_extras():
    """The fused int8+l2 kernel needs row_bias (-|x_hat|^2) and the
    per-query quant scale; a direct call without them must refuse loudly
    rather than score garbage."""
    from vrod_tpu_torch.ops import cuda_topk
    x = torch.zeros((64, 16), dtype=torch.int8)
    aux = torch.ones((64,), dtype=torch.float32)
    valid = torch.ones((64,), dtype=torch.bool)
    q = torch.ones((8, 16), dtype=torch.int8)
    with pytest.raises(ValueError, match="row_bias"):
        cuda_topk.fused_topk(x, aux, valid, q, k=2, metric="l2")


@pytest.mark.parametrize("dim", [16, 128])
def test_int8_l2_pallas_matches_scan(rng, dim):
    """int8+l2 on the FUSED kernel (interpreted): per-query quant scale in
    the epilogue + |x_hat|^2 riding the mask stream must reproduce the scan
    path exactly after the rescore (both paths rescore with the full f32
    query against the dequantized rows)."""
    cfg = CollectionConfig(name=f"l2p{dim}", dim=dim, metric="l2",
                           dtype="int8", segment_rows=256, shards=1)
    eng = DeviceEngine(cfg)
    n = 1024
    vecs = (rng.standard_normal((n, dim)) * 2).astype(np.float32)
    eng.ensure_capacity(n)
    eng.write(np.arange(n, dtype=np.uint64), vecs)
    eng.erase(np.arange(0, n, 9))
    q = (rng.standard_normal((8, dim)) * 3).astype(np.float32)
    vs, is_ = eng.search(q, k=10, impl="scan")
    vp, ip = eng.search(q, k=10, impl="pallas")
    np.testing.assert_allclose(vs, vp, rtol=1e-6)
    np.testing.assert_array_equal(is_, ip)
    # and against the f64 dequant oracle
    oi, ov = brute_force_on_dequant(eng, q, 10, "l2")
    for b in range(8):
        np.testing.assert_allclose(vp[b], ov[b], rtol=1e-4, atol=1e-4)


def test_int8_l2_norms_lane_tracks_mutations(tmp_path, rng):
    """The |x_hat|^2 lane is derivable state the engine maintains through
    insert / delete / update / compaction+shrink / snapshot-restore; the
    fused path must stay oracle-exact through the whole lifecycle."""
    from vrod_tpu_torch.collection import Collection
    cfg = CollectionConfig(name="l2n", dim=16, metric="l2", dtype="int8",
                           segment_rows=64)
    col = Collection.create(tmp_path / "l2n", cfg)
    vecs = (rng.standard_normal((200, 16)) * 2).astype(np.float32)
    rids = col.bulk_insert(vecs, [f"p{i}" for i in range(200)])
    col.delete_many(rids[::3])
    col.update(int(rids[1]), vecs[0] * 5.0, "moved")
    col.reindex()  # compaction moves + capacity shrink
    col.snapshot()
    col.close()
    col = Collection.load(tmp_path / "l2n")
    eng = col.engine
    q = (rng.standard_normal((4, 16)) * 3).astype(np.float32)
    vs, is_ = eng.search(q, k=8, impl="scan")
    vp, ip = eng.search(q, k=8, impl="pallas")
    np.testing.assert_allclose(vs, vp, rtol=1e-6)
    np.testing.assert_array_equal(is_, ip)
    oi, ov = brute_force_on_dequant(eng, q, 8, "l2")
    for b in range(4):
        np.testing.assert_allclose(vp[b], ov[b], rtol=1e-4, atol=1e-4)
    col.close()


def test_int8_l2_rebuild_norms_after_direct_fill(rng):
    """Harnesses that write eng.x/eng.aux directly (bench fills on-device)
    bypass write()'s norms maintenance; rebuild_norms() must restore the
    fused path to scan-exact. (The missing call measured recall 0.195 on
    hardware — this is its regression test.)"""
    cfg = CollectionConfig(name="rbn", dim=16, metric="l2", dtype="int8",
                           segment_rows=256, shards=1)
    eng = DeviceEngine(cfg)
    n = 256
    vecs = (rng.standard_normal((n, 16)) * 2).astype(np.float32)
    from vrod_tpu_torch.ops import distances as D
    rows, auxv = D.prepare_rows(torch.from_numpy(vecs), metric="l2",
                                dtype=torch.int8)
    eng.x[:n] = rows
    eng.aux[:n] = auxv
    eng.valid[:n] = True
    eng.rebuild_norms()
    q = (rng.standard_normal((4, 16)) * 3).astype(np.float32)
    vs, is_ = eng.search(q, k=8, impl="scan")
    vp, ip = eng.search(q, k=8, impl="pallas")
    np.testing.assert_allclose(vs, vp, rtol=1e-6)
    np.testing.assert_array_equal(is_, ip)


def test_int8_l2_norms_lane_randomized_lifecycle(tmp_path, rng):
    """Randomized op sequence (insert / bulk / delete / update / reindex /
    snapshot+reload) on an int8+l2 collection; after every op the fused
    path must agree with the scan path exactly — the scan path derives
    |x_hat|^2 from rows+scale on the fly, so agreement proves the
    maintained norms lane never went stale through any mutation."""
    from vrod_tpu_torch.collection import Collection
    cfg = CollectionConfig(name="rl", dim=12, metric="l2", dtype="int8",
                           segment_rows=64)
    col = Collection.create(tmp_path / "rl", cfg)
    live = []

    def check():
        eng = col.engine
        q = (rng.standard_normal((4, 12)) * 3).astype(np.float32)
        k = min(6, max(1, col.count))
        vp, ip = eng.search(q, k=k, impl="pallas")
        vs, is_ = eng.search(q, k=k, impl="scan")
        np.testing.assert_array_equal(ip, is_)
        np.testing.assert_allclose(vp, vs, rtol=1e-6)

    for step in range(40):
        op = rng.integers(0, 6)
        if op == 0 or not live:
            live.append(int(col.insert(
                (rng.standard_normal(12) * 2).astype(np.float32), "p")))
        elif op == 1:
            rids = col.bulk_insert(
                (rng.standard_normal((7, 12)) * 2).astype(np.float32))
            live.extend(int(r) for r in rids)
        elif op == 2:
            victim = live.pop(int(rng.integers(0, len(live))))
            col.delete(victim)
        elif op == 3:
            col.update(live[int(rng.integers(0, len(live)))],
                       (rng.standard_normal(12) * 5).astype(np.float32),
                       "u")
        elif op == 4:
            col.reindex()  # compaction moves + possible shrink
        else:
            col.snapshot()
            col.close()
            col = Collection.load(tmp_path / "rl")  # restore recomputes lane
        if step % 5 == 4:
            check()
    check()
    col.close()


def test_int8_l2_sharded_pallas_matches_single(rng):
    """The norms lane shards with the rows; the 8-shard fused program must
    agree with the single-shard one."""
    cfg1 = CollectionConfig(name="lp1", dim=16, metric="l2", dtype="int8",
                            segment_rows=64, shards=1)
    cfg8 = CollectionConfig(name="lp8", dim=16, metric="l2", dtype="int8",
                            segment_rows=64, shards=8)
    e1 = DeviceEngine(cfg1)
    e8 = DeviceEngine(cfg8, devices=[torch.device("cpu")] * 8)
    n = 512
    vecs = (rng.standard_normal((n, 16)) * 2).astype(np.float32)
    for e in (e1, e8):
        e.ensure_capacity(n)
        e.write(np.arange(n, dtype=np.uint64), vecs)
    q = rng.standard_normal((4, 16)).astype(np.float32)
    v1, i1 = e1.search(q, k=5, impl="pallas")
    v8, i8 = e8.search(q, k=5, impl="pallas")
    np.testing.assert_allclose(v1, v8, rtol=1e-6)
    np.testing.assert_array_equal(i1, i8)


def test_int8_collection_durability_roundtrip(tmp_path, rng):
    from vrod_tpu_torch.collection import Collection
    cfg = CollectionConfig(name="dur", dim=16, metric="cosine", dtype="int8",
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
    # get() returns the dequantized stored row: unit-ish direction of vecs[3]
    got = col2.get(int(rids[3])).vector
    cos = float(got @ vecs[3] / (np.linalg.norm(got) * np.linalg.norm(vecs[3])))
    assert cos > 0.999
    col2.close()


def test_int8_snapshot_roundtrip_bit_exact(tmp_path, rng):
    """Stored-representation snapshots restore int8 rows and scales
    bit-exactly (no requantization drift across snapshot/restore cycles)."""
    from vrod_tpu_torch.collection import Collection
    cfg = CollectionConfig(name="bx", dim=16, metric="cosine", dtype="int8",
                           segment_rows=64)
    col = Collection.create(tmp_path / "bx", cfg)
    col.bulk_insert(rng.standard_normal((30, 16)).astype(np.float32))
    x_before = np.asarray(col.engine.x)[:30].copy()
    aux_before = np.asarray(col.engine.aux)[:30].copy()
    col.snapshot()
    col.close()
    for cycle in range(3):  # repeated cycles must not drift
        col = Collection.load(tmp_path / "bx")
        col.snapshot()
        col.close()
    col = Collection.load(tmp_path / "bx")
    # slot layout may differ; compare by record id
    slots = [col.alloc.slot_of(r) for r in range(1, 31)]
    x_after = np.asarray(col.engine.x)[slots]
    aux_after = np.asarray(col.engine.aux)[slots]
    orig_slots = list(range(30))  # created fresh in insert order
    np.testing.assert_array_equal(x_before[orig_slots], x_after)
    np.testing.assert_array_equal(aux_before[orig_slots], aux_after)
    col.close()


@pytest.mark.parametrize("metric", ["dot", "l2"])
def test_int8_dot_l2_floor_engine_bit_identical(rng, metric, monkeypatch):
    """The sampled floor now covers int8 dot AND l2 (deterministic integer
    scores need no accumulation margin): the engine pallas path with the
    floor ACTUALLY OPEN must match the scan oracle exactly.

    Gate arithmetic at this config (rows 32768, k=16 -> k_scan 28, blk
    forced to 2048): n_sample = max(128*28*2, 32768//32) = 7168 ->
    rounds to 6144; nsub = 384 >= 2*28; rows >= 4*6144 — OPEN. (At the
    default blk 8192 the sample rounds to 0 and the gate silently closes,
    which made an earlier version of this test vacuous.)"""
    import os
    monkeypatch.setenv("VROD_THETA0_BLK", "2048")
    cfg = CollectionConfig(name=f"f{metric}", dim=16, metric=metric,
                           dtype="int8", segment_rows=32768, shards=1)
    eng = DeviceEngine(cfg)
    n = 32768
    vecs = (rng.standard_normal((n, 16)) * 2).astype(np.float32)
    eng.ensure_capacity(n)
    eng.write(np.arange(n, dtype=np.uint64), vecs)
    eng.erase(np.arange(0, n, 11))
    q = (rng.standard_normal((8, 16)) * 3).astype(np.float32)
    vp, ip = eng.search(q, k=16, impl="pallas")
    vs, is_ = eng.search(q, k=16, impl="scan")
    np.testing.assert_array_equal(ip, is_)
    np.testing.assert_allclose(vp, vs, rtol=1e-6)
    assert os.environ.get("VROD_THETA0", "1") != "0"


def test_int8_small_k_floor_engine_bit_identical(rng, monkeypatch):
    """The small-k int8 sampled floor (k_scan in [24, 64), rows/32 sample)
    must not change results: engine pallas path with the floor OPEN vs
    the scan oracle, interpreted on CPU. The pre-pass block is forced to
    2048 — at the default 8192 the 7168-row sample rounds to zero blocks
    and the gate silently closes (an earlier version of this test was
    vacuous for exactly that reason; see the gate arithmetic in the
    dot/l2 variant above)."""
    import os
    monkeypatch.setenv("VROD_THETA0_BLK", "2048")
    cfg = CollectionConfig(name="skf", dim=16, metric="cosine",
                           dtype="int8", segment_rows=32768, shards=1)
    eng = DeviceEngine(cfg)
    n = 32768
    vecs = rng.standard_normal((n, 16)).astype(np.float32)
    eng.ensure_capacity(n)
    eng.write(np.arange(n, dtype=np.uint64), vecs)
    eng.erase(np.arange(0, n, 11))
    q = rng.standard_normal((8, 16)).astype(np.float32)
    # k=16 -> k_out 16, int8 margin 12 -> k_scan 28 >= MINK 24;
    # n_sample = 7168 -> 6144 at blk 2048 (three pre-pass blocks).
    vp, ip = eng.search(q, k=16, impl="pallas")
    vs, is_ = eng.search(q, k=16, impl="scan")
    np.testing.assert_array_equal(ip, is_)
    np.testing.assert_allclose(vp, vs, rtol=1e-6)
    # And the floor really was eligible (guard against silently-dead gate):
    assert os.environ.get("VROD_THETA0", "1") != "0"
