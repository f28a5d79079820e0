"""The port's DeviceEngine (CPU) against the JAX DeviceEngine.

State is carried across with ``convert.engine_state_from_numpy``, so both
engines search identical stored bytes. Slots must match; values agree to
rtol 1e-6 (the exact rescore sums float products in another order).
The JAX engine runs its fused Pallas kernels in interpret mode
(impl="pallas") and its plain scan (impl="scan").
"""

import numpy as np
import pytest
import torch

from vrod_tpu.config import CollectionConfig, ConfigError
from vrod_tpu.engine import DeviceEngine as JaxEngine
from vrod_tpu_torch import convert
from vrod_tpu_torch.engine import DeviceEngine, floor_gate
from vrod_tpu_torch.ops import cuda_topk


def carried(jeng, cfg):
    eng = DeviceEngine(cfg, device="cpu")
    eng.load_state(*convert.engine_state_from_numpy(
        cfg, np.asarray(jeng.x), np.asarray(jeng.aux),
        np.asarray(jeng.valid), "cpu"))
    return eng


def assert_same_search(jeng, eng, q, k, impls=("pallas", "scan"), **kw):
    v, i = eng.search(q, k, **kw)
    for impl in impls:
        jv, ji = jeng.search(q, k, impl=impl, **kw)
        np.testing.assert_array_equal(i, ji, err_msg=impl)
        np.testing.assert_allclose(v, jv, rtol=1e-6, err_msg=impl)
    return v, i


@pytest.mark.parametrize("metric", ["cosine", "dot"])
def test_engine_matches_jax_after_mutations(rng, metric):
    cfg = CollectionConfig(name="e", dim=32, metric=metric, dtype="int8",
                           segment_rows=256, shards=1)
    jeng = JaxEngine(cfg)
    vecs = rng.standard_normal((700, 32)).astype(np.float32)
    jeng.ensure_capacity(700)                        # grow: 256 -> 768
    jeng.write(np.arange(700), vecs)
    jeng.erase(np.arange(0, 700, 9))
    jeng.move(np.array([690, 695]), np.array([0, 9]))  # compaction moves
    q = rng.standard_normal((5, 32)).astype(np.float32)
    eng = carried(jeng, cfg)
    assert eng.capacity == jeng.capacity == 768
    assert_same_search(jeng, eng, q, 10)
    # Shrink after erasing the tail, then search again.
    jeng.erase(np.arange(500, 768))
    assert jeng.shrink_capacity(500)
    eng = carried(jeng, cfg)
    assert eng.capacity == 512
    assert_same_search(jeng, eng, q, 10)
    # Filtered search uses the same masks on both sides.
    allow = np.arange(0, 500, 3)
    assert_same_search(jeng, eng, q, 7, impls=("scan",),
                       filter_mask=None)
    v, i = eng.search(q, 7, filter_mask=eng.filter_mask_from_slots(allow))
    jv, ji = jeng.search(q, 7, impl="scan",
                         filter_mask=jeng.filter_mask_from_slots(allow))
    np.testing.assert_array_equal(i, ji)
    assert np.isin(i[i >= 0], allow).all()


def test_port_mutations_track_jax(rng):
    """The same write/erase/move/grow/shrink sequence on both engines gives
    the same state: stored bytes within 1 (quantizer ulps), aux within
    rtol 1e-6, identical valid bitmaps, then the same search results."""
    cfg = CollectionConfig(name="m", dim=24, metric="cosine", dtype="int8",
                           segment_rows=128, shards=1)
    jeng, eng = JaxEngine(cfg), DeviceEngine(cfg, device="cpu")
    vecs = rng.standard_normal((300, 24)).astype(np.float32)
    for e in (jeng, eng):
        assert e.ensure_capacity(300)
        e.write(np.arange(300), vecs)
        e.write(np.array([5, 10_000]), vecs[:2])   # slot past capacity drops
        e.erase(np.arange(1, 300, 4))
        e.move(np.array([299, 298]), np.array([1, 5]))
        e.erase(np.arange(200, 384))
        assert e.shrink_capacity(200)
    assert eng.capacity == jeng.capacity == 256
    diff = np.abs(eng.x.numpy().astype(int) - np.asarray(jeng.x).astype(int))
    assert diff.max() <= 1
    np.testing.assert_allclose(eng.aux.numpy(), np.asarray(jeng.aux),
                               rtol=1e-6)
    np.testing.assert_array_equal(eng.valid.numpy(), np.asarray(jeng.valid))
    rows, aux = eng.gather_raw(np.array([0, 1, 5]))
    jrows, jaux = jeng.gather_raw(np.array([0, 1, 5]))
    assert np.abs(rows.astype(int) - jrows.astype(int)).max() <= 1
    np.testing.assert_allclose(eng.gather(np.array([0, 1, 5])),
                               jeng.gather(np.array([0, 1, 5])), rtol=1e-2,
                               atol=1e-2)
    t_rows, t_aux = eng.gather_raw(np.array([0, 1]), sync=False)
    assert isinstance(t_rows, torch.Tensor)
    t_rows.zero_()                                 # a copy, not a view
    assert eng.x[0].abs().sum() > 0
    # Carry the JAX bytes across and search.
    q = rng.standard_normal((3, 24)).astype(np.float32)
    assert_same_search(jeng, carried(jeng, cfg), q, 8)


@pytest.mark.parametrize("dtype,metric", [("float32", "l2"),
                                          ("bfloat16", "cosine"),
                                          ("int4", "dot")])
def test_cpu_scan_legs_match_jax_scan(rng, dtype, metric):
    """Legs without a CUDA kernel run the plain scan on the CPU."""
    cfg = CollectionConfig(name="s", dim=16, metric=metric, dtype=dtype,
                           segment_rows=128, shards=1)
    jeng = JaxEngine(cfg)
    jeng.write(np.arange(128),
               rng.standard_normal((128, 16)).astype(np.float32))
    jeng.erase(np.arange(0, 128, 5))
    q = rng.standard_normal((4, 16)).astype(np.float32)
    v, i = carried(jeng, cfg).search(q, 5)
    jv, ji = jeng.search(q, 5, impl="scan")
    np.testing.assert_array_equal(i, ji)
    np.testing.assert_allclose(v, jv, rtol=1e-5, atol=1e-5)


def test_floor_gate_open_path_matches_jax_scan(rng, monkeypatch):
    """With the gate open (131072 rows, k 100 -> k_scan 112: sample 24576
    rows in 8192-row blocks) the port runs K3 + the count threshold + K1
    and still returns the JAX scan's exact results."""
    assert floor_gate(131072, 112, 32) == (True, 24576, 8192)
    cfg = CollectionConfig(name="g", dim=32, metric="cosine", dtype="int8",
                           segment_rows=131072, shards=1)
    jeng = JaxEngine(cfg)
    jeng.write(np.arange(131072),
               rng.standard_normal((131072, 32)).astype(np.float32))
    jeng.erase(np.arange(0, 131072, 13))
    eng = carried(jeng, cfg)
    calls = []
    orig = cuda_topk.sampled_submax

    def spy(x, *a, **kw):
        calls.append((x.shape[0], kw["block_rows"]))
        return orig(x, *a, **kw)

    monkeypatch.setattr(cuda_topk, "sampled_submax", spy)
    q = rng.standard_normal((8, 32)).astype(np.float32)
    assert_same_search(jeng, eng, q, 100, impls=("scan",))
    assert calls == [(24576, 8192)]


def test_floor_gate_headline():
    # 1M x 768 int8, top-16 (k_scan 16 + 12): open, 32,768-row sample in
    # two 16,384-row blocks, 256 sub-maxima >= 2 * 28.
    assert floor_gate(1 << 20, 28, 768) == (True, 32768, 16384)
    assert floor_gate(1 << 20, 24, 768)[0] is True
    assert floor_gate(1 << 20, 23, 768)[0] is False
    # Wide rows shrink the pre-pass block to its tile budget.
    assert floor_gate(1 << 20, 28, 4096) == (True, 32768, 4096)


def test_cuda_request_raises_without_a_gpu(monkeypatch):
    cfg = CollectionConfig(name="c", dim=8, dtype="int8")
    with pytest.raises(RuntimeError, match="VROD_PLATFORM=cpu"):
        DeviceEngine(cfg, device="cuda")
    monkeypatch.setenv("VROD_PLATFORM", "gpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceEngine(cfg)
    monkeypatch.setenv("VROD_PLATFORM", "tpu")
    with pytest.raises(ConfigError):
        DeviceEngine(cfg)
    monkeypatch.setenv("VROD_PLATFORM", "cpu")
    assert DeviceEngine(cfg).device.type == "cpu"


def test_search_validates_and_pads(rng):
    cfg = CollectionConfig(name="p", dim=8, dtype="int8", segment_rows=64)
    eng = DeviceEngine(cfg, device="cpu")
    eng.write(np.arange(3), rng.standard_normal((3, 8)).astype(np.float32))
    v, i = eng.search(rng.standard_normal(8).astype(np.float32), 5)
    assert v.shape == i.shape == (1, 5)
    assert sorted(i[0, :3].tolist()) == [0, 1, 2] and (i[0, 3:] == -1).all()
    with pytest.raises(ValueError, match="dim"):
        eng.search(np.zeros((2, 9), np.float32), 3)
    with pytest.raises(ValueError, match="k must be"):
        eng.search(np.zeros((2, 8), np.float32), 0)
