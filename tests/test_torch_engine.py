"""The port's DeviceEngine (CPU) against the JAX DeviceEngine.

State is carried across with ``convert.engine_state_from_numpy``, so both
engines search identical stored bytes. Slots must match; values agree to
rtol 1e-6 (the exact rescore sums float products in another order; l2's
finalize, |q|^2 - s, cancels, so l2 values also get atol 1e-5). The JAX
engine runs its fused Pallas kernels in interpret mode (impl="pallas") and
its plain scan (impl="scan"); the port runs the plain versions of its
kernels, for every dtype and metric.
"""

import dataclasses

import numpy as np
import pytest
import torch

from vrod_tpu.config import DTYPES, METRICS, CollectionConfig
from vrod_tpu.engine import DeviceEngine as JaxEngine
from vrod_tpu_torch import convert
from vrod_tpu_torch.config import CollectionConfig as PortConfig
from vrod_tpu_torch.errors import ConfigError
from vrod_tpu_torch.engine import DeviceEngine, FloorSettings, floor_gate
from vrod_tpu_torch.ops import cuda_topk
from vrod_tpu_torch.ops import distances as D

# The sampled floor's default settings (no VROD_THETA0* variables).
FS = FloorSettings()


def carried(jeng, cfg):
    pcfg = PortConfig(**dataclasses.asdict(cfg))
    eng = DeviceEngine(pcfg, device="cpu")
    eng.load_state(*convert.engine_state_from_numpy(
        pcfg, np.asarray(jeng.x), np.asarray(jeng.aux),
        np.asarray(jeng.valid), "cpu"))
    return eng


def assert_same_search(jeng, eng, q, k, impls=("pallas", "scan"), **kw):
    v, i = eng.search(q, k, **kw)
    atol = 1e-5 if eng.cfg.metric == "l2" else 0.0
    for impl in impls:
        jv, ji = jeng.search(q, k, impl=impl, **kw)
        np.testing.assert_array_equal(i, ji, err_msg=impl)
        np.testing.assert_allclose(v, jv, rtol=1e-6, atol=atol, err_msg=impl)
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
    """These legs, like every other, run the plain versions of K1/K3 on
    the CPU, and match the JAX engine's plain scan."""
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
    """With the gate open (131072 rows, k 100 -> k_scan 136, the H100
    policy's int8 margin of 36 past k_out 16: sample 32768 rows in
    8192-row blocks) the port runs K3 + the count threshold + K1 and still
    returns the JAX scan's exact results (whose k_scan is 112)."""
    assert floor_gate(131072, 136, 32, 1, True, FS) == (True, 32768, 8192)
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
    assert eng.scan_widths(100) == (100, 136)
    assert_same_search(jeng, eng, q, 100, impls=("scan",))
    assert calls == [(32768, 8192)]


def test_floor_gate_headline():
    # 1M x 768 int8, top-16 (k_scan 16 + 12): open, 32,768-row sample in
    # two 16,384-row blocks, 256 sub-maxima >= 2 * 28.
    assert floor_gate(1 << 20, 28, 768, 1, True, FS) == (True, 32768, 16384)
    assert floor_gate(1 << 20, 24, 768, 1, True, FS)[0] is True
    assert floor_gate(1 << 20, 23, 768, 1, True, FS)[0] is False
    # Wide rows shrink the pre-pass block to its tile budget.
    assert floor_gate(1 << 20, 28, 4096, 1, True, FS) == (True, 32768, 4096)


@pytest.mark.parametrize("rows,k_scan,dim,itemsize,quant,want", [
    # chip_smoke's 1M phases (capacity 1,048,576, batch 256):
    # (i) int8 l2 top-16, k_scan 28
    (1 << 20, 28, 768, 1, True, (True, 32768, 16384)),
    # (ii) int4 l2 top-16: 384 stored bytes per row
    (1 << 20, 28, 384, 1, True, (True, 32768, 16384)),
    # (iii) bfloat16 cosine top-100, k_scan 112 (the H100 margin 12):
    # 16384 x 768 x 2 B is exactly the 24 MiB budget, which it may fill
    # (> not >=)
    (1 << 20, 112, 768, 2, False, (True, 131072, 16384)),
    # (iv) float32 dot top-100: 16384 rows would be 48 MiB, so 8192
    (1 << 20, 108, 768, 4, False, (True, 131072, 8192)),
    # the same phases cut to 262,144 rows: every floor still opens
    (1 << 18, 28, 384, 1, True, (True, 8192, 8192)),
    (1 << 18, 112, 768, 2, False, (True, 32768, 16384)),
    (1 << 18, 108, 768, 4, False, (True, 32768, 8192)),
    # float rows open the floor from k_scan 64, int8/int4 from 24
    (1 << 20, 63, 768, 2, False, (False, 0, 8192)),
    (1 << 20, 64, 768, 4, False, (True, 131072, 8192)),
])
def test_floor_gate_at_the_smoke_phases(rows, k_scan, dim, itemsize, quant,
                                        want):
    assert floor_gate(rows, k_scan, dim, itemsize, quant, FS) == want


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


LEGS = [(d, m) for d in DTYPES for m in METRICS]


def assert_norms_track(jeng, eng):
    if not jeng.has_norms:
        assert eng.norms is None
        return
    np.testing.assert_array_equal(eng.norms.numpy(), np.asarray(jeng.norms))


@pytest.mark.parametrize("dtype,metric", LEGS,
                         ids=[f"{d}-{m}" for d, m in LEGS])
def test_engine_matches_jax_every_leg(rng, dtype, metric):
    """One mutation sequence on both engines (grow + write, erase, move,
    write_raw, shrink): the norms lane of int8/int4 + l2 is bit-equal to
    the JAX engine's after every step; then the JAX state, carried across,
    searches to the same results as the JAX engine's Pallas kernels and its
    scan, before and after the sequence's shrink."""
    cfg = CollectionConfig(name="l", dim=32, metric=metric, dtype=dtype,
                           segment_rows=128, shards=1)
    jeng, eng = JaxEngine(cfg), DeviceEngine(cfg, device="cpu")
    assert eng.has_norms == jeng.has_norms
    vecs = rng.standard_normal((300, 32)).astype(np.float32)
    q = rng.standard_normal((6, 32)).astype(np.float32)
    steps = [
        lambda e: (e.ensure_capacity(300), e.write(np.arange(300), vecs)),
        lambda e: e.erase(np.arange(1, 300, 4)),
        lambda e: e.move(np.array([299, 298]), np.array([1, 5])),
        lambda e: e.write_raw(np.array([10, 11]),
                              *e.gather_raw(np.array([20, 21]))),
    ]
    for step in steps:
        for e in (jeng, eng):
            step(e)
        assert_norms_track(jeng, eng)
    assert_same_search(jeng, carried(jeng, cfg), q, 8)
    for e in (jeng, eng):
        e.erase(np.arange(200, 384))
        assert e.shrink_capacity(200)
    assert eng.capacity == jeng.capacity == 256
    assert_norms_track(jeng, eng)
    eng = carried(jeng, cfg)
    assert_norms_track(jeng, eng)          # load_state rebuilt the lane
    assert_same_search(jeng, eng, q, 8)


@pytest.mark.parametrize("dtype", DTYPES)
def test_l2_empty_ranks_are_inf_and_minus_one(rng, dtype):
    """Fewer live rows than k under l2: the empty ranks come back as
    (+inf, -1) after finalize_scores, as in the JAX engine."""
    cfg = CollectionConfig(name="e", dim=16, metric="l2", dtype=dtype,
                           segment_rows=64, shards=1)
    jeng = JaxEngine(cfg)
    jeng.write(np.arange(3), rng.standard_normal((3, 16)).astype(np.float32))
    eng = carried(jeng, cfg)
    v, i = assert_same_search(jeng, eng, rng.standard_normal(
        (2, 16)).astype(np.float32), 5)
    assert (i[:, 3:] == -1).all() and np.isposinf(v[:, 3:]).all()
    assert (i[:, :3] >= 0).all() and np.isfinite(v[:, :3]).all()


def test_int8_top100_margin_miss_matches_jax(rng):
    """The known recall miss of the JAX policy, now found by the port:
    chip_smoke's every-leg phase once searched int8 cosine at top-100 on
    131,072 x 768 rows from seed 15, and query 119 of its first batch got
    100th score 0.11310559 where the exact scan's is 0.11320097. Row
    121939 ranks past k_scan 112 (k 100 + the JAX int8 margin 12) by its
    quantized score, so the JAX engine's rescore never sees it.

    The port's margin was measured on the H100 (tools/recall_margin.py):
    this case needed 16, and top-100 on 1,048,576 x 768 rows needed 24
    for int8 over every metric and batch, so the port scans 136 (1.5 x
    24) past k_out 16 (``engine.WIDE_K_MARGIN``). The two packages now
    differ here, by design: the JAX engine still misses the row with the
    same 100th score, and the port finds it with the exact scan's.

    The same rows and query go through both engines, cut to the rows that
    decide the result: the union of each 65,536-row chunk's 300 best by
    quantized score and by exact score (quantization is per row, so the
    cut changes no stored byte and no rank among them)."""
    del rng  # the data is the smoke phase's own seed
    src = np.random.default_rng(15)
    qb = [src.standard_normal((256, 768), dtype=np.float32)
          for _ in range(3)][0]
    q = torch.from_numpy(qb[119:120])
    qk = D.prepare_queries(q, metric="cosine", quantize=True).float()
    qp = D.prepare_queries(q, metric="cosine")
    keep, rows = [], []
    for c in range(2):
        x = src.standard_normal((65536, 768), dtype=np.float32)
        quant, exact = [], []
        for lo in range(0, 65536, 8192):
            xr, aux = D.prepare_rows(torch.from_numpy(x[lo:lo + 8192]),
                                     metric="cosine", dtype=torch.int8)
            quant.append((qk @ xr.float().T)[0] * aux)
            exact.append((qp @ (xr.float() * aux[:, None]).T)[0])
        sel = torch.cat([torch.cat(quant).topk(300).indices,
                         torch.cat(exact).topk(300).indices])
        sel = sel.unique().numpy()
        keep.append(sel + 65536 * c)
        rows.append(x[sel])
    keep, rows = np.concatenate(keep), np.concatenate(rows)
    cfg = CollectionConfig(name="miss", dim=768, metric="cosine",
                           dtype="int8", segment_rows=2048, shards=1)
    jeng, eng = JaxEngine(cfg), DeviceEngine(cfg, device="cpu")
    for e in (jeng, eng):
        e.write(np.arange(len(keep)), rows)
    assert eng.scan_widths(100) == (100, 136)
    ev, ei = D.blockwise_topk(eng.x, eng.aux, eng.valid, qp, k=100,
                              metric="cosine", precision="exact",
                              block_rows=2048, nblocks=1, packed=False)
    ev = D.finalize_scores(ev, q, metric="cosine")
    assert float(ev[0, 99]) == pytest.approx(0.11320097, abs=1e-7)
    exact = keep[ei[0].numpy()]
    assert 121939 in set(exact)
    v, i = jeng.search(qb[119], 100, impl="scan")
    assert float(v[0, 99]) == pytest.approx(0.11310559, abs=1e-7)
    assert sorted(set(exact) - set(keep[i[0]])) == [121939]
    v, i = eng.search(qb[119], 100)
    assert float(v[0, 99]) == pytest.approx(0.11320097, abs=1e-7)
    assert set(keep[i[0]]) == set(exact)


@pytest.mark.parametrize("dtype,metric", [("float32", "dot"),
                                          ("bfloat16", "l2")])
def test_float_floor_open_path_matches_jax_scan(rng, monkeypatch, dtype,
                                                metric):
    """Float rows at 131072 x 32, k 100 (k_scan 108 for float32; 112 for
    bfloat16, whose H100 margin past k_out 16 is 12): the gate opens
    (float rows from k_scan 64), K3 runs on a 24,576-row sample, the
    threshold subtracts the accumulation margin, and the results are the
    JAX scan's (whose k_scan is 108 for both)."""
    itemsize = 4 if dtype == "float32" else 2
    k_scan = 108 if dtype == "float32" else 112
    assert floor_gate(131072, k_scan, 32, itemsize, False, FS) == \
        (True, 24576, 8192)
    cfg = CollectionConfig(name="f", dim=32, metric=metric, dtype=dtype,
                           segment_rows=131072, shards=1)
    jeng = JaxEngine(cfg)
    jeng.write(np.arange(131072),
               rng.standard_normal((131072, 32)).astype(np.float32))
    jeng.erase(np.arange(0, 131072, 11))
    eng = carried(jeng, cfg)
    calls, margins = [], []
    orig_sub, orig_margin = cuda_topk.sampled_submax, \
        D.accumulation_margin

    def spy_sub(x, *a, **kw):
        calls.append((x.shape[0], kw["block_rows"]))
        return orig_sub(x, *a, **kw)

    def spy_margin(*a, **kw):
        margins.append(orig_margin(*a, **kw))
        return margins[-1]

    monkeypatch.setattr(cuda_topk, "sampled_submax", spy_sub)
    monkeypatch.setattr(D, "accumulation_margin", spy_margin)
    q = rng.standard_normal((8, 32)).astype(np.float32)
    assert eng.scan_widths(100) == (100, k_scan)
    assert_same_search(jeng, eng, q, 100, impls=("scan",))
    assert calls == [(24576, 8192)]
    assert len(margins) == 1 and (margins[0] > 0).all()
