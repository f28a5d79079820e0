"""The port's search options, floor variables, exports and quantizer against
the JAX package, on the CPU.

- ``DeviceEngine.search`` takes the JAX engine's options (``precision``,
  ``impl``, ``rescore``, ``as_numpy``, ``margin``, ``filter_mask``) and a
  torch tensor as the query; on the same stored rows (carried across with
  ``convert.engine_state_from_numpy``) each returns the JAX engine's slots,
  for int8 and bf16, cosine and l2, k 16 and 100. Values agree to rtol 1e-6
  and atol 2e-6 (cosine scores are at most 1 in size, and a sum of 32
  products in another order moves by at most 32 * 2^-24), atol 1e-5 for
  l2, whose finalize |q|^2 - s cancels: float products are summed in
  another order, and the Pallas kernels fuse the int8 l2 epilogue into one
  FMA where the port rounds twice.
- The ``VROD_THETA0*`` variables act as in the JAX engine: the same gate
  (sample rows, block), the same margin, the same methods, the kill switch
  and the typo check.
- ``vrod_tpu_torch`` resolves every name of ``vrod_tpu.__all__``.
- Quantization: the int8/int4 scale (``aux``) and the l2 query scale are
  the JAX package's bits on seeded random rows, and the stored bytes too,
  for dot and l2 everywhere and for cosine wherever the two packages' norms
  of a row agree. The cosine norm's last ulp flips a stored byte at a
  rounding edge; the rate is measured at 65,536 x 768 and stated as a bound.
"""

import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vrod_tpu
import vrod_tpu.engine as jax_engine
import vrod_tpu_torch
from vrod_tpu.config import CollectionConfig
from vrod_tpu.engine import DeviceEngine as JaxEngine
from vrod_tpu.ops import distances as JD
from vrod_tpu.ops import pallas_topk
from vrod_tpu_torch import convert
from vrod_tpu_torch.config import CollectionConfig as PortConfig
from vrod_tpu_torch.engine import DeviceEngine, FloorSettings, floor_gate
from vrod_tpu_torch.ops import cuda_topk
from vrod_tpu_torch.ops import distances as D
from test_torch_distances import norms_agree


def engines(rng, n, dim, dtype, metric, segment_rows=None):
    """A JAX engine holding ``n`` random rows (every 9th erased) and the
    port's engine holding the same stored bytes."""
    cfg = CollectionConfig(name="o", dim=dim, metric=metric, dtype=dtype,
                           segment_rows=segment_rows or n, shards=1)
    jeng = JaxEngine(cfg)
    jeng.ensure_capacity(n)
    jeng.write(np.arange(n), rng.standard_normal((n, dim)).astype(np.float32))
    jeng.erase(np.arange(0, n, 9))
    assert jeng.capacity == n
    pcfg = PortConfig(**dataclasses.asdict(cfg))
    eng = DeviceEngine(pcfg, device="cpu")
    eng.load_state(*convert.engine_state_from_numpy(
        pcfg, np.asarray(jeng.x), np.asarray(jeng.aux),
        np.asarray(jeng.valid), "cpu"))
    return jeng, eng


def assert_same(got, want, metric, err=""):
    v, i = (convert.to_numpy(a) if isinstance(a, torch.Tensor) else a
            for a in got)
    jv, ji = (np.asarray(a) for a in want)
    np.testing.assert_array_equal(i, ji, err_msg=err)
    np.testing.assert_allclose(v, jv, rtol=1e-6,
                               atol=1e-5 if metric == "l2" else 2e-6,
                               err_msg=err)


LEGS = [(d, m, k) for d in ("int8", "bfloat16") for m in ("cosine", "l2")
        for k in (16, 100)]


@pytest.mark.parametrize("dtype,metric,k", LEGS,
                         ids=[f"{d}-{m}-k{k}" for d, m, k in LEGS])
def test_search_options_match_jax(rng, dtype, metric, k):
    """Every option of ``search`` against the JAX engine on the same rows:
    the kernels ("pallas") and the plain scan at each precision, with and
    without the rescore, an explicit margin, a filter, and the query as a
    torch tensor with device tensors out."""
    jeng, eng = engines(rng, 2048, 32, dtype, metric, segment_rows=512)
    q = rng.standard_normal((6, 32)).astype(np.float32)
    for impl in ("pallas", "scan"):
        for precision in ("fast", "high", "exact"):
            for rescore in (True, False):
                kw = dict(impl=impl, precision=precision, rescore=rescore)
                assert_same(eng.search(q, k, **kw), jeng.search(q, k, **kw),
                            metric, err=str(kw))
    # As in JAX, a name other than "pallas" takes the scan.
    assert_same(eng.search(q, k, impl="no-such-impl"),
                jeng.search(q, k, impl="scan"), metric)
    for margin in (0, 5, 32):
        for impl in ("pallas", "scan"):
            kw = dict(impl=impl, margin=margin)
            assert_same(eng.search(q, k, **kw), jeng.search(q, k, **kw),
                        metric, err=str(kw))
    # The defaults are the kernels at "fast" with the rescore.
    assert_same(eng.search(q, k), jeng.search(q, k, impl="pallas",
                                              precision="fast"), metric)
    slots = np.arange(1, 2048, 3)
    fm, jfm = (e.filter_mask_from_slots(slots, mode="within")
               for e in (eng, jeng))
    assert_same(eng.search(q, k, filter_mask=fm),
                jeng.search(q, k, filter_mask=jfm, impl="pallas"), metric)
    want = eng.search(q, k)
    for query in (torch.from_numpy(q), torch.from_numpy(q[0])):
        v, i = eng.search(query, k, as_numpy=False)
        assert isinstance(v, torch.Tensor) and isinstance(i, torch.Tensor)
        assert v.device == i.device == eng.device
        assert i.dtype == torch.int32 and v.dtype == torch.float32
        rows = len(query) if query.ndim == 2 else 1
        np.testing.assert_array_equal(i.numpy(), want[1][:rows])
        np.testing.assert_array_equal(v.numpy(), want[0][:rows])


def test_search_widths_follow_margin_and_rescore(rng):
    """(k_out, k_scan): the JAX policy by default (int8: at least 12, k/4
    past 100), raised past k_out 16 to the margin measured on the H100
    (int8: 36, ``engine.WIDE_K_MARGIN``; the JAX engine scans 112 at top
    100), ``margin`` overrides it, and no rescore means no margin."""
    _, eng = engines(rng, 2048, 32, "int8", "cosine")
    assert eng.scan_widths(16) == (16, 28)
    assert eng.scan_widths(100) == (100, 136)
    assert eng.scan_widths(200) == (256, 320)
    assert eng.scan_widths(16, margin=32) == (16, 48)
    assert eng.scan_widths(16, margin=32, rescore=False) == (16, 16)
    assert eng.scan_widths(16, rescore=False) == (16, 16)
    with pytest.raises(ValueError, match="precision"):
        eng.search(np.zeros((1, 32), np.float32), 4, precision="highest")


def test_float_rows_at_high_precision_take_the_three_product_kernels(
        rng, monkeypatch):
    """The default impl runs the kernels at every precision. float32 rows
    go to K1 (and K3) at "fast" in TF32 and at "high"/"exact" in three
    TF32 products (the f32x3 leg, the Pallas kernels' HIGHEST); int8 and
    bfloat16 rows score alike at each precision, as in JAX. Every result
    is the JAX engine's at the same precision."""
    calls = []
    orig = cuda_topk.fused_topk

    def spy(x, *a, **kw):
        calls.append(cuda_topk.leg_name(x, kw["metric"], kw["packed"],
                                        kw.get("precision", "fast")))
        return orig(x, *a, **kw)

    monkeypatch.setattr(cuda_topk, "fused_topk", spy)
    q = rng.standard_normal((4, 32)).astype(np.float32)
    for dtype, precision, leg in (("float32", "fast", "f32-dot"),
                                  ("float32", "high", "f32x3-dot"),
                                  ("float32", "exact", "f32x3-dot"),
                                  ("bfloat16", "exact", "bf16-dot"),
                                  ("int8", "exact", "int8-dot")):
        calls.clear()
        jeng, eng = engines(rng, 1024, 32, dtype, "dot")
        # Without the rescore the scan's own scores come out: TF32 ones
        # at "fast" are not the CPU JAX kernel's float32 ones, so that
        # case runs with the rescore only.
        rescores = (True,) if leg == "f32-dot" else (True, False)
        for rescore in rescores:
            kw = dict(precision=precision, rescore=rescore)
            assert_same(eng.search(q, 8, **kw),
                        jeng.search(q, 8, impl="pallas", **kw), "dot",
                        err=f"{dtype} {kw}")
        assert calls == [leg] * len(rescores), (dtype, precision)


# -- the floor's variables ------------------------------------------------

# int8 rows at 32,768 x 32 with the pre-pass block forced to 256 rows: at
# k 16 (k_scan 28) the sample is 7,168 rows and the gate opens.
FLOOR_ROWS, FLOOR_DIM = 32768, 32


@pytest.fixture
def floor_engines(rng):
    return engines(rng, FLOOR_ROWS, FLOOR_DIM, "int8", "cosine",
                   segment_rows=8192)


def spy_floor(monkeypatch):
    """Record (sample rows, block rows) of every K3 call and the margin of
    every threshold, in both packages. The JAX engine's programs are
    traced anew (its spies see calls at trace time only)."""
    seen = {"port": [], "jax": [], "port_margin": [], "jax_margin": []}
    p_sub, j_sub = cuda_topk.sampled_submax, pallas_topk.sampled_submax
    p_thr, j_thr = D.threshold_from_submax, JD.threshold_from_submax

    def port_sub(x, *a, **kw):
        seen["port"].append((x.shape[0], kw["block_rows"]))
        return p_sub(x, *a, **kw)

    def jax_sub(x, *a, **kw):
        seen["jax"].append((x.shape[0], kw["block_rows"]))
        return j_sub(x, *a, **kw)

    def port_thr(sub, k, **kw):
        seen["port_margin"].append((kw["margin_abs"], kw["method"]))
        return p_thr(sub, k, **kw)

    def jax_thr(sub, k, **kw):
        seen["jax_margin"].append(kw["margin_abs"])
        return j_thr(sub, k, **kw)

    monkeypatch.setattr(cuda_topk, "sampled_submax", port_sub)
    monkeypatch.setattr(pallas_topk, "sampled_submax", jax_sub)
    monkeypatch.setattr(D, "threshold_from_submax", port_thr)
    monkeypatch.setattr(JD, "threshold_from_submax", jax_thr)
    jax_engine._search_fn.cache_clear()
    return seen


ENV_CASES = [
    ({}, True),
    ({"VROD_THETA0": "0"}, False),
    ({"VROD_THETA0_MARGIN": "0.02"}, True),
    ({"VROD_THETA0_FRAC": "2"}, True),
    ({"VROD_THETA0_BLK": "512"}, True),
    ({"VROD_THETA0_MINK": "29"}, False),
    ({"VROD_THETA0_METHOD": "approx"}, True),
    ({"VROD_THETA0_METHOD": "minmax"}, True),
    ({"VROD_THETA0_METHOD": "topk"}, True),
]


@pytest.mark.parametrize("env,opens", ENV_CASES,
                         ids=[",".join(f"{k}={v}" for k, v in e.items())
                              or "defaults" for e, _ in ENV_CASES])
def test_floor_variables_match_jax(floor_engines, monkeypatch, env, opens):
    """Each variable moves the port's floor as it moves the JAX engine's:
    the same K3 sample and block (or none), the same threshold margin, and
    the same exact result. The port runs the named method; "approx" runs
    the exact k-th sub-max, as ``lax.approx_max_k`` does off the TPU."""
    jeng, eng = floor_engines
    monkeypatch.setenv("VROD_THETA0_BLK", "256")
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    seen = spy_floor(monkeypatch)
    q = np.random.default_rng(3).standard_normal((8, FLOOR_DIM)) \
        .astype(np.float32)
    assert_same(eng.search(q, 16), jeng.search(q, 16, impl="pallas"),
                "cosine")
    assert seen["port"] == seen["jax"]
    assert bool(seen["port"]) is opens
    if opens:
        assert [m for m, _ in seen["port_margin"]] == seen["jax_margin"]
        method = env.get("VROD_THETA0_METHOD", "count")
        assert seen["port_margin"][0][1] == \
            ("topk" if method == "approx" else method)
    assert_same(eng.search(q, 16), jeng.search(q, 16, impl="scan"),
                "cosine")


def test_floor_gate_reads_the_environment(monkeypatch):
    """``floor_gate`` takes its knobs from ``FloorSettings.from_env()``, the
    one reading of the environment that a search makes."""
    def gate():
        return floor_gate(1 << 20, 28, 768, 1, True,
                          FloorSettings.from_env())

    assert gate() == (True, 32768, 16384)
    monkeypatch.setenv("VROD_THETA0", "0")
    assert gate()[0] is False
    assert floor_gate(1 << 20, 28, 768, 1, True, FloorSettings()) == \
        (True, 32768, 16384)
    monkeypatch.setenv("VROD_THETA0", "1")
    monkeypatch.setenv("VROD_THETA0_BLK", "4096")
    assert gate() == (True, 32768, 4096)
    monkeypatch.setenv("VROD_THETA0_MINK", "64")
    assert gate()[0] is False


@pytest.mark.parametrize("bad", ["Count", "exact", ""])
def test_bad_floor_method_raises_as_in_jax(floor_engines, monkeypatch, bad):
    jeng, eng = floor_engines
    monkeypatch.setenv("VROD_THETA0_METHOD", bad)
    q = np.zeros((1, FLOOR_DIM), np.float32)
    msgs = []
    for e in (eng, jeng):
        with pytest.raises(ValueError, match="VROD_THETA0_METHOD") as exc:
            e.search(q, 16)
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1]


def test_minmax_threshold_matches_jax(rng):
    sub = rng.standard_normal((8, 1000)).astype(np.float32)
    sub[0, :3] = -np.inf
    for k in (1, 17, 200):
        np.testing.assert_array_equal(
            D.threshold_from_submax(torch.from_numpy(sub), k,
                                    method="minmax").numpy(),
            np.asarray(JD.threshold_from_submax(jnp.asarray(sub), k,
                                                method="minmax")))


# -- the collection ---------------------------------------------------------


def test_collection_passes_every_option(rng, tmp_path):
    """``search_similar``, ``search_triples`` and ``search_packed`` pass the
    options through (``docs/usage.md``'s ``margin=32`` among them), take a
    torch tensor, and give the JAX collection's ids on the same stored
    rows (a JAX-written snapshot loaded in the port)."""
    vecs = rng.standard_normal((900, 32)).astype(np.float32)
    q = rng.standard_normal((5, 32)).astype(np.float32)
    db = vrod_tpu.Database.new(tmp_path, "db")
    col = db.create_collection("c", dim=32, metric="cosine", dtype="int8",
                               segment_rows=256)
    ids = col.bulk_insert(vecs, [f"p{i}" for i in range(900)])
    col.snapshot()
    db.close()
    shutil.copytree(tmp_path / "db", tmp_path / "copy" / "db")
    jdb = vrod_tpu.Database.load(tmp_path / "db")
    pdb = vrod_tpu_torch.Database.load(tmp_path / "copy" / "db",
                                       device="cpu")
    jcol, pcol = jdb.collection("c"), pdb.collection("c")
    try:
        for kw in ({"margin": 32}, {"rescore": False, "impl": "pallas"},
                   {"impl": "scan", "precision": "exact"},
                   {"as_numpy": False}, {"within_ids": ids[::2],
                                         "margin": 0}):
            want = [[h.record_id for h in hs]
                    for hs in jcol.search_similar(q, 10, **kw)]
            got = [[h.record_id for h in hs]
                   for hs in pcol.search_similar(q, 10, **kw)]
            assert got == want, kw
            assert [[t[0] for t in ts]
                    for ts in pcol.search_triples(q, 10, **kw)] == want
            pids, _, counts, _ = pcol.search_packed(q, 10, **kw)
            assert pids.tolist() == sum(want, [])
            assert counts.tolist() == [len(w) for w in want]
        tq = [h.record_id for h in pcol.search_similar(
            torch.from_numpy(q[0]), 10, margin=32)]
        assert tq == [h.record_id for h in pcol.search_similar(q[0], 10)]
    finally:
        jdb.close()
        pdb.close()


# -- exports ----------------------------------------------------------------


@pytest.mark.parametrize("name", vrod_tpu.__all__)
def test_every_jax_export_resolves_in_the_port(name):
    got = getattr(vrod_tpu_torch, name)
    assert got is not None
    assert name in dir(vrod_tpu_torch)
    if name in ("metrics", "errors"):
        assert got.__name__ == f"vrod_tpu_torch.{name}"
    elif not name.startswith("__") and name != "VROD_VERSION":
        assert got.__module__.startswith("vrod_tpu_torch.")


# -- quantization -----------------------------------------------------------


def unpacked(x, packed):
    """Stored int8 bytes, or packed int4 rows unpacked, as int32."""
    x = torch.from_numpy(np.asarray(x))
    return (D.unpack_int4_rows(x, torch.int32) if packed
            else x.to(torch.int32)).numpy()


QUANT = [(d, m) for d in ("int8", "int4") for m in ("cosine", "dot", "l2")]


@pytest.mark.parametrize("dtype,metric", QUANT,
                         ids=[f"{d}-{m}" for d, m in QUANT])
def test_engine_write_aux_and_bytes_are_jax_bits(rng, dtype, metric):
    """``DeviceEngine.write`` of seeded random rows: the scale lane is the
    JAX engine's bits, and so are the stored bytes, on every row for dot
    and l2 and on every row whose norm agrees for cosine."""
    n, dim = 4096, 256
    x = (rng.standard_normal((n, dim)) * 3).astype(np.float32)
    cfg = CollectionConfig(name="q", dim=dim, metric=metric, dtype=dtype,
                           segment_rows=n, shards=1)
    jeng = JaxEngine(cfg)
    eng = DeviceEngine(PortConfig(**dataclasses.asdict(cfg)), device="cpu")
    for e in (jeng, eng):
        e.write(np.arange(n), x)
    agree = norms_agree(x) if metric == "cosine" else np.ones(n, bool)
    assert agree.mean() > 0.25
    ja, pa = np.asarray(jeng.aux), eng.aux.numpy()
    np.testing.assert_array_equal(pa[agree], ja[agree])
    jx, px = (unpacked(a, dtype == "int4") for a in (jeng.x, eng.x.numpy()))
    np.testing.assert_array_equal(px[agree], jx[agree])
    if jeng.has_norms:
        np.testing.assert_array_equal(eng.norms.numpy(),
                                      np.asarray(jeng.norms))


@pytest.mark.parametrize("metric", ["cosine", "dot", "l2"])
def test_query_scale_is_jax_bits(rng, metric):
    """The int8 query and its scale (l2 carries the scale into K1) are the
    bits of the JAX engine's program, which quantizes inside jit."""
    q = rng.standard_normal((512, 768)).astype(np.float32)
    jq, js = jax.jit(lambda v: JD.prepare_queries(
        v, metric=metric, quantize=True, return_scale=True))(q)
    tq, ts = D.prepare_queries(torch.from_numpy(q), metric=metric,
                               quantize=True, return_scale=True)
    agree = norms_agree(q) if metric == "cosine" else np.ones(512, bool)
    np.testing.assert_array_equal(ts.numpy()[agree], np.asarray(js)[agree])
    np.testing.assert_array_equal(tq.numpy()[agree], np.asarray(jq)[agree])


# Stored int8/int4 elements that differ between the two packages' engines
# for 65,536 x 768 cosine rows from seed 0, measured on the CPU: every one
# in a row whose norm's last ulp differs, never by more than 1. The rate is
# the bound: int8 27 of 50,331,648 elements (5.4e-7), int4 none. In those
# rows the scale differs too, by at most 3.49e-7 relative (measured; the
# bound is 2^-21, 4.77e-7).
FLIP_BOUND = {"int8": 27, "int4": 0}


@pytest.mark.parametrize("dtype", ["int8", "int4"])
def test_cosine_norm_flip_rate(dtype):
    n, dim = 65536, 768
    x = np.random.default_rng(0).standard_normal((n, dim), dtype=np.float32)
    cfg = CollectionConfig(name="f", dim=dim, metric="cosine", dtype=dtype,
                           segment_rows=n, shards=1)
    jeng = JaxEngine(cfg)
    eng = DeviceEngine(PortConfig(**dataclasses.asdict(cfg)), device="cpu")
    for e in (jeng, eng):
        e.write(np.arange(n), x)
    jx, px = (unpacked(a, dtype == "int4") for a in (jeng.x, eng.x.numpy()))
    diff = np.abs(jx - px)
    flips = int((diff != 0).sum())
    assert flips <= FLIP_BOUND[dtype], flips / diff.size
    assert diff.max() <= 1
    agree = norms_agree(x)
    assert not diff[agree].any()
    ja, pa = np.asarray(jeng.aux), eng.aux.numpy()
    np.testing.assert_array_equal(pa[agree], ja[agree])
    np.testing.assert_allclose(pa, ja, rtol=2.0 ** -21, atol=0)
