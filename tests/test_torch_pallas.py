"""The port's search kernels and their floor, held to the JAX package's own
kernel suite: ``tests/test_pallas.py`` (20 functions, 33 tests) over
``vrod_tpu_torch``, the same cases, parameters and seeded inputs.

On the CPU the port's kernel wrappers (``cuda_topk.fused_topk`` and
``sampled_submax``) run their plain versions (the CUDA kernels are held
against those on the card: ``test_torch_cuda.py``, ``chip_smoke.py``).
Each case feeds the same numpy inputs to the JAX function (the Pallas
kernel in interpret mode, or its reference scan, as ``test_pallas.py``
runs it) and to the port, and holds the port to the JAX case's own oracle
and to the JAX result.

None of the 20 functions had a counterpart of the same case in another
``test_torch_*`` file: ``test_torch_distances.py`` has a
``test_kth_largest_count_exact`` with other shapes (no 1024 x 100 case),
so this file ports every function.

Tolerances (those of ``test_torch_kernels_plain.py``):
- float32 rows at precision "exact" (the JAX tests' HIGHEST) run the
  port's f32x3 leg (three TF32 products), float32 at "fast" its TF32 leg;
  either agrees with a float32 scan or with the Pallas kernel within
  ``cuda_topk.score_error_bound``, slots equal outside near-ties
  (``cuda_topk.topk_disagreement``). The Pallas kernel scores float32 on
  the CPU in full float32, so where it is held to the port's TF32 leg it
  gets the TF32-rounded inputs, as in that file.
- int8 rows score exact integer dots: equal.
- Results with no near-ties (all-dead, k past the live rows, duplicated
  rows, the last row as query) and the warm-start checks (the same
  scorer with and without the floor) are compared for equality.
- Sampled floors from the two packages sum float32 products in another
  order: rtol 1e-5 and atol 1e-5 (``test_torch_distances.py``).

Rewrites, each because the JAX case calls a JAX-only API:
- ``test_matches_scan``'s ``pipeline`` ("manual"/"auto") picks the Pallas
  kernel (``_kernel_db``/``_kernel``) on the JAX side; the port has one
  kernel for both, so its side is the same for either value.
- ``test_pick_block_rows``: the port has no Pallas VMEM tiles. Its
  counterparts are held at the JAX case's (rows, dim, itemsize) rows: the
  plain scan's block (``engine._pick_block_rows``, equal to the JAX
  engine's), K1's launch plan (``topk_plan``/``part_tiles``: every 128-row
  tile walked once) and K3's pre-pass block (``floor_gate``: within
  ``SUBMAX_TILE_BYTES``, whole blocks in the sample).
- ``test_engine_pallas_impl_matches_scan`` shards over ``[cpu] * 8`` for
  JAX's 8 forced CPU devices (``test_torch_sharding.py``).
- ``test_engine_count_floor_results_exact`` spies on the port's
  ``distances.kth_largest_count``, which runs at every search (the port
  has no trace to cache).
- ``test_engine_floor_gate_wiring_at_scale`` lowers a JAX program at
  262,144 rows and never runs it. The port has no trace: its
  ``floor_gate`` is held at the same five rows (gate open, the same
  block), then one search runs at rows the CPU takes in a second
  (``VROD_THETA0_BLK``, and ``_FRAC`` for the float rows, open the gate
  there) with spies on the engine's K3 and ``accumulation_margin`` calls:
  the query dtype K3 receives, and the margin for float dot/l2 only.
- ``test_sampled_submax_matches_reference`` holds the plain K3 EQUAL to a
  scan's group maxima, as the JAX case does, on TF32-representable inputs
  at "fast" (the port's float32 leg then scores exact products, as the
  float32 scan does); and the Pallas kernel's maxima within the bound.
- ``test_legacy_dot_snapshot_aux_recomputed`` rewrites ``aux.bin`` with
  the port's ``snapshot.RawStreamWriter``; the restore goes through
  ``Collection._apply_insert_raw``'s legacy branch.
"""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from vrod_tpu.engine import DeviceEngine as JaxEngine
from vrod_tpu.engine import _pick_block_rows as jax_pick_block_rows
from vrod_tpu.config import CollectionConfig as JaxConfig
from vrod_tpu.ops import distances as JD
from vrod_tpu.ops.pallas_topk import fused_topk as j_fused_topk
from vrod_tpu.ops.pallas_topk import pick_block_rows
from vrod_tpu.ops.pallas_topk import sampled_submax as j_sampled_submax
from vrod_tpu_torch import engine as port_engine
from vrod_tpu_torch.config import CollectionConfig
from vrod_tpu_torch.engine import DeviceEngine, FloorSettings, floor_gate
from vrod_tpu_torch.ops import cuda_topk
from vrod_tpu_torch.ops import distances as TD

from test_torch_kernels_plain import tf32_np

CPU = torch.device("cpu")


def t(a):
    return torch.from_numpy(np.array(a))


def make_data(rng, n, dim, metric, dead_every=0):
    """Rows, aux and valid as numpy, aux computed by JAX as in
    ``test_pallas.make_data``."""
    x = jnp.asarray(rng.standard_normal((n, dim)), dtype=jnp.float32)
    if metric == "cosine":
        aux = 1.0 / jnp.linalg.norm(x, axis=1)
    elif metric == "l2":
        aux = jnp.sum(x * x, axis=1)
    else:
        aux = jnp.zeros(n)
    valid = np.ones(n, dtype=bool)
    if dead_every:
        valid[::dead_every] = False
    return (np.asarray(x), np.asarray(aux, np.float32), valid)


def port_topk(x, aux, valid, q, *, k, metric, precision="fast", **kw):
    """The port's K1 (its plain version on CPU tensors), numpy out."""
    v, i = cuda_topk.fused_topk(t(x), t(aux), t(valid), t(q), k=k,
                                metric=metric, precision=precision, **kw)
    return v.numpy(), i.numpy()


def bound_of(x, aux, valid, q, metric, precision):
    return cuda_topk.score_error_bound(t(x), t(aux), t(valid), t(q),
                                       metric=metric,
                                       precision=precision).numpy()


def assert_agree(got, want, bound):
    msg = cuda_topk.topk_disagreement(*(t(a) for a in got),
                                      *(t(a) for a in want), t(bound))
    assert msg is None, msg


def jax_fast(x, aux, valid, q, **kw):
    """The Pallas kernel (interpret) on the TF32-rounded inputs that the
    port's float32 leg scores at "fast"."""
    v, i = j_fused_topk(jnp.asarray(tf32_np(x)), jnp.asarray(aux),
                        jnp.asarray(valid), jnp.asarray(tf32_np(q)),
                        interpret=True, **kw)
    return np.asarray(v), np.asarray(i)


def port_scan(x, aux, valid, q, *, k, metric, block_rows, offset=0):
    v, i = TD.blockwise_topk(t(x), t(aux), t(valid), t(q), k=k,
                             metric=metric, precision="exact",
                             block_rows=block_rows,
                             nblocks=x.shape[0] // block_rows,
                             index_offset=offset)
    return v.numpy(), i.numpy()


@pytest.mark.parametrize("pipeline", ["manual", "auto"])
@pytest.mark.parametrize("metric", ["cosine", "l2", "dot"])
def test_matches_scan(metric, pipeline, rng):
    x, aux, valid = make_data(rng, 1024, 64, metric, dead_every=7)
    q = rng.standard_normal((8, 64)).astype(np.float32)
    bound = bound_of(x, aux, valid, q, metric, "exact")
    got = port_topk(x, aux, valid, q, k=10, metric=metric,
                    precision="exact")
    assert_agree(got, port_scan(x, aux, valid, q, k=10, metric=metric,
                                block_rows=128), bound)
    jv, ji = j_fused_topk(jnp.asarray(x), jnp.asarray(aux),
                          jnp.asarray(valid), jnp.asarray(q), k=10,
                          metric=metric, block_rows=128,
                          precision_name="exact", interpret=True,
                          pipeline=pipeline)
    assert_agree(got, (np.asarray(jv), np.asarray(ji)), bound)


def test_index_offset(rng):
    x, aux, valid = make_data(rng, 256, 32, "dot")
    q = rng.standard_normal((8, 32)).astype(np.float32)
    bound = bound_of(x, aux, valid, q, "dot", "exact")
    got = port_topk(x, aux, valid, q, k=5, metric="dot", precision="exact",
                    index_offset=1000)
    assert_agree(got, port_scan(x, aux, valid, q, k=5, metric="dot",
                                block_rows=128, offset=1000), bound)
    assert (got[1] >= 1000).all()
    jv, ji = j_fused_topk(jnp.asarray(x), jnp.asarray(aux),
                          jnp.asarray(valid), jnp.asarray(q), k=5,
                          metric="dot", block_rows=128, index_offset=1000,
                          precision_name="exact", interpret=True)
    assert_agree(got, (np.asarray(jv), np.asarray(ji)), bound)


def test_k_exceeds_live(rng):
    x, aux, valid = make_data(rng, 128, 32, "dot")
    valid[5:] = False  # only 5 live rows
    q = rng.standard_normal((8, 32)).astype(np.float32)
    v1, i1 = port_topk(x, aux, valid, q, k=16, metric="dot")
    assert ((i1 >= 0).sum(axis=1) == 5).all()
    assert (i1[:, 5:] == -1).all()
    assert np.isneginf(v1[:, 5:]).all()
    assert_agree((v1, i1), jax_fast(x, aux, valid, q, k=16, metric="dot",
                                    block_rows=128),
                 bound_of(x, aux, valid, q, "dot", "fast"))


def test_all_dead(rng):
    x, aux, valid = make_data(rng, 128, 32, "cosine")
    valid[:] = False
    q = rng.standard_normal((8, 32)).astype(np.float32)
    v1, i1 = port_topk(x, aux, valid, q, k=4, metric="cosine")
    assert (i1 == -1).all()
    jv, ji = jax_fast(x, aux, valid, q, k=4, metric="cosine",
                      block_rows=128)
    np.testing.assert_array_equal(i1, ji)
    np.testing.assert_array_equal(v1, jv)


def test_duplicate_scores(rng):
    """Ties must resolve to the lowest index, like the scan path."""
    x = np.ones((256, 32), dtype=np.float32)
    aux = np.zeros(256, np.float32)
    valid = np.ones(256, dtype=bool)
    q = np.ones((8, 32), dtype=np.float32)
    v1, i1 = port_topk(x, aux, valid, q, k=4, metric="dot")
    np.testing.assert_array_equal(i1, np.tile(np.arange(4), (8, 1)))
    jv, ji = jax_fast(x, aux, valid, q, k=4, metric="dot", block_rows=128)
    np.testing.assert_array_equal(i1, ji)
    np.testing.assert_array_equal(v1, jv)


def test_multi_query_tile_grid(rng):
    """B larger than one tile exercises the query-tile grid dimension (on
    the card, K1's query groups; ``test_torch_plan.py`` holds its grid)."""
    x, aux, valid = make_data(rng, 512, 32, "dot")
    q = rng.standard_normal((16, 32)).astype(np.float32)
    bound = bound_of(x, aux, valid, q, "dot", "exact")
    got = port_topk(x, aux, valid, q, k=8, metric="dot", precision="exact")
    assert_agree(got, port_scan(x, aux, valid, q, k=8, metric="dot",
                                block_rows=128), bound)
    v2, i2 = JD.blockwise_topk(jnp.asarray(x), jnp.asarray(aux),
                               jnp.asarray(valid), jnp.asarray(q), k=8,
                               metric="dot",
                               precision=lax.Precision.HIGHEST,
                               block_rows=128, nblocks=4)
    assert_agree(got, (np.asarray(v2), np.asarray(i2)), bound)
    assert_agree(port_topk(x, aux, valid, q, k=8, metric="dot"),
                 jax_fast(x, aux, valid, q, k=8, metric="dot",
                          block_rows=128),
                 bound_of(x, aux, valid, q, "dot", "fast"))


@pytest.mark.parametrize("rows,dim,itemsize", [
    (131072, 768, 4), (131072, 768, 2), (131072, 4096, 4), (128, 48, 4),
    (96, 48, 4)])
def test_pick_block_rows(rows, dim, itemsize):
    # The JAX case's rows, as the JAX package picks its Pallas tile.
    blk = pick_block_rows(rows, dim, itemsize)
    assert rows % blk == 0
    # The plain scan's block: the JAX engine's choice, dividing the rows.
    for seg in (64, 1024, 65536, rows):
        b = port_engine._pick_block_rows(rows, seg)
        assert b == jax_pick_block_rows(rows, seg)
        assert rows % b == 0 or b == 8
    # K1's launch plan walks every 128-row tile exactly once (any row
    # count: the last tile may be partial), at one and at two query groups.
    for b in (8, 300):
        plan = cuda_topk.topk_plan(rows, b, 28, 132)
        parts = plan.parts
        walked = sorted(tile for p in range(parts)
                        for tile in cuda_topk.part_tiles(p, parts, rows))
        assert walked == list(range(-(-rows // 128)))
        assert plan.groups == -(-b // 64) and plan.cap >= 28
    # K3's pre-pass block, wherever the gate opens at these rows: within
    # the tile budget, a multiple of 128 rows, whole blocks in the sample.
    for k_scan, quant in ((28, True), (72, False)):
        ok, n_sample, pblk = floor_gate(rows, k_scan, dim, itemsize, quant,
                                        FloorSettings())
        assert pblk % 128 == 0
        assert pblk * dim * itemsize <= port_engine.SUBMAX_TILE_BYTES
        if ok:
            assert n_sample % pblk == 0 and n_sample > 0
    # f32 and bf16 at dim 768: 8192-row pre-pass blocks (JAX's "sweet
    # spot" 2048 is its VMEM tile; bf16's 16384 rows fit the budget but
    # its sample would hold one block, too few sub-maxima for k_scan 72);
    # dims too wide for the budget shrink the block.
    if (rows, dim) == (131072, 768):
        assert floor_gate(rows, 72, dim, itemsize, False,
                          FloorSettings())[2] == 8192
    if dim == 4096:
        assert floor_gate(rows, 72, dim, itemsize, False,
                          FloorSettings())[2] <= 1024


def test_engine_pallas_impl_matches_scan(rng):
    """End-to-end: engine with impl='pallas' (the kernels' plain versions
    on the CPU) against impl='scan', at 1 and 8 shards, and against the
    JAX engine on the same rows."""
    for shards in (1, 8):
        cfg = CollectionConfig(name="t", dim=32, metric="cosine",
                               segment_rows=128, shards=shards)
        eng = DeviceEngine(cfg, devices=[CPU] * shards)
        jeng = JaxEngine(JaxConfig(name="t", dim=32, metric="cosine",
                                   segment_rows=128, shards=shards))
        n = 700
        vecs = rng.standard_normal((n, 32)).astype(np.float32)
        for e in (eng, jeng):
            e.ensure_capacity(n)
            e.write(np.arange(n, dtype=np.uint64), vecs)
            e.erase(np.arange(0, n, 9))
        q = rng.standard_normal((4, 32)).astype(np.float32)
        v_s, i_s = eng.search(q, 10, impl="scan")
        v_p, i_p = eng.search(q, 10, impl="pallas")
        np.testing.assert_array_equal(i_s, i_p)
        jv, ji = jeng.search(q, 10, impl="pallas")
        np.testing.assert_array_equal(i_p, np.asarray(ji))
        np.testing.assert_allclose(v_p, np.asarray(jv), rtol=1e-6,
                                   atol=2e-6)


def test_fused_topk_pads_nondivisible_rows(rng):
    """Direct fused_topk callers with n not divisible by any block choice
    must still scan every row (the tail used to be silently dropped)."""
    n, d = 1001, 32
    x = rng.standard_normal((n, d)).astype(np.float32)
    aux = np.ones((n,), np.float32)
    valid = np.ones((n,), bool)
    q = x[n - 1:n]  # the LAST row: lives in the would-be-truncated tail
    vals, idx = port_topk(x, aux, valid, q, k=1, metric="dot")
    assert int(idx[0, 0]) == n - 1
    jv, ji = jax_fast(x, aux, valid, q, k=1, metric="dot")
    assert int(ji[0, 0]) == n - 1


def test_theta0_warm_start_is_exact(rng):
    """A sampled sound floor must not change results: indices with and
    without theta0 are identical (including ties and deletions)."""
    n, d, b, k = 4096, 32, 16, 24
    x = rng.standard_normal((n, d)).astype(np.float32)
    aux = np.ones((n,), np.float32)
    valid = rng.random(n) > 0.1
    q = rng.standard_normal((b, d)).astype(np.float32)
    t0 = TD.sampled_threshold(t(x), t(aux), t(valid), t(q), k=k,
                              metric="dot", precision="exact",
                              max_fraction=4)
    jt0 = JD.sampled_threshold(jnp.asarray(x), jnp.asarray(aux),
                               jnp.asarray(valid), jnp.asarray(q), k=k,
                               metric="dot", precision=lax.Precision.HIGHEST,
                               max_fraction=4)
    np.testing.assert_allclose(t0.numpy(), np.asarray(jt0), rtol=1e-5,
                               atol=1e-5)
    assert np.isfinite(t0.numpy()).all()
    base_v, base_i = port_topk(x, aux, valid, q, k=k, metric="dot")
    warm_v, warm_i = port_topk(x, aux, valid, q, k=k, metric="dot",
                               theta0=t0)
    assert (warm_i == base_i).all()
    assert (warm_v == base_v).all()


def test_sampled_threshold_soundness_randomized(rng):
    """theta0 <= the true k-th best score for every query (the soundness
    contract), across metrics and deletion patterns."""
    for metric in ("dot", "cosine", "l2"):
        n, d, b, k = 2048, 16, 8, 17
        x = jnp.asarray(rng.standard_normal((n, d)), dtype=jnp.float32)
        if metric == "cosine":
            aux = 1.0 / jnp.linalg.norm(x, axis=1)
        elif metric == "l2":
            aux = jnp.sum(x * x, axis=1)
        else:
            aux = jnp.zeros((n,), jnp.float32)
        valid = rng.random(n) > 0.3
        qf = rng.standard_normal((b, d)).astype(np.float32)
        q = (qf / np.linalg.norm(qf, axis=1, keepdims=True)
             if metric == "cosine" else qf)
        x, aux = np.asarray(x), np.asarray(aux, np.float32)
        t0 = TD.sampled_threshold(t(x), t(aux), t(valid), t(q), k=k,
                                  metric=metric, precision="exact",
                                  max_fraction=1).numpy()
        s = TD.block_scores(t(q), t(x), t(aux), t(valid), metric=metric,
                            precision="exact").numpy()
        kth = np.sort(s, axis=1)[:, -k]
        assert (t0[:, 0] <= kth + 1e-7).all(), (metric, t0[:, 0], kth)
        jt0 = JD.sampled_threshold(
            jnp.asarray(x), jnp.asarray(aux), jnp.asarray(valid),
            jnp.asarray(q), k=k, metric=metric,
            precision=lax.Precision.HIGHEST, max_fraction=1)
        np.testing.assert_allclose(t0, np.asarray(jt0), rtol=1e-5,
                                   atol=1e-5)


def test_kth_largest_count_exact(rng):
    """kth_largest_count returns the EXACT per-row k-th largest (numpy
    sort oracle) across ties, negatives, -inf, denormals, and the k=1 /
    k=nsub edges, equal to the JAX function's."""
    cases = []
    for nsub, k in [(128, 1), (128, 128), (256, 17), (1024, 100)]:
        cases.append((rng.standard_normal((8, nsub)).astype(np.float32), k))
    # Heavy ties (quantized values) + -inf holes + denormal magnitudes.
    tied = np.round(rng.standard_normal((8, 256)) * 2).astype(np.float32)
    tied[rng.random(tied.shape) < 0.2] = -np.inf
    cases.append((tied, 9))
    tiny = (rng.standard_normal((4, 128)) * 1e-42).astype(np.float32)
    cases.append((tiny, 5))
    allneg = -np.abs(rng.standard_normal((4, 128))).astype(np.float32)
    cases.append((allneg, 31))
    for sub, k in cases:
        got = TD.kth_largest_count(t(sub), k).numpy()[:, 0]
        want = np.sort(sub, axis=1)[:, -k]
        np.testing.assert_array_equal(got, want, err_msg=f"k={k}")
        np.testing.assert_array_equal(
            got, np.asarray(JD.kth_largest_count(jnp.asarray(sub), k))[:, 0])


def test_threshold_from_submax_count_vs_topk(rng):
    """method='count' agrees with the exact topk method bit-for-bit (same
    k-th statistic in, same margin formula out), and with JAX's."""
    sub = rng.standard_normal((16, 512)).astype(np.float32)
    k = 33
    a = TD.threshold_from_submax(t(sub), k, method="topk").numpy()
    b = TD.threshold_from_submax(t(sub), k, method="count").numpy()
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(b, np.asarray(
        JD.threshold_from_submax(jnp.asarray(sub), k, method="count")))
    # And the disabled-floor edge: fewer sub-maxima than k.
    small = rng.standard_normal((4, 8)).astype(np.float32)
    out = TD.threshold_from_submax(t(small), 9, method="count").numpy()
    assert np.isneginf(out).all()


def test_engine_count_floor_results_exact(rng, monkeypatch):
    """End-to-end: the engine with VROD_THETA0_METHOD=count matches the
    scan oracle with the floor gate ACTUALLY OPEN: int8 cosine, rows
    32768, k=16 -> k_scan 28, blk forced to 2048 -> n_sample 6144, nsub
    384 >= 2*28, rows >= 4*6144; a spy proves the count method really
    computed the threshold (no silent fallback)."""
    monkeypatch.setenv("VROD_THETA0_METHOD", "count")
    monkeypatch.setenv("VROD_THETA0_BLK", "2048")
    seen = {}
    orig = TD.kth_largest_count

    def spy(sub, k):
        seen["k"] = k
        return orig(sub, k)

    monkeypatch.setattr(TD, "kth_largest_count", spy)
    cfg = CollectionConfig(name="cntf", dim=48, metric="cosine",
                           dtype="int8", segment_rows=32768, shards=1)
    eng = DeviceEngine(cfg, device=CPU)
    n = 32768
    vecs = rng.standard_normal((n, 48)).astype(np.float32)
    eng.ensure_capacity(n)
    eng.write(np.arange(n, dtype=np.uint64), vecs)
    eng.erase(np.arange(0, n, 11))
    q = rng.standard_normal((8, 48)).astype(np.float32)
    vp, ip = eng.search(q, k=16, impl="pallas")
    vs, is_ = eng.search(q, k=16, impl="scan")
    np.testing.assert_array_equal(ip, is_)
    np.testing.assert_allclose(vp, vs, rtol=1e-6)
    assert seen.get("k") == 28, "count threshold never ran (gate closed?)"
    # Typos must be loud, not silently pick some method (perf lever).
    monkeypatch.setenv("VROD_THETA0_METHOD", "Count")
    with pytest.raises(ValueError, match="VROD_THETA0_METHOD"):
        eng.search(q, k=16, impl="pallas")


def test_sampled_submax_matches_reference(rng):
    """The group-max pre-pass equals the reference (strided groups of
    block_rows//128 rows, 128 maxima per block)."""
    n, d, b, blk = 1024, 32, 8, 256
    # TF32-representable inputs: the float32 leg scores them exactly as
    # the float32 scan does.
    x = tf32_np(rng.standard_normal((n, d)).astype(np.float32))
    aux = np.ones((n,), np.float32)
    valid = rng.random(n) > 0.2
    q = tf32_np(rng.standard_normal((b, d)).astype(np.float32))
    sub = cuda_topk.sampled_submax(t(x), t(aux), t(valid), t(q),
                                   metric="dot", block_rows=blk).numpy()
    s = TD.block_scores(t(q), t(x), t(aux), t(valid), metric="dot",
                        precision="exact").numpy()
    nblocks = n // blk
    ref = np.full((b, nblocks * 128), -np.inf, np.float32)
    for j in range(nblocks):
        blk_s = s[:, j * blk:(j + 1) * blk].reshape(b, blk // 128, 128)
        ref[:, j * 128:(j + 1) * 128] = blk_s.max(axis=1)
    np.testing.assert_array_equal(sub, ref)
    jsub = np.asarray(j_sampled_submax(
        jnp.asarray(x), jnp.asarray(aux), jnp.asarray(valid),
        jnp.asarray(q), metric="dot", block_rows=blk,
        precision_name="exact", interpret=True))
    np.testing.assert_array_equal(np.isneginf(sub), np.isneginf(jsub))
    fin = np.isfinite(jsub)
    assert (np.abs(sub[fin] - jsub[fin]) <= np.broadcast_to(
        bound_of(x, aux, valid, q, "dot", "fast"), sub.shape)[fin]).all()


@pytest.mark.parametrize("metric", ["dot", "l2"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dot_l2_floor_sound_and_exact(rng, metric, dtype):
    """The engine's dot/l2 floor recipe (sampled_submax +
    accumulation_margin + threshold_from_submax): theta0 <= the true k-th
    best score, and warm-started results are bit-identical, including
    adversarial norm spreads (some rows 100x larger)."""
    n, d, b, k = 4096, 32, 8, 64
    xf = rng.standard_normal((n, d)).astype(np.float32)
    xf[rng.integers(0, n, 64)] *= 100.0  # adversarial magnitude spread
    rows, aux = TD.prepare_rows(t(xf), metric=metric, dtype=dtype)
    valid = t(rng.random(n) > 0.2)
    q = t((rng.standard_normal((b, d)) * 3).astype(np.float32))

    n_sample = 2048
    sub = cuda_topk.sampled_submax(rows[:n_sample], aux[:n_sample],
                                   valid[:n_sample], q, metric=metric,
                                   block_rows=2048)
    extra = TD.accumulation_margin(q, aux, valid, metric=metric, dim=d)
    t0 = TD.threshold_from_submax(sub, k, extra=extra)

    # Soundness: floor <= exact k-th best score of the FULL set.
    s = TD.block_scores(q, rows, aux, valid, metric=metric,
                        precision="exact").numpy()
    kth = np.sort(s, axis=1)[:, -k]
    assert (t0.numpy()[:, 0] <= kth + 1e-7).all(), (metric, dtype)

    # Bit-identical warm start at the production fast precision.
    base_v, base_i = cuda_topk.fused_topk(rows, aux, valid, q, k=k,
                                          metric=metric)
    warm_v, warm_i = cuda_topk.fused_topk(rows, aux, valid, q, k=k,
                                          metric=metric, theta0=t0)
    assert torch.equal(warm_i, base_i)
    assert torch.equal(warm_v, base_v)


@pytest.mark.parametrize("metric", ["dot", "l2"])
def test_int8_floor_sound_and_exact(rng, metric):
    """int8 dot/l2 sampled floor: the integer dot is order-independent and
    the epilogue elementwise, so the pre-pass scores are bit-identical to
    the main kernel's: the floor is sound with NO accumulation margin
    (extra=None, the engine's recipe). Warm-started results must be
    bit-identical; the floor must lower-bound the true k-th best score;
    the pre-pass equals the Pallas kernel's."""
    n, d, b, k = 4096, 32, 8, 64
    xf = rng.standard_normal((n, d)).astype(np.float32)
    xf[rng.integers(0, n, 64)] *= 100.0  # adversarial magnitude spread
    rows, aux = TD.prepare_rows(t(xf), metric=metric, dtype="int8")
    valid = t(rng.random(n) > 0.2)
    qf = t((rng.standard_normal((b, d)) * 3).astype(np.float32))
    q8, qs = TD.prepare_queries(qf, metric=metric, quantize=True,
                                return_scale=True)
    if metric == "l2":
        extras = dict(row_bias=-TD.row_norms2(rows, aux),
                      q_scale=qs.reshape(-1))
    else:
        extras = {}  # dot drops the per-query scale (rank-invariant)

    n_sample = 2048
    sub_kw = {kk: (v[:n_sample] if kk == "row_bias" else v)
              for kk, v in extras.items()}
    sub = cuda_topk.sampled_submax(
        rows[:n_sample], aux[:n_sample], valid[:n_sample], q8,
        metric=metric, block_rows=2048, **sub_kw)
    t0 = TD.threshold_from_submax(sub, k, extra=None)
    jsub = np.asarray(j_sampled_submax(
        *(jnp.asarray(a.numpy()) for a in (rows[:n_sample], aux[:n_sample],
                                           valid[:n_sample], q8)),
        metric=metric, precision_name="fast", interpret=True,
        **{kk: jnp.asarray(v.numpy()) for kk, v in sub_kw.items()}))
    if metric == "dot":
        np.testing.assert_array_equal(sub.numpy(), jsub)
    else:
        # The Pallas interpreter fuses the l2 epilogue's last multiply and
        # add (test_torch_kernels_plain.py): within one rounding of the
        # product and of the sum, 2^-22 * (|product| + |mask|).
        r = rows[:n_sample].numpy().astype(np.float64)
        ga = (q8.numpy().astype(np.float64) @ r.T).astype(np.float32) \
            * aux[:n_sample].numpy()[None, :]
        qs2 = 2.0 * qs.numpy().astype(np.float32)
        live = valid[:n_sample].numpy()
        part = np.abs(ga * qs2) + np.abs(sub_kw["row_bias"].numpy())[None, :]
        bound = 2.0 ** -22 * part[:, live].max(axis=1, keepdims=True)
        fin = np.isfinite(jsub)
        np.testing.assert_array_equal(np.isfinite(sub.numpy()), fin)
        err = np.where(fin, np.abs(sub.numpy() - jsub), 0.0)
        assert (err <= bound).all()

    # Soundness vs the kernel's own score space, computed in f64: dot
    # drops the query scale, l2 keeps it (2*sq*sx*g - |x_hat|^2).
    x64 = rows.numpy().astype(np.float64)
    a64 = aux.numpy().astype(np.float64)
    g = q8.numpy().astype(np.float64) @ x64.T
    if metric == "l2":
        s = 2.0 * qs.numpy().astype(np.float64) * (g * a64[None, :]) \
            - (a64 * a64 * (x64 ** 2).sum(1))[None, :]
    else:
        s = g * a64[None, :]
    s[:, ~valid.numpy()] = -np.inf
    kth = np.sort(s, axis=1)[:, -k]
    assert (t0.numpy()[:, 0] <= kth + 1e-5).all(), metric

    base_v, base_i = cuda_topk.fused_topk(rows, aux, valid, q8, k=k,
                                          metric=metric, **extras)
    warm_v, warm_i = cuda_topk.fused_topk(rows, aux, valid, q8, k=k,
                                          metric=metric, theta0=t0, **extras)
    assert torch.equal(warm_i, base_i)
    assert torch.equal(warm_v, base_v)


@pytest.mark.parametrize("metric,dtype,dim,want_blk", [
    # bf16 at small dim: 16384-row pre-pass blocks fit the tile budget and
    # the 32k-row sample rounds to two whole blocks.
    ("l2", "bfloat16", 8, 16384),
    ("dot", "bfloat16", 8, 16384),
    # int8 top-16 (k_scan 28): the rows/32 sample (8192) rounds to zero
    # 16384-blocks, so the gate takes 8192.
    ("cosine", "int8", 8, 8192),
    # f32 at dim 768: a 16384-row tile is 48 MB > SUBMAX_TILE_BYTES, so
    # 8192 directly.
    ("l2", "float32", 768, 8192),
    # f32 at dim 1024: 8192 busts the budget too (32 MB): 4096.
    ("cosine", "float32", 1024, 4096),
])
def test_engine_floor_gate_wiring_at_scale(metric, dtype, dim, want_blk,
                                           monkeypatch, rng):
    """The engine's floor glue: at 262,144 rows (the JAX case's) the gate
    must OPEN at the JAX case's block; then in one search (rows small
    enough for the CPU, the gate opened by ``VROD_THETA0_BLK``/``_FRAC``)
    the pre-pass must receive the right query (float32 for bf16/f32, the
    engine's quantized scan query for int8) and unnormalized float metrics
    must carry the accumulation_margin ``extra``, cosine and int8 not."""
    n = 262144
    quant = dtype == "int8"
    k_out = 16 if quant else 64
    cfg = CollectionConfig(name="g", dim=dim, metric=metric, dtype=dtype,
                           segment_rows=n)
    # k_scan as the engine widens it (scan_widths), at the JAX case's rows.
    margin = 12 if quant else max(8, port_engine.WIDE_K_MARGIN.get(dtype, 0))
    itemsize = {"int8": 1, "bfloat16": 2, "float32": 4}[dtype]
    ok, n_sample, blk = floor_gate(n, k_out + margin, dim, itemsize, quant,
                                   FloorSettings())
    assert ok, "floor gate never opened"
    assert blk == want_blk and n_sample % blk == 0

    seen = {}
    orig_submax = cuda_topk.sampled_submax
    orig_margin = TD.accumulation_margin

    def spy_submax(x, aux, valid, q, **kw):
        seen["n_sample"] = int(x.shape[0])
        seen["q_dtype"] = str(q.dtype).replace("torch.", "")
        seen["blk"] = kw.get("block_rows")
        return orig_submax(x, aux, valid, q, **kw)

    def spy_margin(q, aux, valid, **kw):
        seen["extra"] = True
        return orig_margin(q, aux, valid, **kw)

    monkeypatch.setattr(cuda_topk, "sampled_submax", spy_submax)
    monkeypatch.setattr(TD, "accumulation_margin", spy_margin)
    rows, small_blk = (32768, 2048) if quant else (4096, 1024)
    monkeypatch.setenv("VROD_THETA0_BLK", str(small_blk))
    if not quant:
        monkeypatch.setenv("VROD_THETA0_FRAC", "1")
    eng = DeviceEngine(dataclasses.replace(cfg, segment_rows=rows),
                       device=CPU)
    eng.ensure_capacity(rows)
    eng.write(np.arange(rows, dtype=np.uint64),
              rng.standard_normal((rows, dim)).astype(np.float32))
    q = rng.standard_normal((8, dim)).astype(np.float32)
    assert eng.scan_widths(k_out) == (k_out, k_out + margin)
    vp, ip = eng.search(q, k_out)

    assert seen.get("n_sample", 0) > 0, "floor gate never opened"
    assert seen["blk"] == small_blk
    if quant:
        # int8 cosine scans with the quantized query, margin-free
        assert seen["q_dtype"] == "int8"
        assert "extra" not in seen
    else:
        # bf16/f32 scan with the f32 query; dot/l2 must carry the
        # Cauchy-Schwarz accumulation margin, cosine must not
        assert seen["q_dtype"] == "float32"
        assert seen.get("extra", False) == (metric != "cosine"), \
            "accumulation_margin wiring wrong"
    # The floor changed no answer.
    monkeypatch.setenv("VROD_THETA0", "0")
    vs, is_ = eng.search(q, k_out)
    np.testing.assert_array_equal(ip, is_)
    np.testing.assert_array_equal(vp, vs)


def test_dot_aux_lane_stores_norm2(rng):
    """prepare_rows for dot fills aux with |x|^2 (the floor's norm bound);
    the dot epilogue must keep ignoring it."""
    x = rng.standard_normal((16, 8)).astype(np.float32)
    rows, aux = TD.prepare_rows(t(x), metric="dot", dtype="float32")
    np.testing.assert_allclose(aux.numpy(), (x ** 2).sum(1), rtol=1e-6)
    _, jaux = JD.prepare_rows(jnp.asarray(x), metric="dot", dtype="float32")
    np.testing.assert_allclose(aux.numpy(), np.asarray(jaux), rtol=1e-6)
    s = TD.block_scores(t(x[:2]), rows, aux, torch.ones(16, dtype=torch.bool),
                        metric="dot", precision="exact")
    np.testing.assert_allclose(s.numpy(), x[:2] @ x.T, rtol=1e-5)


def test_legacy_dot_snapshot_aux_recomputed(tmp_path, rng):
    """Round <= 2 dot snapshots persisted aux = 0; restore must rebuild
    |x|^2 so the sampled floor's norm bound stays sound."""
    from vrod_tpu_torch import snapshot as snapio
    from vrod_tpu_torch.collection import Collection

    cfg = CollectionConfig(name="ld", dim=8, metric="dot", segment_rows=64)
    col = Collection.create(tmp_path / "ld", cfg)
    vecs = rng.standard_normal((10, 8)).astype(np.float32)
    col.bulk_insert(vecs)
    col.snapshot()
    col.close()
    # Rewrite the snapshot aux file with zeros (legacy format).
    snap = tmp_path / "ld" / "snapshot"
    w = snapio.RawStreamWriter(snap / "aux.bin")
    w.write_rows(np.zeros(10, np.float32))
    crc = w.close()
    meta = json.loads((snap / "meta.json").read_text())
    meta["crc32"]["aux.bin"] = crc
    # Legacy (round <= 2) metas predate the meta_crc self-checksum;
    # dropping it exercises the accepted-legacy restore path too.
    meta.pop("meta_crc", None)
    (snap / "meta.json").write_text(json.dumps(meta))

    col2 = Collection.load(tmp_path / "ld")
    aux = col2.engine.aux.numpy()[:10]
    np.testing.assert_allclose(aux, (vecs ** 2).sum(1), rtol=1e-5)
    col2.close()
