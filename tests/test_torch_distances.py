"""The port's plain PyTorch ops (vrod_tpu_torch.ops.distances) against the
JAX reference (vrod_tpu.ops.distances) on the same numpy inputs.

Tolerances:
- int8 quantization: the cosine normalization takes a norm whose last ulp
  differs between JAX's and torch's CPU kernels in about half of random
  rows, so a stored byte may differ by 1 at a rounding edge: at most 1e-5
  of elements, never by more than 1; the scale (aux) within rtol 1e-6.
- Integer-valued scores (int8 rows, int8 query) are exact in float32 in any
  summation order: compared for equality.
- Float products summed in another order (rescore, the l2 finalize):
  rtol 1e-5, and atol 1e-5 where the sum cancels near zero.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from vrod_tpu.ops import distances as JD
from vrod_tpu_torch.ops import distances as TD


def t(a):
    return torch.from_numpy(np.array(a))


def j(a):
    return jnp.asarray(a)


def int8_state(rng, n, d, metric="cosine", dead_every=7):
    x = rng.standard_normal((n, d)).astype(np.float32)
    rows, aux = JD.prepare_rows(j(x), metric=metric, dtype=jnp.int8)
    valid = np.ones(n, bool)
    if dead_every:
        valid[::dead_every] = False
    return np.array(rows), np.array(aux), valid


def assert_bytes_close(a, b):
    diff = np.abs(a.astype(np.int32) - b.astype(np.int32))
    assert diff.max() <= 1
    assert (diff != 0).mean() <= 1e-5


@pytest.mark.parametrize("metric", ["cosine", "dot", "l2"])
def test_prepare_rows_int8(rng, metric):
    x = (rng.standard_normal((2000, 96)) * 3).astype(np.float32)
    jr, ja = JD.prepare_rows(j(x), metric=metric, dtype=jnp.int8)
    tr, ta = TD.prepare_rows(t(x), metric=metric, dtype=torch.int8)
    assert tr.dtype == torch.int8 and ta.dtype == torch.float32
    assert_bytes_close(np.asarray(jr), tr.numpy())
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-6)


def test_prepare_rows_int4_and_pack_roundtrip(rng):
    x = rng.standard_normal((500, 32)).astype(np.float32)
    jr, ja = JD.prepare_rows(j(x), metric="cosine", dtype="int4")
    tr, ta = TD.prepare_rows(t(x), metric="cosine", dtype="int4")
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-6)
    jun = np.asarray(JD.unpack_int4_rows(jr))
    tun = TD.unpack_int4_rows(tr).numpy()
    assert_bytes_close(jun, tun)
    # pack/unpack of the same nibbles agree byte for byte.
    q4 = rng.integers(-8, 8, (16, 32)).astype(np.int8)
    np.testing.assert_array_equal(TD.pack_int4(t(q4)).numpy(),
                                  np.asarray(JD.pack_int4(j(q4))))
    np.testing.assert_array_equal(
        TD.unpack_int4_rows(TD.pack_int4(t(q4))).numpy(), q4)


@pytest.mark.parametrize("metric", ["cosine", "dot", "l2"])
def test_prepare_rows_float(rng, metric):
    x = rng.standard_normal((300, 48)).astype(np.float32)
    jr, ja = JD.prepare_rows(j(x), metric=metric, dtype=jnp.float32)
    tr, ta = TD.prepare_rows(t(x), metric=metric, dtype=torch.float32)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-6)


@pytest.mark.parametrize("metric", ["cosine", "dot", "l2"])
def test_prepare_queries(rng, metric):
    q = rng.standard_normal((64, 768)).astype(np.float32)
    jq, js = JD.prepare_queries(j(q), metric=metric, quantize=True,
                                return_scale=True)
    tq, ts = TD.prepare_queries(t(q), metric=metric, quantize=True,
                                return_scale=True)
    assert_bytes_close(np.asarray(jq), tq.numpy())
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6)
    np.testing.assert_allclose(
        TD.prepare_queries(t(q), metric=metric).numpy(),
        np.asarray(JD.prepare_queries(j(q), metric=metric)), rtol=1e-6)


def test_kth_largest_count_exact(rng):
    cases = [(rng.standard_normal((8, 256)).astype(np.float32), 17),
             (rng.standard_normal((4, 128)).astype(np.float32), 128),
             (rng.standard_normal((4, 128)).astype(np.float32), 1)]
    tied = np.round(rng.standard_normal((8, 256)) * 2).astype(np.float32)
    tied[rng.random(tied.shape) < 0.2] = -np.inf
    cases.append((tied, 9))
    cases.append(((rng.standard_normal((4, 128)) * 1e-42)
                  .astype(np.float32), 5))
    cases.append((-np.abs(rng.standard_normal((4, 128))).astype(np.float32),
                  31))
    for sub, k in cases:
        got = TD.kth_largest_count(t(sub), k).numpy()
        np.testing.assert_array_equal(
            got, np.asarray(JD.kth_largest_count(j(sub), k)))
        np.testing.assert_array_equal(got[:, 0], np.sort(sub, axis=1)[:, -k])


@pytest.mark.parametrize("k", [9, 28, 600])
def test_threshold_from_submax_count(rng, k):
    sub = rng.standard_normal((16, 512)).astype(np.float32)
    got = TD.threshold_from_submax(t(sub), k, method="count").numpy()
    want = np.asarray(JD.threshold_from_submax(j(sub), k, method="count"))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        TD.threshold_from_submax(t(sub), k, method="topk").numpy(), got
        if k <= 512 else want)


def test_block_scores_and_blockwise_topk_int8(rng):
    rows, aux, valid = int8_state(rng, 1024, 64)
    q = rng.standard_normal((8, 64)).astype(np.float32)
    q8 = np.asarray(JD.prepare_queries(j(q), metric="cosine", quantize=True))
    for metric in ("cosine", "dot", "l2"):
        js = JD.block_scores(j(q8), j(rows), j(aux), j(valid), metric=metric,
                             precision=lax.Precision.HIGHEST)
        ts = TD.block_scores(t(q8), t(rows), t(aux), t(valid), metric=metric,
                             precision="exact")
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    # Ties: duplicated rows must come out lowest slot first.
    rows[100:110] = rows[5]
    aux[100:110] = aux[5]
    jv, ji = JD.blockwise_topk(j(rows), j(aux), j(valid), j(q8), k=40,
                               metric="cosine",
                               precision=lax.Precision.HIGHEST,
                               block_rows=256, nblocks=4, index_offset=3)
    tv, ti = TD.blockwise_topk(t(rows), t(aux), t(valid), t(q8), k=40,
                               metric="cosine", precision="exact",
                               block_rows=256, nblocks=4, index_offset=3)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_merge_topk_ties_lowest_index_first():
    cv = torch.tensor([[5.0, 1.0]])
    ci = torch.tensor([[7, 2]], dtype=torch.int32)
    nv = torch.tensor([[5.0, 5.0, 1.0]])
    ni = torch.tensor([[9, 10, 11]], dtype=torch.int32)
    v, i = TD.merge_topk(cv, ci, nv, ni, 4)
    assert i.tolist() == [[7, 9, 10, 2]]
    assert v.tolist() == [[5.0, 5.0, 5.0, 1.0]]


@pytest.mark.parametrize("metric", ["cosine", "dot", "l2"])
def test_rescore_and_finalize(rng, metric):
    rows, aux, valid = int8_state(rng, 512, 64, metric=metric)
    q = rng.standard_normal((8, 64)).astype(np.float32)
    qp = np.asarray(JD.prepare_queries(j(q), metric=metric))
    cand = rng.choice(512, (8, 40), replace=True).astype(np.int32)
    cand[:, -3:] = -1
    jv, ji = JD.rescore(j(rows), j(aux), j(valid), j(qp), j(cand), k=16,
                        metric=metric)
    tv, ti = TD.rescore(t(rows), t(aux), t(valid), t(qp), t(cand), k=16,
                        metric=metric)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    # Sums that cancel near zero carry the reorder error as an absolute
    # one: atol 1e-5 (D * 2^-24 * sum|terms| is ~1e-5 here).
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5,
                               atol=1e-5)
    fj = np.asarray(JD.finalize_scores(jv, j(q), metric=metric))
    ft = TD.finalize_scores(t(np.asarray(jv)), t(q), metric=metric).numpy()
    np.testing.assert_allclose(ft, fj, rtol=1e-5, atol=1e-5)


def test_accumulation_margin_and_sampled_threshold(rng):
    x = rng.standard_normal((4096, 32)).astype(np.float32)
    rows, aux = JD.prepare_rows(j(x), metric="dot", dtype=jnp.float32)
    rows, aux = np.array(rows), np.array(aux)
    valid = rng.random(4096) > 0.2
    q = rng.standard_normal((8, 32)).astype(np.float32)
    np.testing.assert_allclose(
        TD.accumulation_margin(t(q), t(aux), t(valid), metric="l2",
                               dim=32).numpy(),
        np.asarray(JD.accumulation_margin(j(q), j(aux), j(valid),
                                          metric="l2", dim=32)), rtol=1e-5)
    got = TD.sampled_threshold(t(rows), t(aux), t(valid), t(q), k=17,
                               metric="dot", precision="exact").numpy()
    want = np.asarray(JD.sampled_threshold(
        j(rows), j(aux), j(valid), j(q), k=17, metric="dot",
        precision=lax.Precision.HIGHEST))
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("packed", [False, True])
def test_row_norms2_bit_equal_to_jax_and_rescore(rng, packed):
    """The norms lane (int8/int4 + l2) is |x_hat|^2 = sum(row^2) * (aux *
    aux), bit for bit the JAX engine's ``_row_norms2``, and in the same
    multiply order as ``rescore``: with a zero query the rescore's l2 score
    2 * (0 * aux) - n2 is exactly -norms."""
    from vrod_tpu.engine import _row_norms2
    x = rng.standard_normal((256, 48)).astype(np.float32)
    rows, aux = JD.prepare_rows(j(x), metric="l2",
                                dtype="int4" if packed else jnp.int8)
    rows, aux = np.array(rows), np.array(aux)
    got = TD.row_norms2(t(rows), t(aux), packed)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(_row_norms2(j(rows), j(aux), packed)))
    cand = np.arange(256, dtype=np.int32).reshape(8, 32)
    vals, idx = TD.rescore(t(rows), t(aux), t(np.ones(256, bool)),
                           torch.zeros((8, 48)), t(cand), k=32, metric="l2",
                           packed=packed)
    np.testing.assert_array_equal(
        -vals.numpy(), got.numpy()[idx.numpy().astype(np.int64)])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rescore_never_runs_as_tf32(rng, monkeypatch, dtype):
    """The exact rescore of float rows is a float32 multiply-and-sum, not a
    matmul that TF32 could reach: with TF32 switched on, its dot scores
    stay within float32 summation error of a float64 reference, a bound
    TF32's 10-bit mantissa would break by orders of magnitude."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    x = rng.standard_normal((512, 64)).astype(np.float32)
    rows, aux = TD.prepare_rows(t(x), metric="dot", dtype=dtype)
    q = rng.standard_normal((8, 64)).astype(np.float32)
    cand = rng.choice(512, (8, 40), replace=False).astype(np.int32)
    vals, idx = TD.rescore(rows, aux, torch.ones(512, dtype=torch.bool),
                           t(q), t(cand), k=40, metric="dot")
    r = rows.float().numpy().astype(np.float64)[idx.numpy().astype(np.int64)]
    prods = r * q.astype(np.float64)[:, None, :]
    want = prods.sum(axis=2)
    bound = 64 * 2.0 ** -24 * np.abs(prods).sum(axis=2)
    assert (np.abs(vals.numpy() - want) <= bound).all()
    assert bound.max() < 2.0 ** -11 * np.abs(want).max()
