"""The plain versions of the port's kernels (cuda_topk.fused_topk_plain and
sampled_submax_plain) against the JAX Pallas kernels in interpret mode, on
identical int8 state. int8 scores are exact integer dots times one float32
multiply (plus an exact 0/-inf mask), so values and slots must be EQUAL.

Shapes are the chip_smoke kernel cases shrunk to what interpret mode runs
quickly (N <= 2048). The CUDA kernels themselves are compared with these
plain versions on the card (``test_torch_cuda.py`` and chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vrod_tpu.ops import distances as JD
from vrod_tpu.ops.pallas_topk import fused_topk as j_fused_topk
from vrod_tpu.ops.pallas_topk import sampled_submax as j_sampled_submax
from vrod_tpu_torch.ops import cuda_topk
from vrod_tpu_torch.ops import distances as TD

# name, n, dim, batch, k_scan, dead_every, theta0 from K3, offset, ties
CASES = [
    ("floor_offset", 2048, 128, 8, 28, 7, True, 1000, False),
    ("no_floor", 2048, 128, 16, 28, 7, False, 0, False),
    ("k112_dim96", 2048, 96, 8, 112, 5, True, 0, False),
    ("dim30_tail", 1024, 30, 8, 8, 3, False, 17, False),
    ("ties", 1024, 128, 8, 28, 0, True, 0, True),
]


def make_state(rng, n, d, b, dead_every=0, ties=False, metric="cosine"):
    x = rng.standard_normal((n, d)).astype(np.float32)
    if ties:
        x[200:260] = x[3]
        x[700:720] = x[900]
    rows, aux = JD.prepare_rows(jnp.asarray(x), metric=metric,
                                dtype=jnp.int8)
    valid = np.ones(n, bool)
    if dead_every:
        valid[::dead_every] = False
    q = rng.standard_normal((b, d)).astype(np.float32)
    if ties:
        q[0] = x[3]
    q8 = JD.prepare_queries(jnp.asarray(q), metric=metric, quantize=True)
    return np.array(rows), np.array(aux), valid, np.array(q8)


def torch_args(rows, aux, valid, q8):
    return (torch.from_numpy(rows.copy()), torch.from_numpy(aux.copy()),
            torch.from_numpy(valid.copy()), torch.from_numpy(q8.copy()))


def jax_args(rows, aux, valid, q8):
    return (jnp.asarray(rows), jnp.asarray(aux), jnp.asarray(valid),
            jnp.asarray(q8))


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_fused_topk_plain_matches_pallas(rng, case):
    _, n, d, b, k, dead_every, floor, offset, ties = case
    rows, aux, valid, q8 = make_state(rng, n, d, b, dead_every, ties)
    theta0 = None
    if floor:
        ns, blk = n // 2, 256
        js = j_sampled_submax(*jax_args(rows[:ns], aux[:ns], valid[:ns], q8),
                              metric="cosine", block_rows=blk,
                              interpret=True)
        ts = cuda_topk.sampled_submax(
            *torch_args(rows[:ns], aux[:ns], valid[:ns], q8),
            metric="cosine", block_rows=blk)
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        theta0 = TD.threshold_from_submax(ts, k, method="count").numpy()
        assert np.isfinite(theta0).all()
    jv, ji = j_fused_topk(*jax_args(rows, aux, valid, q8), k=k,
                          metric="cosine", index_offset=offset,
                          interpret=True,
                          theta0=None if theta0 is None
                          else jnp.asarray(theta0))
    tv, ti = cuda_topk.fused_topk(*torch_args(rows, aux, valid, q8), k=k,
                                  metric="cosine", index_offset=offset,
                                  theta0=None if theta0 is None
                                  else torch.from_numpy(theta0))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    if ties:
        # Query 0 is row 3: its 61 exact copies share the top score and
        # must come out lowest slot first.
        assert ti[0, :k].tolist() == [3] + list(range(200, 200 + k - 1))


@pytest.mark.parametrize("metric", ["cosine", "dot"])
def test_sampled_submax_plain_matches_pallas(rng, metric):
    rows, aux, valid, q8 = make_state(rng, 2048, 64, 16, dead_every=4,
                                      metric=metric)
    js = j_sampled_submax(*jax_args(rows, aux, valid, q8), metric=metric,
                          block_rows=512, interpret=True)
    ts = cuda_topk.sampled_submax_plain(*torch_args(rows, aux, valid, q8),
                                        metric=metric, block_rows=512)
    assert ts.shape == (16, 4 * 128)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("live", [0, 5])
def test_all_dead_and_k_beyond_live(rng, live):
    rows, aux, valid, q8 = make_state(rng, 512, 32, 8)
    valid[live:] = False
    jv, ji = j_fused_topk(*jax_args(rows, aux, valid, q8), k=28,
                          metric="cosine", interpret=True)
    tv, ti = cuda_topk.fused_topk(*torch_args(rows, aux, valid, q8), k=28,
                                  metric="cosine")
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert ((ti.numpy() >= 0).sum(axis=1) == live).all()
    assert np.isneginf(tv.numpy()[:, live:]).all()


def test_cpu_tensors_take_the_plain_version(rng):
    rows, aux, valid, q8 = make_state(rng, 256, 32, 8)
    cuda_topk.reset_launches()
    cuda_topk.fused_topk(*torch_args(rows, aux, valid, q8), k=8,
                         metric="dot")
    cuda_topk.sampled_submax(*torch_args(rows, aux, valid, q8),
                             metric="dot", block_rows=128)
    assert cuda_topk.launches == {"fused_topk": 0, "sampled_submax": 0}


def test_wrappers_validate(rng):
    rows, aux, valid, q8 = torch_args(*make_state(rng, 256, 32, 8))
    with pytest.raises(TypeError, match="int8-quantized"):
        cuda_topk.fused_topk(rows, aux, valid, q8.float(), k=4,
                             metric="cosine")
    with pytest.raises(ValueError, match="metric"):
        cuda_topk.fused_topk(rows, aux, valid, q8, k=4, metric="l2")
    with pytest.raises(ValueError, match="multiple of"):
        cuda_topk.sampled_submax(rows, aux, valid, q8, metric="cosine",
                                 block_rows=96)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_topk.fused_topk(rows[:, ::2], aux, valid, q8[:, :16], k=4,
                             metric="cosine")
    with pytest.raises(ValueError, match="device"):
        cuda_topk.fused_topk(rows.to("meta"), aux.to("meta"),
                             valid.to("meta"), q8.to("meta"), k=4,
                             metric="cosine")

