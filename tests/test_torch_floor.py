"""The plain versions of the port's floor and gate kernels
(``cuda_floor.fused_theta_plain``, ``fused_intgate_plain``) and of K1
(``cuda_topk.fused_topk_plain``) against the JAX experiments' Pallas
kernels in interpret mode, on identical state:

- ``kexp20.fused_theta_gated`` (X8) and ``kexp17.fused_theta`` (X6, margin
  0 and a per-query margin) against ``fused_theta_plain``;
- ``kexp18.fused_gated`` (X7) against ``fused_topk_plain`` with the same
  theta0;
- ``kexp22.fused_intgate`` (X9) against ``fused_intgate_plain``.

The experiments are imported from their files; nothing in ``experiments/``
changes. Tolerances are those of ``test_torch_kernels_plain.py``: int8
scores are exact integer dots followed by the same rounded float32 op, so
values and slots are EQUAL; bfloat16 values agree within
``cuda_topk.score_error_bound`` and slots outside near-ties. The rows
number a multiple of the experiments' block (they scan whole blocks only),
so both packages see the same rows.
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from vrod_tpu.ops import distances as JD
from vrod_tpu_torch.convert import to_tensor
from vrod_tpu_torch.ops import cuda_floor
from vrod_tpu_torch.ops import cuda_topk
from vrod_tpu_torch.ops import distances as TD

EXPERIMENTS = Path(__file__).resolve().parent.parent / "experiments"
N, DIM, BATCH, BLOCK, S_BLOCKS = 4096, 128, 8, 512, 2
_JAX_DTYPE = {"int8": jnp.int8, "bf16": jnp.bfloat16}


def _experiment(name):
    spec = importlib.util.spec_from_file_location(
        f"_exp_{name}", EXPERIMENTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def kexp():
    return {n: _experiment(n) for n in ("kexp17", "kexp18", "kexp20",
                                        "kexp22")}


class State:
    """Cosine (or dot) rows of one dtype with dead slots, the kernel-ready
    query, as numpy, and both packages' views of them."""

    def __init__(self, seed, dtype, metric="cosine", dead_group=False):
        rng = np.random.default_rng(seed)
        self.dtype, self.metric = dtype, metric
        x = rng.standard_normal((N, DIM)).astype(np.float32)
        rows, aux = JD.prepare_rows(jnp.asarray(x), metric=metric,
                                    dtype=_JAX_DTYPE[dtype])
        self.rows, self.aux = np.array(rows), np.array(aux)
        # Dead slots inside and outside the sample.
        self.valid = np.ones(N, bool)
        self.valid[::7] = False
        if dead_group:
            # Lane 5 of sample block 1: rows 512 + 5 + 128 i, all dead.
            self.valid[BLOCK + 5:2 * BLOCK:128] = False
        q = rng.standard_normal((BATCH, DIM)).astype(np.float32)
        self.q = np.array(JD.prepare_queries(
            jnp.asarray(q), metric=metric, quantize=dtype == "int8"))

    def torch_args(self):
        return [to_tensor(a, "cpu") for a in (self.rows, self.aux,
                                               self.valid, self.q)]

    def jax_args(self):
        mask = np.where(self.valid, 0.0, -np.inf).astype(np.float32)
        return (jnp.asarray(self.rows), jnp.asarray(self.aux).reshape(1, N),
                jnp.asarray(mask).reshape(1, N), jnp.asarray(self.q),
                jnp.zeros((1,), jnp.int32))

    def bound(self):
        return cuda_topk.score_error_bound(*self.torch_args(),
                                           metric=self.metric).numpy()


def assert_agree(tv, ti, jv, ji, bound):
    if not bound.any():
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        return
    msg = cuda_topk.topk_disagreement(
        tv, ti, torch.from_numpy(np.asarray(jv)),
        torch.from_numpy(np.asarray(ji)), torch.from_numpy(bound))
    assert msg is None, msg


THETA_CASES = [(d, k, skip, exp) for d in ("int8", "bf16") for k in (24, 112)
               for skip in (False, True)
               for exp in ("kexp20", "kexp17-margin0", "kexp17-margin")]


@pytest.mark.parametrize("dtype,k,skip,exp", THETA_CASES, ids=[
    f"{d}-k{k}-{'skip' if s else 'plain'}-{e}" for d, k, s, e in THETA_CASES])
def test_fused_theta_plain_matches_kexp(kexp, dtype, k, skip, exp):
    st_ = State(11 + k, dtype)
    x, aux2d, mask2d, q, offset = st_.jax_args()
    common = dict(k=k, metric="cosine", block_rows=BLOCK, b_tile=BATCH,
                  s_blocks=S_BLOCKS, bisect_iters=14, precision_name="fast",
                  interpret=True, skip_sample_dots=skip)
    margin = np.zeros((BATCH, 1), np.float32)
    if exp == "kexp17-margin":
        margin = np.linspace(0.0, 0.02, BATCH, dtype=np.float32)[:, None]
    if exp == "kexp20":
        jv, ji = kexp["kexp20"].fused_theta_gated(x, aux2d, mask2d, q, offset,
                                                  **common)
    else:
        jv, ji = kexp["kexp17"].fused_theta(x, aux2d, mask2d, q, offset,
                                            jnp.asarray(margin), **common)
    tv, ti, t0 = cuda_floor.fused_theta(
        *st_.torch_args(), k=k, metric="cosine", block_rows=BLOCK,
        s_blocks=S_BLOCKS, margin=None if exp == "kexp20" else
        torch.from_numpy(margin), skip_sample_dots=skip, return_theta=True)
    assert_agree(tv, ti, jv, ji, st_.bound())
    # The floor is sound: at or below the k-th score of the scan without
    # it, and finite here (every 128-group holds a live row).
    fv, _ = cuda_topk.fused_topk_plain(*st_.torch_args(), k=k,
                                       metric="cosine")
    assert torch.isfinite(t0).all()
    assert (t0[:, 0] <= fv[:, k - 1]).all()


@pytest.mark.parametrize("dtype", ["int8", "bf16"])
def test_fused_theta_plain_dead_group_closes_the_floor(kexp, dtype):
    """A fully dead 128-group in the sample makes its sub-maximum -inf, so
    the bisection's lo stays -inf and the floor closes, in both packages."""
    st_ = State(5, dtype, dead_group=True)
    x, aux2d, mask2d, q, offset = st_.jax_args()
    jv, ji = kexp["kexp20"].fused_theta_gated(
        x, aux2d, mask2d, q, offset, k=24, metric="cosine", block_rows=BLOCK,
        b_tile=BATCH, s_blocks=S_BLOCKS, bisect_iters=14,
        precision_name="fast", interpret=True, skip_sample_dots=True)
    tv, ti, t0 = cuda_floor.fused_theta(
        *st_.torch_args(), k=24, metric="cosine", block_rows=BLOCK,
        s_blocks=S_BLOCKS, skip_sample_dots=True, return_theta=True)
    assert torch.isneginf(t0).all()
    assert_agree(tv, ti, jv, ji, st_.bound())


@pytest.mark.parametrize("dtype", ["int8", "bf16"])
@pytest.mark.parametrize("k", [24, 112])
@pytest.mark.parametrize("floor", [False, True])
def test_fused_topk_plain_matches_kexp18(kexp, dtype, k, floor):
    """X7: kexp18's gated extraction against K1's plain version, which the
    CUDA K1 (gated in its registers) is held to on the card."""
    st_ = State(23 + k, dtype)
    targs = st_.torch_args()
    t0 = torch.full((BATCH, 1), float("-inf"))
    if floor:
        sub = cuda_topk.sampled_submax_plain(
            *[a[:S_BLOCKS * BLOCK] for a in targs[:3]], targs[3],
            metric="cosine", block_rows=BLOCK)
        t0 = TD.threshold_from_submax(sub, k, method="count")
    x, aux2d, mask2d, q, offset = st_.jax_args()
    jv, ji = kexp["kexp18"].fused_gated(
        x, aux2d, mask2d, q, offset, jnp.asarray(t0.numpy()), k=k,
        metric="cosine", block_rows=BLOCK, b_tile=BATCH,
        precision_name="fast", interpret=True)
    tv, ti = cuda_topk.fused_topk_plain(*targs, k=k, metric="cosine",
                                        theta0=t0)
    assert_agree(tv, ti, jv, ji, st_.bound())


@pytest.mark.parametrize("metric", ["cosine", "dot"])
@pytest.mark.parametrize("floor", [False, True])
def test_fused_intgate_plain_matches_kexp22(kexp, metric, floor):
    st_ = State(31, "int8", metric)
    targs = st_.torch_args()
    t0 = torch.full((BATCH, 1), float("-inf"))
    if floor:
        sub = cuda_topk.sampled_submax_plain(
            *[a[:S_BLOCKS * BLOCK] for a in targs[:3]], targs[3],
            metric=metric, block_rows=BLOCK)
        t0 = TD.threshold_from_submax(sub, 24, method="count")
    x, aux2d, mask2d, q, offset = st_.jax_args()
    jv, ji = kexp["kexp22"].fused_intgate(
        x, aux2d, mask2d, q, offset, jnp.asarray(t0.numpy()), k=24,
        metric=metric, block_rows=BLOCK, b_tile=BATCH,
        precision_name="fast", interpret=True)
    tv, ti = cuda_floor.fused_intgate(*targs, k=24, metric=metric, theta0=t0)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    wv, wi = cuda_topk.fused_topk_plain(*targs, k=24, metric=metric,
                                        theta0=t0)
    assert torch.equal(tv, wv) and torch.equal(ti, wi)


def bisect_np(sub, k, iters=14):
    """kexp20.py:110-123 in numpy float32."""
    sub = np.asarray(sub, np.float32)
    hi = sub.max(axis=1, keepdims=True)
    lo = sub.min(axis=1, keepdims=True) - np.float32(1.0)
    for _ in range(iters):
        mid = np.float32(0.5) * (lo + hi)
        ge = (sub > mid).astype(np.int32).sum(axis=1, keepdims=True) >= k
        lo, hi = np.where(ge, mid, lo), np.where(ge, hi, mid)
    return lo


@pytest.mark.parametrize("dtype", ["int8", "bf16"])
@pytest.mark.parametrize("k", [24, 112])
def test_bisect_floor_bit_equal_to_kexp_arithmetic(dtype, k):
    st_ = State(41, dtype)
    targs = st_.torch_args()
    sub = cuda_topk.sampled_submax_plain(
        *[a[:S_BLOCKS * BLOCK] for a in targs[:3]], targs[3],
        metric="cosine", block_rows=BLOCK)
    got = TD.bisect_floor(sub, k)
    want = bisect_np(sub.numpy(), k)
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))
    # Sound: strictly below the k-th sub-maximum.
    kth = torch.sort(sub, dim=1, descending=True).values[:, k - 1:k]
    assert (got < kth).all()
    sub[2, 7] = float("-inf")
    np.testing.assert_array_equal(TD.bisect_floor(sub, k).numpy(),
                                  bisect_np(sub.numpy(), k))
    assert torch.isneginf(TD.bisect_floor(sub, k)[2]).all()


_AUX = st.one_of(st.just(0.0), st.floats(1e-38, 1e-30),
                 st.floats(1e-6, 10.0))


@settings(max_examples=300, deadline=None)
@given(g=st.lists(st.integers(-127 * 127 * DIM, 127 * 127 * DIM),
                  min_size=1, max_size=128),
       aux=st.lists(_AUX, min_size=128, max_size=128))
def test_intgate_tile_bound_never_below_the_best_score(g, aux):
    """kexp22's bound of a tile (aux with zeros and tiny values) is at or
    above every score fl(fl(g) * aux) of the tile."""
    a = np.float32(aux[:len(g)])
    gi = np.asarray(g, np.int64)
    ub = cuda_floor.tile_bounds(torch.from_numpy(gi.astype(np.float32))[None],
                                torch.from_numpy(a))
    best = (gi.astype(np.float32) * a).max()
    assert float(ub[0, 0]) >= best


@settings(max_examples=300, deadline=None)
@given(t=st.one_of(st.floats(-2.0, 2.0, width=32),
                   st.sampled_from([0.0, -0.0, float("inf"), float("-inf"),
                                    1e-30, -1e-30])),
       lo=_AUX, span=st.floats(1.0, 4.0),
       dg=st.integers(-3, 3))
def test_int_gate_is_the_bound_edge(t, lo, span, dg):
    """G = int_gate(t) is the edge of the bound: ub(G) <= t < ub(G + 1),
    so every dot at or below G (here G + dg for dg <= 0, g at the edge)
    scores at or below t for any aux in [amin, amax], and one above may
    not."""
    amin = np.float32(lo)
    amax = np.float32(lo * span)
    G = cuda_floor.int_gate(t, amin, amax)
    t32 = np.float32(t)
    if G == cuda_floor.INT32_MIN:
        assert cuda_floor._ub(-(1 << 30) + 1, amin, amax) > t32
        return
    if G == cuda_floor.INT32_MAX:
        assert cuda_floor._ub(1 << 30, amin, amax) <= t32
        return
    assert cuda_floor._ub(G, amin, amax) <= t32 < cuda_floor._ub(G + 1, amin,
                                                                 amax)
    g = G + min(dg, 0)
    for a in (amin, amax, np.float32((float(amin) + float(amax)) / 2)):
        if amin <= a <= amax:
            assert np.float32(np.float32(g) * a) <= t32


def test_int_gate_premises():
    """A range that breaks the bound's premises turns the gate off."""
    for amin, amax in ((-1e-3, 1.0), (0.5, 0.25), (0.0, float("inf")),
                       (float("nan"), 1.0)):
        assert cuda_floor.int_gate(0.1, amin, amax) == cuda_floor.INT32_MIN
    assert cuda_floor.int_gate(float("nan"), 0.0, 1.0) == cuda_floor.INT32_MIN
    assert cuda_floor.int_gate(0.5, 0.0, 0.0) == cuda_floor.INT32_MAX
    assert cuda_floor.int_gate(-0.5, 0.0, 1.0) == cuda_floor.INT32_MIN


def test_floor_wrappers_validate():
    args = State(3, "int8").torch_args()
    with pytest.raises(ValueError, match="2k sub-maxima"):
        cuda_floor.fused_theta(*args, k=200, metric="cosine",
                               block_rows=BLOCK, s_blocks=S_BLOCKS)
    with pytest.raises(ValueError, match="multiple of 128"):
        cuda_floor.fused_theta(*args, k=8, metric="cosine", block_rows=100,
                               s_blocks=2)
    with pytest.raises(ValueError, match="longer than the rows"):
        cuda_floor.fused_theta(*args, k=8, metric="cosine", block_rows=BLOCK,
                               s_blocks=9)
    bargs = State(3, "bf16").torch_args()
    with pytest.raises(ValueError, match="int8 rows under cosine or dot"):
        cuda_floor.fused_intgate(*bargs, k=8, metric="cosine")
    with pytest.raises(ValueError, match="int8 rows under cosine or dot"):
        cuda_floor.fused_intgate(*args, k=8, metric="l2")
    cuda_floor.reset_launches()
    cuda_floor.fused_intgate(*args, k=8, metric="dot")
    cuda_floor.fused_theta(*args, k=8, metric="cosine", block_rows=BLOCK,
                           s_blocks=S_BLOCKS, margin=0.01)
    assert not any(cuda_floor.launches.values())


@pytest.mark.parametrize("dtype,k_scan", [("int8", 24), ("bf16", 112)])
def test_kexp_floor_pairs_agree_on_the_cpu(dtype, k_scan):
    """The A/B entry point's pairs (``tools/kexp_floor.py``) at a small
    size on the CPU, where every wrapper runs its plain version: each
    variant returns the stock composition's (values, slots), with the
    engine gate's sample and with kexp20's."""
    spec = importlib.util.spec_from_file_location(
        "_kexp_floor", EXPERIMENTS.parent / "tools" / "kexp_floor.py")
    kf = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(kf)
    args = kf.make_state(dtype, 262144, 32, 8, 3, torch.device("cpu"))
    for frac in (0, 8):
        todo, (blk, s_blocks) = kf.pairs(args, k_scan, kf.LEGS, frac=frac,
                                         block_rows=2048)
        assert [(leg, v) for leg, v, *_ in todo] == [
            ("x6", "plain"), ("x6", "skip"), ("x7", "no floor"),
            ("x8", "plain"), ("x8", "skip")] + (
            [("x9", "intgate")] if dtype == "int8" else [])
        assert s_blocks * 128 >= 2 * k_scan
        for leg, variant, stock, fn in todo:
            sv, si = stock()
            vv, vi = fn()
            assert torch.equal(sv, vv) and torch.equal(si, vi), (leg, variant)
