"""The plain versions of the port's kernels (cuda_topk.fused_topk_plain and
sampled_submax_plain) against the JAX Pallas kernels in interpret mode, on
identical state, for every leg: int8 and packed int4 rows (int8-quantized
query) and bfloat16 and float32 rows (float query), float32 at the
precision "fast" (TF32) and at "exact" (the f32x3 leg: three TF32
products, against the Pallas kernel at HIGHEST), each with metric cosine,
dot and l2.

Tolerances:
- int8/int4 cosine/dot: scores are exact integer dots followed by the same
  rounded float32 op (plus an exact 0/-inf mask), so values and slots must
  be EQUAL.
- int8/int4 l2: the same, but the XLA CPU build of the Pallas interpreter
  contracts the epilogue's last multiply and add, ``(g * aux) * qs +
  mask``, into one FMA (``test_quantized_l2_epilogue_rounds_each_op``
  shows it), while the port rounds each op, as its CUDA kernel does under
  ``--fmad=false``. So values agree within one rounding of the product and
  the sum, 2^-22 * (|product| + |mask|), slots equal outside near-ties as
  below; and the plain version is held EQUAL to a numpy recomputation
  with each op rounded.
- bfloat16/float32: both sides sum the same exact float32 products (of the
  bfloat16-rounded query, or of TF32-rounded operands: the Pallas kernel is
  given them rounded already, the plain version rounds them itself) in
  another order, so values agree within ``score_error_bound`` (2^-22 *
  (sqrt(d) + 1) * |q| * max|x|), and slots are equal except inside groups
  of values that lie within that bound (near-ties). The f32x3 leg drops
  the small parts' product and rounds the small parts, below 2^-21 of
  each |x_i q_i|, inside the same bound against the Pallas kernel's exact
  float32 products. A control holds the bound tight: inputs truncated to
  TF32 or bfloat16 break it, and so does the TF32 leg against f32x3.

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
from vrod_tpu_torch.convert import to_tensor
from vrod_tpu_torch.ops import cuda_topk
from vrod_tpu_torch.ops import distances as TD

LEGS = [tuple(leg.split("-")) for leg in cuda_topk.LEGS]
_JAX_DTYPE = {"int8": jnp.int8, "int4": "int4", "bf16": jnp.bfloat16,
              "f32": jnp.float32, "f32x3": jnp.float32}

# name, n, dim, batch, k_scan, dead_every, theta0 from K3, offset, ties
CASES = [
    ("floor_offset", 2048, 128, 8, 28, 7, True, 1000, False),
    ("no_floor", 2048, 128, 16, 28, 7, False, 0, False),
    ("k112_dim96", 2048, 96, 8, 112, 5, True, 0, False),
    ("dim30_tail", 1024, 30, 8, 8, 3, False, 17, False),
    ("ties", 1024, 128, 8, 28, 0, True, 0, True),
]


def tf32_np(a):
    """float32 -> TF32, to nearest, ties away from zero (cvt.rna)."""
    bits = np.ascontiguousarray(a, np.float32).view(np.int32)
    return ((bits + 0x1000) & -0x2000).view(np.float32)


def cut_np(a, drop):
    """float32 with its low ``drop`` mantissa bits cleared: rounded toward
    zero (13 bits: TF32 as cvt.rz.tf32 rounds; 16 bits: bfloat16)."""
    bits = np.ascontiguousarray(a, np.float32).view(np.int32)
    return (bits & -(1 << drop)).view(np.float32)


class State:
    """One leg's rows, aux, valid bitmap, kernel-ready query and l2 extras
    as numpy, with both packages' views of them."""

    def __init__(self, rng, n, d, b, leg=("int8", "cosine"), dead_every=0,
                 ties=False, x=None, q=None):
        dtype, self.metric = leg
        self.packed = dtype == "int4"
        self.precision = "exact" if dtype == "f32x3" else "fast"
        self.quant = dtype in ("int8", "int4")
        if x is None:
            x = rng.standard_normal((n, d)).astype(np.float32)
            if ties:
                x[200:260] = x[3]
                x[700:720] = x[900]
        rows, aux = JD.prepare_rows(jnp.asarray(x), metric=self.metric,
                                    dtype=_JAX_DTYPE[dtype])
        self.rows, self.aux = np.array(rows), np.array(aux)
        self.valid = np.ones(n, bool)
        if dead_every:
            self.valid[::dead_every] = False
        if q is None:
            q = rng.standard_normal((b, d)).astype(np.float32)
            if ties:
                q[0] = x[3]
        self.extras = {}
        if self.quant and self.metric == "l2":
            qk, qs = JD.prepare_queries(jnp.asarray(q), metric="l2",
                                        quantize=True, return_scale=True)
            norms = TD.row_norms2(torch.from_numpy(self.rows),
                                  torch.from_numpy(self.aux), self.packed)
            self.extras = dict(row_bias=-norms.numpy(),
                               q_scale=np.array(qs))
        else:
            qk = JD.prepare_queries(jnp.asarray(q), metric=self.metric,
                                    quantize=self.quant)
        self.q = np.array(qk)

    def sliced(self, ns):
        s = object.__new__(State)
        s.__dict__.update(self.__dict__)
        s.rows, s.aux, s.valid = self.rows[:ns], self.aux[:ns], \
            self.valid[:ns]
        if "row_bias" in self.extras:
            s.extras = dict(self.extras, row_bias=self.extras["row_bias"][:ns])
        return s

    def torch_args(self):
        kw = {k: torch.from_numpy(v.copy()) for k, v in self.extras.items()}
        if self.precision != "fast":
            kw["precision"] = self.precision
        return ([to_tensor(a, "cpu") for a in (self.rows, self.aux,
                                                self.valid, self.q)],
                dict(kw, packed=self.packed))

    def jax_args(self):
        rows, q = self.rows, self.q
        kw = {k: jnp.asarray(v) for k, v in self.extras.items()}
        if self.precision != "fast":
            # f32x3 against the Pallas kernel's HIGHEST on float32 inputs.
            kw["precision_name"] = self.precision
        elif rows.dtype == np.float32:
            # The Pallas kernel scores in float32: give it the TF32-rounded
            # operands that the port's float32 leg scores.
            rows, q = tf32_np(rows), tf32_np(q)
        return ([jnp.asarray(a) for a in (rows, self.aux, self.valid, q)],
                dict(kw, packed=self.packed))

    def epilogue_parts(self):
        """int8/int4 l2: float32 g * aux (B, N), qs = 2 * q_scale (B, 1)
        and the mask (N,), numpy."""
        rows = self.rows
        if self.packed:
            rows = TD.unpack_int4_rows(torch.from_numpy(rows)).numpy()
        g = (self.q.astype(np.float64) @ rows.astype(np.float64).T) \
            .astype(np.float32)
        qs = (2.0 * self.extras["q_scale"].astype(np.float32)).reshape(-1, 1)
        mask = np.where(self.valid, self.extras["row_bias"], -np.inf) \
            .astype(np.float32)
        return g * self.aux[None, :], qs, mask

    def bound(self):
        if self.quant and self.metric == "l2":
            ga, qs, mask = self.epilogue_parts()
            live = np.abs((ga * qs)[:, self.valid]) + np.abs(mask[self.valid])
            return (2.0 ** -22 * live.max(axis=1, keepdims=True)) \
                .astype(np.float32)
        args, kw = self.torch_args()
        return cuda_topk.score_error_bound(
            *args, metric=self.metric, precision=self.precision).numpy()


def assert_close(t, j, bound):
    """-inf where the other has -inf, finite values within ``bound``
    (B, 1) of each other (0: equal)."""
    np.testing.assert_array_equal(np.isneginf(t), np.isneginf(j))
    fin = np.isfinite(j)
    err = np.abs(np.where(fin, t, 0.0) - np.where(fin, j, 0.0))
    assert (err <= bound).all(), float((err - bound).max())


def assert_topk_agree(tv, ti, jv, ji, bound):
    """The port's K1 result against the Pallas kernel's, by the rule of
    ``cuda_topk.topk_disagreement``."""
    msg = cuda_topk.topk_disagreement(
        tv, ti, torch.from_numpy(np.asarray(jv)),
        torch.from_numpy(np.asarray(ji)), torch.from_numpy(bound))
    assert msg is None, msg


@pytest.mark.parametrize("case,leg", [
    # The int8 cosine cases keep the bare case name they had before the
    # other legs existed.
    pytest.param(c, leg, id=c[0] if leg == ("int8", "cosine")
                 else f"{c[0]}-{'-'.join(leg)}")
    for c in CASES for leg in LEGS])
def test_fused_topk_plain_matches_pallas(rng, case, leg):
    _, n, d, b, k, dead_every, floor, offset, ties = case
    st = State(rng, n, d, b, leg, dead_every, ties)
    bound = st.bound()
    targs, tkw = st.torch_args()
    jargs, jkw = st.jax_args()
    theta0 = None
    if floor:
        ns, blk = n // 2, 256
        sample = st.sliced(ns)
        sa, skw = sample.jax_args()
        js = j_sampled_submax(*sa, metric=st.metric, block_rows=blk,
                              interpret=True, **skw)
        sa, skw = sample.torch_args()
        ts = cuda_topk.sampled_submax(*sa, metric=st.metric, block_rows=blk,
                                      **skw)
        assert_close(ts.numpy(), np.asarray(js), bound)
        theta0 = TD.threshold_from_submax(ts, k, method="count")
        assert np.isfinite(theta0.numpy()).all()
    jv, ji = j_fused_topk(*jargs, k=k, metric=st.metric, index_offset=offset,
                          interpret=True, theta0=None if theta0 is None
                          else jnp.asarray(theta0.numpy()), **jkw)
    tv, ti = cuda_topk.fused_topk(*targs, k=k, metric=st.metric,
                                  index_offset=offset, theta0=theta0, **tkw)
    assert_topk_agree(tv, ti, jv, ji, bound)
    if floor:
        # The floor is sound: at or below the k-th score of the scan
        # without it.
        fv, _ = cuda_topk.fused_topk(*targs, k=k, metric=st.metric, **tkw)
        assert (theta0[:, 0] <= fv[:, k - 1]).all()
    if ties and st.quant:
        # Query 0 is row 3: its 61 exact copies share the top score and
        # must come out lowest slot first.
        assert ti[0, :k].tolist() == [3] + list(range(200, 200 + k - 1))


@pytest.mark.parametrize("leg", LEGS, ids=[
    # The int8 cosine/dot legs keep their metric as the id, as before the
    # other legs existed.
    m if d == "int8" and m != "l2" else f"{d}-{m}" for d, m in LEGS])
def test_sampled_submax_plain_matches_pallas(rng, leg):
    st = State(rng, 2048, 64, 16, leg, dead_every=4)
    args, kw = st.jax_args()
    js = np.asarray(j_sampled_submax(*args, metric=st.metric, block_rows=512,
                                     interpret=True, **kw))
    args, kw = st.torch_args()
    ts = cuda_topk.sampled_submax_plain(*args, metric=st.metric,
                                        block_rows=512, **kw).numpy()
    assert ts.shape == (16, 4 * 128)
    assert_close(ts, js, st.bound())


@pytest.mark.parametrize("dtype", ["bf16", "f32", "f32x3"])
@pytest.mark.parametrize("metric", ["cosine", "dot", "l2"])
def test_float_legs_ties_lowest_slot_first(rng, dtype, metric):
    """Rows of -1/0/1 and queries of four +-2s (norm 4, so the cosine
    query normalizes to +-0.5): every product and sum is exact in bfloat16,
    TF32 and float32 (the f32x3 leg's small parts are 0), so both packages
    give EQUAL values, and the copies of
    row 7, query 0's best match under every metric, tie exactly and come
    out lowest slot first."""
    x = rng.integers(-1, 2, (512, 16)).astype(np.float32)
    x[7] = 0.0
    x[7, :4] = 2.0
    x[100:140] = x[7]
    q = np.zeros((8, 16), np.float32)
    for row in q:
        row[rng.choice(16, 4, replace=False)] = rng.choice([-2.0, 2.0], 4)
    q[0] = x[7]
    st = State(rng, 512, 16, 8, (dtype, metric), x=x, q=q)
    targs, tkw = st.torch_args()
    jargs, jkw = st.jax_args()
    jv, ji = j_fused_topk(*jargs, k=48, metric=metric, interpret=True,
                          **jkw)
    tv, ti = cuda_topk.fused_topk(*targs, k=48, metric=metric, **tkw)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert ti[0, :40].tolist() == [7] + list(range(100, 139))


CONTROLS = [(d, m, c) for m in ("cosine", "dot", "l2")
            for d, c in (("f32", "tf32-rz"), ("f32", "bf16-rz"),
                         ("bf16", "bf16-rz"), ("f32x3", "tf32-rz"),
                         ("f32x3", "tf32"))]


@pytest.mark.parametrize("dtype,metric,control", CONTROLS,
                         ids=["-".join(c) for c in CONTROLS])
def test_float_bound_rejects_a_truncating_scorer(rng, dtype, metric,
                                                 control):
    """The float legs' bound is tight enough to catch a scorer of lower
    precision: the plain version fed inputs rounded toward zero (what a
    kernel converting with cvt.rz.tf32, or truncating to bfloat16, would
    score: float32 rows and query, or the bfloat16 leg's query) disagrees
    with the plain version beyond ``score_error_bound``; and against the
    f32x3 leg, so does the TF32 leg (control "tf32"), so that leg scores
    at a higher precision than TF32. The Pallas kernel agrees within it
    (``test_fused_topk_plain_matches_pallas``)."""
    st = State(rng, 1024, 768, 16, (dtype, metric))
    args, kw = st.torch_args()
    kw.pop("packed")
    bound = cuda_topk.score_error_bound(*args, metric=metric, **kw)
    want = cuda_topk.fused_topk_plain(*args, k=28, metric=metric, **kw)
    if control == "tf32":
        kw = {}
    else:
        drop = 13 if control == "tf32-rz" else 16
        if dtype != "bf16":
            args[0] = torch.from_numpy(cut_np(st.rows, drop))
        args[3] = torch.from_numpy(cut_np(st.q, drop))
    got = cuda_topk.fused_topk_plain(*args, k=28, metric=metric, **kw)
    assert cuda_topk.topk_disagreement(*got, *want, bound) is not None


@pytest.mark.parametrize("live", [0, 5])
def test_all_dead_and_k_beyond_live(rng, live):
    st = State(rng, 512, 32, 8)
    st.valid[live:] = False
    args, kw = st.jax_args()
    jv, ji = j_fused_topk(*args, k=28, metric="cosine", interpret=True, **kw)
    args, kw = st.torch_args()
    tv, ti = cuda_topk.fused_topk(*args, k=28, metric="cosine", **kw)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert ((ti.numpy() >= 0).sum(axis=1) == live).all()
    assert np.isneginf(tv.numpy()[:, live:]).all()


@pytest.mark.parametrize("dtype", ["int8", "int4"])
def test_quantized_l2_epilogue_rounds_each_op(rng, dtype):
    """The plain K3 equals (g * aux) * qs + mask with each op rounded; the
    Pallas kernel on the CPU equals the same with the last multiply and
    add fused into one FMA (one rounding), the reason the l2 legs compare
    within one rounding above."""
    st = State(rng, 1024, 128, 8, (dtype, "l2"), dead_every=5)
    ga, qs, mask = st.epilogue_parts()
    two = (ga * qs) + mask[None, :]
    fma = (ga.astype(np.float64) * qs + mask[None, :]).astype(np.float32)
    args, kw = st.torch_args()
    ts = cuda_topk.sampled_submax_plain(*args, metric="l2", block_rows=1024,
                                        **kw).numpy()
    np.testing.assert_array_equal(ts, two.reshape(8, 8, 128).max(axis=1))
    args, kw = st.jax_args()
    js = j_sampled_submax(*args, metric="l2", block_rows=1024,
                          interpret=True, **kw)
    np.testing.assert_array_equal(np.asarray(js),
                                  fma.reshape(8, 8, 128).max(axis=1))


def test_plain_float32_leg_rounds_to_tf32(rng):
    """The float32 leg scores TF32-rounded operands (ties away from zero),
    so pre-rounded inputs give bit-identical results."""
    assert tf32_np(np.float32([1 + 2 ** -11, -(1 + 2 ** -11),
                               1 + 2 ** -12])).tolist() == [
        1 + 2 ** -10, -(1 + 2 ** -10), 1.0]
    np.testing.assert_array_equal(
        cuda_topk.tf32_round(torch.tensor([1 + 2 ** -11, 3.0])).numpy(),
        np.float32([1 + 2 ** -10, 3.0]))
    st = State(rng, 1024, 40, 8, ("f32", "dot"))
    args, kw = st.torch_args()
    v, i = cuda_topk.fused_topk_plain(*args, k=16, metric="dot")
    args[0], args[3] = torch.from_numpy(tf32_np(st.rows)), \
        torch.from_numpy(tf32_np(st.q))
    rv, ri = cuda_topk.fused_topk_plain(*args, k=16, metric="dot")
    assert torch.equal(v, rv) and torch.equal(i, ri)


def test_cpu_tensors_take_the_plain_version(rng):
    cuda_topk.reset_launches()
    for leg in (("int8", "dot"), ("int4", "l2"), ("bf16", "cosine"),
                ("f32", "l2"), ("f32x3", "cosine")):
        st = State(rng, 256, 32, 8, leg)
        args, kw = st.torch_args()
        cuda_topk.fused_topk(*args, k=8, metric=st.metric, **kw)
        cuda_topk.sampled_submax(*args, metric=st.metric, block_rows=128,
                                 **kw)
    assert set(cuda_topk.launches) == {
        f"{kern}[{leg}]" for kern in ("fused_topk", "sampled_submax")
        for leg in cuda_topk.LEGS}
    assert not any(cuda_topk.launches.values())


def test_wrappers_validate(rng):
    (rows, aux, valid, q8), _ = State(rng, 256, 32, 8).torch_args()
    with pytest.raises(TypeError, match="int8-quantized"):
        cuda_topk.fused_topk(rows, aux, valid, q8.float(), k=4,
                             metric="cosine")
    with pytest.raises(ValueError, match="metric"):
        cuda_topk.fused_topk(rows, aux, valid, q8, k=4, metric="l1")
    with pytest.raises(ValueError, match="row_bias"):
        cuda_topk.fused_topk(rows, aux, valid, q8, k=4, metric="l2")
    with pytest.raises(ValueError, match="row_bias"):
        cuda_topk.sampled_submax(rows, aux, valid, q8, metric="l2",
                                 block_rows=128, q_scale=torch.ones(8))
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
    with pytest.raises(ValueError, match="query dim"):
        cuda_topk.fused_topk(rows, aux, valid, q8, k=4, metric="cosine",
                             packed=True)


def test_float_query_on_int4_rows_raises(rng):
    """As in the Pallas kernel (pallas_topk.py:181-183): a float query on
    packed int4 rows is refused, never truncated."""
    st = State(rng, 256, 32, 8, ("int4", "dot"))
    (rows, aux, valid, q8), kw = st.torch_args()
    qf = q8.float()
    with pytest.raises(TypeError, match="int4 rows require"):
        cuda_topk.fused_topk(rows, aux, valid, qf, k=4, metric="dot", **kw)
    with pytest.raises(TypeError, match="int4 rows require"):
        cuda_topk.sampled_submax(rows, aux, valid, qf, metric="dot",
                                 block_rows=128, **kw)
    (jrows, jaux, jvalid, _), jkw = st.jax_args()
    with pytest.raises(TypeError, match="int4 rows require"):
        j_fused_topk(jrows, jaux, jvalid, jnp.asarray(qf.numpy()), k=4,
                     metric="dot", interpret=True, **jkw)
