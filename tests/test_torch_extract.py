"""The plain versions of the port's extraction experiments
(``cuda_extract.kexp_plain``, ``kexp2_plain``, ``kexp3_plain``,
``kexp5_plain``, which the wrappers run on CPU tensors) against the JAX
experiments' Pallas kernels in interpret mode, on the same numpy inputs:

- ``kexp.make_call`` (X1), every variant name;
- ``kexp2.make_call`` (X2), tiles 1, 2 and 4, with ``KEXP_COUNT`` off
  (cnt 0) and on (cnt the while-iteration count, here in closed form);
- ``kexp3.make_call`` (X3);
- ``kexp5.make_call`` (X4), every variant name (cosine only).

The experiments are imported from their files and read ``KEXP_INTERPRET``
and ``KEXP_COUNT`` while they trace, so both are set before each call;
nothing in ``experiments/`` changes. Every state has dead slots (mask
-inf), a nonzero offset and a row count that is not a multiple of the
block, whose tail neither package reads. Tolerances: int8 rows (int8
query) score exact integer dots followed by the same rounded float32 op,
so values, slots and counts are EQUAL; float32 rows at precision "exact"
and "high" (the port's f32x3 leg: three TF32 products, against XLA's full
float32 on the CPU) sum their products in another order than XLA, so
values agree within ``cuda_topk.score_error_bound(precision="exact")``
and slots outside near-ties. The tie states make every score exact, so
there too all is EQUAL.
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vrod_tpu_torch.ops import cuda_extract as X
from vrod_tpu_torch.ops import cuda_topk

EXPERIMENTS = Path(__file__).resolve().parent.parent / "experiments"
N, DIM, BATCH, K, BLOCK, OFFSET = 2348, 128, 8, 16, 512, 1000


def _experiment(name):
    spec = importlib.util.spec_from_file_location(
        f"_exp_{name}", EXPERIMENTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def kexp():
    return {n: _experiment(n) for n in ("kexp", "kexp2", "kexp3", "kexp5")}


@pytest.fixture
def interpret(monkeypatch):
    """Run the experiments in interpret mode; returns a setter of
    KEXP_COUNT."""
    monkeypatch.setenv("KEXP_INTERPRET", "1")
    monkeypatch.delenv("KEXP_COUNT", raising=False)

    def count(on):
        monkeypatch.setenv("KEXP_COUNT", "1" if on else "0")
    return count


class State:
    """Rows of one dtype, aux, an additive mask with -inf slots, the query
    and offset, as numpy, with both packages' views."""

    def __init__(self, seed, dtype, ties=False):
        rng = np.random.default_rng(seed)
        self.dtype = dtype
        if dtype == "int8":
            x = rng.integers(-127, 128, (N, DIM)).astype(np.int8)
            aux = rng.uniform(1e-3, 1e-2, N).astype(np.float32)
            q = rng.integers(-127, 128, (BATCH, DIM)).astype(np.int8)
        elif ties:
            # Small integers: every score is exact in any order.
            x = rng.integers(-1, 2, (N, DIM)).astype(np.float32)
            aux = np.ones(N, np.float32)
            q = rng.integers(-2, 3, (BATCH, DIM)).astype(np.float32)
        else:
            x = rng.standard_normal((N, DIM)).astype(np.float32)
            aux = rng.uniform(0.5, 2.0, N).astype(np.float32)
            q = rng.standard_normal((BATCH, DIM)).astype(np.float32)
        self.copies = []
        if ties:
            # Copies of row 7 (and its aux) spread over every block, and
            # query 0 = row 7: exact ties at the top of query 0, decided by
            # slot across blocks and inside each.
            self.copies = [r for j in range(N // BLOCK)
                           for r in range(j * BLOCK + 100, j * BLOCK + 140)]
            x[self.copies] = x[7]
            aux[self.copies] = aux[7]
            q[0] = x[7]
        mask = np.zeros(N, np.float32)
        mask[::5] = -np.inf
        self.np = (x, aux.reshape(1, N), mask.reshape(1, N), q,
                   np.array([OFFSET], np.int32))

    def jax(self):
        return tuple(jnp.asarray(a) for a in self.np)

    def torch(self):
        return [torch.from_numpy(a.copy()) for a in self.np]

    def bound(self, metric):
        if self.dtype == "int8" or self.copies:
            return np.zeros((BATCH, 1), np.float32)
        x, aux, mask, q, _ = self.torch()
        return cuda_topk.score_error_bound(
            x, aux.reshape(N), torch.isfinite(mask.reshape(N)), q,
            metric=metric, precision=precision(self.dtype)).numpy()


_STATES = {}


def state(dtype, ties=False):
    key = (dtype, ties)
    if key not in _STATES:
        _STATES[key] = State(17 if ties else 5, dtype, ties)
    return _STATES[key]


def precision(dtype, high=False):
    """The experiments' precision_name of a case: float32 rows at "exact"
    (``high``: "high"), the others at "fast"."""
    if dtype != "f32":
        return "fast"
    return "high" if high else "exact"


def assert_agree(got, want, bound):
    tv, ti = got
    jv, ji = (np.array(w) for w in want)
    if not bound.any():
        np.testing.assert_array_equal(tv.numpy(), jv)
        np.testing.assert_array_equal(ti.numpy(), ji)
        return
    msg = cuda_topk.topk_disagreement(tv, ti, torch.from_numpy(jv),
                                      torch.from_numpy(ji),
                                      torch.from_numpy(bound))
    assert msg is None, msg


KEXP_CASES = (
    [("int8", "cosine", v) for v in X.KEXP_VARIANTS]
    + [("int8", m, v) for m in ("dot", "l2") for v in ("floor", "base",
                                                       "gate")]
    + [("f32", "cosine", v) for v in X.KEXP_VARIANTS]
    + [("f32", m, v) for m in ("dot", "l2") for v in ("floor", "base")])
# The same at precision "high": (dtype, metric, variant, "high").
HIGH = "high"
KEXP_CASES = [c + ("",) for c in KEXP_CASES] + [
    ("f32", "cosine", v, HIGH) for v in ("floor", "base", "gate")] + [
    ("f32", m, "gate", HIGH) for m in ("dot", "l2")]


def _ids(cases):
    return ["-".join(str(p) for p in c if p != "") for c in cases]


@pytest.mark.parametrize("dtype,metric,variant,high", KEXP_CASES,
                         ids=_ids(KEXP_CASES))
def test_kexp_plain_matches_jax(kexp, interpret, dtype, metric, variant,
                                high):
    st = state(dtype)
    kw = dict(k=K, metric=metric, block_rows=BLOCK,
              precision_name=precision(dtype, high == HIGH))
    want = kexp["kexp"].make_call(variant, **kw)(*st.jax())
    got = X.kexp_plain(variant, *st.torch(), **kw)
    assert_agree(got, want, st.bound(metric))
    if variant == "floor":
        assert (got[1] == -1).all()
        assert (got[0] == got[0][:, :1]).all()


KEXP2_CASES = ([("int8", "cosine", t, c, "") for t in (1, 2, 4)
                for c in (False, True)]
               + [("f32", "l2", 2, c, "") for c in (False, True)]
               + [("f32", "dot", 2, c, HIGH) for c in (False, True)])


@pytest.mark.parametrize("dtype,metric,tiles,count,high", KEXP2_CASES, ids=[
    f"{d}-{m}-t{t}-{'count' if c else 'nocount'}" + (f"-{h}" if h else "")
    for d, m, t, c, h in KEXP2_CASES])
def test_kexp2_plain_matches_jax(kexp, interpret, dtype, metric, tiles,
                                 count, high):
    st = state(dtype)
    interpret(count)
    kw = dict(k=K, metric=metric, block_rows=BLOCK,
              precision_name=precision(dtype, high == HIGH))
    jv, ji, jc = kexp["kexp2"].make_call(tiles=tiles, **kw)(*st.jax())
    tv, ti, tc = X.kexp2_plain(*st.torch(), tiles=tiles, count=count, **kw)
    assert_agree((tv, ti), (jv, ji), st.bound(metric))
    assert tc.dtype == torch.int32 and tc.shape == (1,)
    assert int(tc[0]) == int(np.asarray(jc)[0])
    assert (int(tc[0]) > 0) == count


KEXP3_CASES = [("int8", "l2", ""), ("int8", "dot", ""),
               ("f32", "cosine", ""), ("f32", "cosine", HIGH),
               ("f32", "l2", HIGH)]


@pytest.mark.parametrize("dtype,metric,high", KEXP3_CASES,
                         ids=_ids(KEXP3_CASES))
def test_kexp3_plain_matches_jax(kexp, interpret, dtype, metric, high):
    st = state(dtype)
    kw = dict(k=K, metric=metric, block_rows=BLOCK,
              precision_name=precision(dtype, high == HIGH))
    want = kexp["kexp3"].make_call(**kw)(*st.jax())
    assert_agree(X.kexp3_plain(*st.torch(), **kw), want, st.bound(metric))


@pytest.mark.parametrize("dtype", ["int8", "f32", "f32-high"])
@pytest.mark.parametrize("variant", list(X.KEXP5_VARIANTS))
def test_kexp5_plain_matches_jax(kexp, interpret, dtype, variant):
    dtype, _, high = dtype.partition("-")
    st = state(dtype)
    kw = dict(k=K, block_rows=BLOCK,
              precision_name=precision(dtype, high == HIGH))
    want = kexp["kexp5"].make_call(variant, **kw)(*st.jax())
    assert_agree(X.kexp5_plain(variant, *st.torch(), **kw), want,
                 st.bound("cosine"))


@pytest.mark.parametrize("dtype", ["int8", "f32"])
@pytest.mark.parametrize("exp", ["kexp2", "kexp3", "kexp5"])
def test_ties_lowest_slot_first_as_jax(kexp, interpret, dtype, exp):
    """Copies of row 7 in every block tie with it at the top of query 0:
    both packages rank them by slot, and kexp2 counts them alike."""
    st = state(dtype, ties=True)
    kw = dict(k=K, block_rows=BLOCK, precision_name=precision(dtype))
    if exp == "kexp2":
        interpret(True)
        jv, ji, jc = kexp["kexp2"].make_call(metric="cosine", tiles=2,
                                             **kw)(*st.jax())
        tv, ti, tc = X.kexp2_plain(*st.torch(), metric="cosine", tiles=2,
                                   count=True, **kw)
        assert int(tc[0]) == int(np.asarray(jc)[0])
        want, got = (jv, ji), (tv, ti)
    elif exp == "kexp3":
        want = kexp["kexp3"].make_call(metric="dot", **kw)(*st.jax())
        got = X.kexp3_plain(*st.torch(), metric="dot", **kw)
    else:
        want = kexp["kexp5"].make_call("unroll4", **kw)(*st.jax())
        got = X.kexp5_plain("unroll4", *st.torch(), **kw)
    assert_agree(got, want, st.bound("cosine"))
    live = [c for c in st.copies if c % 5]  # every 5th slot is dead
    assert got[1][0, :K].tolist() == [7 + OFFSET] + [
        c + OFFSET for c in live[:K - 1]]


def test_whole_blocks_only():
    """Rows after the last whole block are never read: a best row there
    changes nothing, and fewer rows than one block give empty ranks."""
    args = state("int8").torch()
    x = args[0].clone()
    x[N // BLOCK * BLOCK:] = args[3][0]  # query 0's best row, in the tail
    kw = dict(k=K, metric="dot", block_rows=BLOCK, precision_name="fast")
    want = X.kexp_plain("base", *args, **kw)
    got = X.kexp_plain("base", x, *args[1:], **kw)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert int(got[1].max()) < N // BLOCK * BLOCK + OFFSET
    v, i, c = X.kexp2_plain(x[:BLOCK - 1], args[1][:, :BLOCK - 1],
                            args[2][:, :BLOCK - 1], args[3], args[4],
                            count=True, **kw)
    assert torch.isneginf(v).all() and (i == -1).all() and int(c[0]) == 0


def test_bf16_query_rounds_to_nearest_even():
    """bfloat16 rows read the float query as the experiments cast it."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((BLOCK, DIM),
                                             dtype=np.float32))
    q = torch.from_numpy(rng.standard_normal((BATCH, DIM),
                                             dtype=np.float32))
    aux = torch.ones((1, BLOCK))
    mask = torch.zeros((1, BLOCK))
    off = torch.zeros(1, dtype=torch.int32)
    kw = dict(k=K, metric="dot", block_rows=BLOCK, precision_name="fast")
    xb = x.to(torch.bfloat16)
    got = X.kexp3_plain(xb, aux, mask, q, off, **kw)
    want = X.kexp3_plain(xb, aux, mask, q.to(torch.bfloat16), off, **kw)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    ref = (q.to(torch.bfloat16).float() @ xb.float().T).topk(K, dim=1)
    torch.testing.assert_close(got[0], ref.values, rtol=0, atol=0)


def test_wrappers_validate():
    x, aux, mask, q, off = state("int8").torch()
    kw = dict(k=K, block_rows=BLOCK, precision_name="fast")
    with pytest.raises(TypeError, match="int8 query"):
        X.kexp_call("base", x, aux, mask, q.float(), off, metric="cosine",
                    **kw)
    with pytest.raises(ValueError, match="only epilogue is cosine"):
        X.kexp5_call("unroll2", x, aux, mask, q, off, metric="l2", **kw)
    with pytest.raises(TypeError, match="packed int4"):
        X.kexp2_call(x, aux, mask, q, off, metric="dot", packed=True, **kw)
    with pytest.raises(ValueError, match="variant"):
        X.kexp_call("unroll2", x, aux, mask, q, off, metric="dot", **kw)
    with pytest.raises(ValueError, match="multiple of 128"):
        X.kexp3_call(x, aux, mask, q, off, metric="dot", k=K,
                     block_rows=500, precision_name="fast")
    with pytest.raises(ValueError, match="tiles"):
        X.kexp2_call(x, aux, mask, q, off, metric="dot", tiles=3, **kw)
    with pytest.raises(ValueError, match="offset"):
        X.kexp3_call(x, aux, mask, q, off.long(), metric="dot", **kw)
    with pytest.raises(ValueError, match="precision_name"):
        X.kexp3_call(x, aux, mask, q, off, metric="dot", k=K,
                     block_rows=BLOCK, precision_name="highest")
    X.reset_launches()
    X.kexp_call("floor", x, aux, mask, q, off, metric="l2", **kw)
    X.kexp2_call(x, aux, mask, q, off, metric="l2", count=True, **kw)
    X.kexp3_call(x, aux, mask, q, off, metric="l2", **kw)
    X.kexp5_call("unroll4", x, aux, mask, q, off, **kw)
    assert not any(X.launches.values())


def test_kexp_extract_pairs_agree_on_the_cpu():
    """The A/B entry point's pairs (``tools/kexp_extract.py``) at a small
    size on the CPU, where every wrapper runs its plain version: each
    variant returns K1's (values, slots) with no floor, the floor variant
    its plain version, and X2's count its closed form; each pair names the
    build it runs, and together they run every build."""
    spec = importlib.util.spec_from_file_location(
        "_kexp_extract", EXPERIMENTS.parent / "tools" / "kexp_extract.py")
    ke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ke)
    for dtype in ("int8", "bf16"):
        args = ke.make_state(dtype, 4096 + 100, 64, 8, 3,
                             torch.device("cpu"))
        todo = ke.pairs(args, 24, ke.EXPERIMENTS, block_rows=1024)
        assert [(e, v) for e, v, *_ in todo] == [
            ("x1", v) for v in X.KEXP_VARIANTS] + [
            ("x2", "tiles1"), ("x3", "pingpong")] + [
            ("x4", v) for v in X.KEXP5_VARIANTS]
        assert {kern for _, _, kern, *_ in todo} == set(X.KERNELS)
        for exp, variant, kern, ref, fn in todo:
            assert kern == {"x1": X.KEXP_VARIANTS, "x4": X.KEXP5_VARIANTS}.get(
                exp, {"tiles1": "carry", "pingpong": "pingpong"})[variant]
            got, want = fn(), ref()
            assert all(torch.equal(g, w) for g, w in zip(got, want)), \
                (dtype, exp, variant)
        v, i, c = ke.count_of(args, 24, block_rows=1024, tiles=2)
        assert int(c[0]) > 0


@pytest.mark.parametrize("precision,metric", [("high", "cosine"),
                                              ("exact", "dot")])
def test_kexp_extract_pairs_agree_at_f32x3_on_the_cpu(precision, metric):
    """The A/B entry point's pairs on float32 rows at its ``--precision``
    "high"/"exact" (leg f32x3): every variant EQUALS K1 at that precision
    (X4, cosine only, drops out under dot), X2's count its closed form."""
    spec = importlib.util.spec_from_file_location(
        "_kexp_extract", EXPERIMENTS.parent / "tools" / "kexp_extract.py")
    ke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ke)
    args = ke.make_state("f32", 4096 + 100, 64, 8, 3, torch.device("cpu"))
    assert cuda_topk.leg_name(args[0], metric, precision=precision) \
        == f"f32x3-{metric}"
    todo = ke.pairs(args, 24, ke.EXPERIMENTS, block_rows=1024, metric=metric,
                    precision=precision)
    assert [e for e, *_ in todo].count("x4") == (3 if metric == "cosine"
                                                 else 0)
    for exp, variant, kern, ref, fn in todo:
        got, want = fn(), ref()
        assert all(torch.equal(g, w) for g, w in zip(got, want)), \
            (exp, variant)
    v, i, c = ke.count_of(args, 24, block_rows=1024, tiles=2, metric=metric,
                          precision=precision)
    assert int(c[0]) > 0
