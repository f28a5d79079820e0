"""The extraction experiments on rows that TMA cannot load: the plain
versions of the port's X1-X4 (``cuda_extract.kexp_plain``,
``kexp2_plain``, ``kexp3_plain``, ``kexp5_plain``) against the JAX
experiments' Pallas kernels in interpret mode at dims 30 and 25 (the
ann-benchmarks GloVe-25 width), where no row is a whole number of 16-byte
units: int8 (int8 query), bfloat16, float32 at precision "exact" and at
"high". On the card such rows take each mode's copying build
(``csrc/extract_<mode>_copy.cu``); here the wrappers route by the same
predicate, ``cuda_topk.use_tma``, which the routing test holds.

Tolerances as in ``tests/test_torch_extract.py``: int8 rows score exact
integer dots followed by the same rounded float32 op, so values, slots and
X2's counts are EQUAL; bfloat16 and float32 rows sum their (exact, for
bfloat16) products in another order than XLA, so values agree within
``cuda_topk.score_error_bound`` at the row set's precision and slots
outside near-ties. Every state has dead slots (mask -inf), a nonzero
offset and a row count that is not a multiple of the block.
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
N, BATCH, K, BLOCK, OFFSET = 1100, 8, 16, 256, 1000
# The row sets: (dtype, dim, precision_name).
ROWS = [("int8", 30, "fast"), ("int8", 25, "fast"), ("bf16", 30, "fast"),
        ("bf16", 25, "fast"), ("f32", 25, "exact"), ("f32", 30, "high")]
ROW_IDS = [f"{d}-d{n}-{p}" for d, n, p in ROWS]
METRICS = ("cosine", "dot", "l2")


def _experiment(name):
    spec = importlib.util.spec_from_file_location(
        f"_exp_rows_{name}", EXPERIMENTS / f"{name}.py")
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


_STATES = {}


def state(dtype, dim):
    """Rows, aux, an additive mask with -inf slots, the query and offset as
    numpy (made from a seed), cached per row set."""
    key = (dtype, dim)
    if key not in _STATES:
        rng = np.random.default_rng(dim * 10 + len(dtype))
        if dtype == "int8":
            x = rng.integers(-127, 128, (N, dim)).astype(np.int8)
            aux = rng.uniform(1e-3, 1e-2, N).astype(np.float32)
            q = rng.integers(-127, 128, (BATCH, dim)).astype(np.int8)
        else:
            x = rng.standard_normal((N, dim)).astype(np.float32)
            aux = rng.uniform(0.5, 2.0, N).astype(np.float32)
            q = rng.standard_normal((BATCH, dim)).astype(np.float32)
        mask = np.zeros(N, np.float32)
        mask[::5] = -np.inf
        _STATES[key] = (x, aux.reshape(1, N), mask.reshape(1, N), q,
                        np.array([OFFSET], np.int32))
    return _STATES[key]


def jax_args(dtype, dim):
    x, *rest = (jnp.asarray(a) for a in state(dtype, dim))
    return (x.astype(jnp.bfloat16) if dtype == "bf16" else x, *rest)


def torch_args(dtype, dim):
    x, *rest = (torch.from_numpy(a.copy()) for a in state(dtype, dim))
    return [x.to(torch.bfloat16) if dtype == "bf16" else x, *rest]


def bound(dtype, dim, metric, precision):
    if dtype == "int8":
        return np.zeros((BATCH, 1), np.float32)
    x, aux, mask, q, _ = torch_args(dtype, dim)
    return cuda_topk.score_error_bound(
        x, aux.reshape(N), torch.isfinite(mask.reshape(N)), q,
        metric=metric, precision=precision).numpy()


def assert_agree(got, want, bnd):
    tv, ti = got
    jv, ji = (np.array(w) for w in want)
    if not bnd.any():
        np.testing.assert_array_equal(tv.numpy(), jv)
        np.testing.assert_array_equal(ti.numpy(), ji)
        return
    msg = cuda_topk.topk_disagreement(tv, ti, torch.from_numpy(jv),
                                      torch.from_numpy(ji),
                                      torch.from_numpy(bnd))
    assert msg is None, msg


# X1: each of its three builds (floor, store, gate) on every row set, the
# metric turning with the row set.
KEXP_CASES = [(r, v, METRICS[(i + j) % 3]) for i, r in enumerate(ROWS)
              for j, v in enumerate(("floor", "base", "gate"))]


@pytest.mark.parametrize("rows,variant,metric", KEXP_CASES, ids=[
    f"{ROW_IDS[ROWS.index(r)]}-{v}-{m}" for r, v, m in KEXP_CASES])
def test_kexp_rows_match_jax(kexp, interpret, rows, variant, metric):
    dtype, dim, prec = rows
    kw = dict(k=K, metric=metric, block_rows=BLOCK, precision_name=prec)
    want = kexp["kexp"].make_call(variant, **kw)(*jax_args(dtype, dim))
    got = X.kexp_plain(variant, *torch_args(dtype, dim), **kw)
    assert_agree(got, want, bound(dtype, dim, metric, prec))
    if variant == "floor":
        assert (got[1] == -1).all()
        assert (got[0] == got[0][:, :1]).all()


@pytest.mark.parametrize("rows", ROWS, ids=ROW_IDS)
def test_kexp2_rows_match_jax_with_count(kexp, interpret, rows):
    """X2 at tiles 2 with KEXP_COUNT on: the top-k, and the while-iteration
    count EQUAL to the plain version's closed form."""
    dtype, dim, prec = rows
    metric = METRICS[ROWS.index(rows) % 3]
    interpret(True)
    kw = dict(k=K, metric=metric, block_rows=BLOCK, precision_name=prec)
    jv, ji, jc = kexp["kexp2"].make_call(tiles=2, **kw)(*jax_args(dtype, dim))
    tv, ti, tc = X.kexp2_plain(*torch_args(dtype, dim), tiles=2, count=True,
                               **kw)
    assert_agree((tv, ti), (jv, ji), bound(dtype, dim, metric, prec))
    assert int(tc[0]) == int(np.asarray(jc)[0]) > 0


@pytest.mark.parametrize("rows", ROWS, ids=ROW_IDS)
def test_kexp3_rows_match_jax(kexp, interpret, rows):
    dtype, dim, prec = rows
    metric = METRICS[(ROWS.index(rows) + 1) % 3]
    kw = dict(k=K, metric=metric, block_rows=BLOCK, precision_name=prec)
    want = kexp["kexp3"].make_call(**kw)(*jax_args(dtype, dim))
    assert_agree(X.kexp3_plain(*torch_args(dtype, dim), **kw), want,
                 bound(dtype, dim, metric, prec))


# X4 (cosine only): its variants in turn over the row sets.
KEXP5_CASES = [(r, list(X.KEXP5_VARIANTS)[i % 3])
               for i, r in enumerate(ROWS)]


@pytest.mark.parametrize("rows,variant", KEXP5_CASES, ids=[
    f"{ROW_IDS[ROWS.index(r)]}-{v}" for r, v in KEXP5_CASES])
def test_kexp5_rows_match_jax(kexp, interpret, rows, variant):
    dtype, dim, prec = rows
    kw = dict(k=K, block_rows=BLOCK, precision_name=prec)
    want = kexp["kexp5"].make_call(variant, **kw)(*jax_args(dtype, dim))
    assert_agree(X.kexp5_plain(variant, *torch_args(dtype, dim), **kw),
                 want, bound(dtype, dim, "cosine", prec))


def offset_view(x, shift=8):
    """A contiguous copy of ``x`` whose base lies ``shift`` bytes past a
    16-byte boundary."""
    flat = torch.empty(x.numel() * x.element_size() + shift,
                       dtype=torch.int8)
    view = flat[shift:].view(x.dtype).view(x.shape)
    view.copy_(x)
    return view


def test_unaligned_view_matches_jax(kexp, interpret):
    """int8 dim-128 rows at an 8-byte-offset base, through the wrappers
    (X1's gate and X3): the answers EQUAL the JAX experiments' on the same
    rows."""
    rng = np.random.default_rng(11)
    x = rng.integers(-127, 128, (N, 128)).astype(np.int8)
    _, aux, mask, q, off = state("int8", 30)
    q = rng.integers(-127, 128, (BATCH, 128)).astype(np.int8)
    xt = offset_view(torch.from_numpy(x))
    assert xt.data_ptr() % 16 == 8 and xt.is_contiguous()
    args = [xt] + [torch.from_numpy(a.copy()) for a in (aux, mask, q, off)]
    jargs = tuple(jnp.asarray(a) for a in (x, aux, mask, q, off))
    kw = dict(k=K, metric="dot", block_rows=BLOCK, precision_name="fast")
    assert_agree(X.kexp_call("gate", *args, **kw),
                 kexp["kexp"].make_call("gate", **kw)(*jargs),
                 np.zeros((BATCH, 1), np.float32))
    assert_agree(X.kexp3_call(*args, **kw),
                 kexp["kexp3"].make_call(**kw)(*jargs),
                 np.zeros((BATCH, 1), np.float32))


@pytest.mark.parametrize("dtype,dim,precision,tma", [
    ("int8", 128, "fast", True), ("int8", 30, "fast", False),
    ("int8", 100, "fast", False), ("bf16", 100, "fast", False),
    ("bf16", 128, "fast", True), ("f32", 25, "fast", False),
    ("f32", 25, "exact", False), ("f32", 128, "high", True)])
def test_routing_by_shape(dtype, dim, precision, tma):
    """The build a call takes on the card: TMA for whole 16-byte units at
    aligned bases, the copying producer for every other width and for an
    8-byte-offset view of aligned rows."""
    kind = {"int8": torch.int8, "bf16": torch.bfloat16,
            "f32": torch.float32}[dtype]
    x = torch.zeros((512, dim), dtype=kind)
    q = torch.zeros((4, dim), dtype=torch.int8 if dtype == "int8"
                    else torch.float32)
    rest = (torch.ones((1, 512)), torch.zeros((1, 512)),
            q, torch.zeros(1, dtype=torch.int32))

    def call(rows):
        return X._XCall(rows, *rest, k=4, metric="cosine", block_rows=256,
                        precision_name=precision)
    assert call(x).tma is tma
    assert call(x).row_bytes == dim * x.element_size()
    assert call(offset_view(x)).tma is False
