"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU with nvcc: they are marked ``cuda`` and
skip where there is none. The file imports no JAX, so a GPU machine without
it runs them with:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Every leg of K1/K3 (int8 and packed int4 rows with an int8 query, bfloat16
and float32 rows with a float query, float32 in TF32 and, as leg f32x3 at
the precision "exact", in three TF32 products; metrics cosine, dot and
l2):
- int8/int4 scores are exact integer dots followed by the same rounded
  float32 ops, so kernel and plain version must be EQUAL: values and
  slots, ties and empty ranks included;
- bfloat16/float32 sums run in another order on the tensor cores, so
  values agree within ``cuda_topk.score_error_bound`` and slots are equal
  outside near-ties (``cuda_topk.topk_disagreement``).

The floor and gate kernels (``cuda_floor``) and the extraction kernels
(``cuda_extract``: X1-X4, on int8, bfloat16 and float32 rows with the
experiments' epilogues) are held to their plain versions by the same
rules, ties across list cuts EXACTLY.
"""

import numpy as np
import pytest
import torch

from vrod_tpu_torch.config import DTYPES, METRICS, CollectionConfig
from vrod_tpu_torch.engine import DeviceEngine
from vrod_tpu_torch.ops import cuda_extract
from vrod_tpu_torch.ops import cuda_floor
from vrod_tpu_torch.ops import cuda_topk
from vrod_tpu_torch.ops import distances as TD

# name, n, dim, batch, k_scan, dead_every, floor from K3, offset, ties
CASES = [
    ("floor_offset", 2048, 128, 8, 28, 7, True, 1000, False),
    ("no_floor", 2048, 128, 16, 28, 7, False, 0, False),
    ("k112_dim96", 2048, 96, 8, 112, 5, True, 0, False),
    ("dim30_tail", 1024, 30, 8, 8, 3, False, 17, False),
    ("ties", 1024, 128, 8, 28, 0, True, 0, True),
    ("dim80_b40", 4096, 80, 40, 28, 5, True, 3, False),
    ("k1280", 4096, 64, 16, 1280, 0, False, 0, False),
    # b256 over 65,536 rows: 512 row tiles, several per persistent block.
    ("b256_n65536", 65536, 128, 256, 28, 7, True, 5, False),
]
_ROW_DTYPE = {"int8": torch.int8, "int4": "int4", "bf16": torch.bfloat16,
              "f32": torch.float32, "f32x3": torch.float32}


def leg_keywords(dtype):
    """The wrappers' keywords of a leg's row dtype: packed int4 rows, and
    float32 at "exact" for the f32x3 leg."""
    kw = dict(packed=dtype == "int4")
    if dtype == "f32x3":
        kw["precision"] = "exact"
    return kw


def bound_of(args, kw, metric):
    return cuda_topk.score_error_bound(
        *args, metric=metric, precision=kw.get("precision", "fast"))


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def make_state(rng, n, d, b, dev, leg, dead_every=0, ties=False):
    """(x, aux, valid, kernel-ready q) on ``dev`` and the wrappers' extra
    keywords for one leg."""
    dtype, metric = leg.split("-")
    x = rng.standard_normal((n, d)).astype(np.float32)
    if ties:
        x[200:260] = x[3]
        x[700:720] = x[900]
    rows, aux = TD.prepare_rows(torch.from_numpy(x), metric=metric,
                                dtype=_ROW_DTYPE[dtype])
    valid = torch.ones(n, dtype=torch.bool)
    if dead_every:
        valid[::dead_every] = False
    q = rng.standard_normal((b, d)).astype(np.float32)
    if ties:
        q[0] = x[3]
    q = torch.from_numpy(q)
    kw = leg_keywords(dtype)
    if dtype in ("int8", "int4") and metric == "l2":
        q, qs = TD.prepare_queries(q, metric=metric, quantize=True,
                                   return_scale=True)
        kw.update(row_bias=-TD.row_norms2(rows, aux, kw["packed"]).to(dev),
                  q_scale=qs.to(dev))
    else:
        q = TD.prepare_queries(q, metric=metric,
                               quantize=dtype in ("int8", "int4"))
    return [t.to(dev) for t in (rows, aux, valid, q)], kw


def sample_of(args, kw, ns):
    skw = dict(kw)
    if "row_bias" in kw:
        skw["row_bias"] = kw["row_bias"][:ns]
    return [a[:ns] for a in args[:3]] + [args[3]], skw


@pytest.mark.cuda
@pytest.mark.parametrize("case,leg", [
    # The int8 cosine cases keep the bare case name they had before the
    # other legs existed.
    pytest.param(c, leg, id=c[0] if leg == "int8-cosine" else f"{c[0]}-{leg}")
    for c in CASES for leg in cuda_topk.LEGS])
def test_cuda_kernels_match_plain(rng, case, leg, cuda_device):
    _, n, d, b, k, dead_every, floor, offset, ties = case
    metric = leg.split("-")[1]
    args, kw = make_state(rng, n, d, b, cuda_device, leg, dead_every, ties)
    bound = bound_of(args, kw, metric)
    sample, skw = sample_of(args, kw, n // 2)
    sub = cuda_topk.sampled_submax(*sample, metric=metric, block_rows=256,
                                   **skw)
    sub_p = cuda_topk.sampled_submax_plain(*sample, metric=metric,
                                           block_rows=256, **skw)
    torch.cuda.synchronize()
    assert torch.equal(torch.isneginf(sub), torch.isneginf(sub_p))
    fin = torch.isfinite(sub_p)
    assert ((sub - sub_p).abs().where(fin, 0.0) <= bound).all()
    # K3 scores with K1's code: its maximum is K1's top-1 on the sample.
    top1, _ = cuda_topk.fused_topk(*sample, k=1, metric=metric, **skw)
    assert torch.equal(top1[:, 0], sub.amax(dim=1))
    theta0 = TD.threshold_from_submax(sub, k, method="count") \
        if floor else None
    v, i = cuda_topk.fused_topk(*args, k=k, metric=metric,
                                index_offset=offset, theta0=theta0, **kw)
    vp, ip = cuda_topk.fused_topk_plain(*args, k=k, metric=metric,
                                        index_offset=offset, theta0=theta0,
                                        **kw)
    torch.cuda.synchronize()
    msg = cuda_topk.topk_disagreement(v, i, vp, ip, bound)
    assert msg is None, msg
    if floor:
        fv, _ = cuda_topk.fused_topk(*args, k=k, metric=metric, **kw)
        assert (theta0[:, 0] <= fv[:, k - 1]).all()
    if ties and leg.split("-")[0] in ("int8", "int4"):
        assert i[0, :k].tolist() == [3 + offset] + list(
            range(200 + offset, 200 + offset + k - 1))


@pytest.mark.cuda
def test_cuda_growth_releases_earlier_capacities(rng, cuda_device):
    """Growing segment by segment, the caching allocator keeps none of the
    earlier capacities reserved: after each growth the engine's device
    holds its state, at most one block that a write staged its float32
    chunk in (the allocator may place the new rows inside it), and little
    more (tools/repl_drill.py at 10M rows reserved 44 GB for 7.7 GB of
    rows before the engine released them; here 1 + ... + 7 old
    capacities would be 1.4 GB)."""
    seg, dim, segments = 65536, 768, 8
    cfg = CollectionConfig(name="grow", dim=dim, metric="cosine",
                           dtype="int8", segment_rows=seg, shards=1)
    torch.cuda.empty_cache()
    base = torch.cuda.memory_reserved(cuda_device)
    eng = DeviceEngine(cfg, device=cuda_device)
    chunk = rng.standard_normal((seg, dim)).astype(np.float32)
    for i in range(segments):
        assert eng.ensure_capacity((i + 1) * seg) == (i > 0)
        state = (i + 1) * seg * (dim + 4 + 1)  # rows, aux, valid
        assert torch.cuda.memory_reserved(cuda_device) - base <= \
            state + chunk.nbytes + (64 << 20), i
        eng.write(np.arange(i * seg, (i + 1) * seg), chunk)
    assert eng.capacity == segments * seg


@pytest.mark.cuda
def test_cuda_engine_matches_cpu_engine(rng, cuda_device):
    """One state, searched by the engine on the CPU (plain versions) and on
    the card (K1, and K3 where the floor gate opens at k 100): the same
    slots; values to rtol 1e-6, since the float32 rescore sums in another
    order on the card."""
    cfg = CollectionConfig(name="g", dim=64, metric="cosine", dtype="int8",
                           segment_rows=131072, shards=1)
    cpu = DeviceEngine(cfg, device="cpu")
    cpu.write(np.arange(131072),
              rng.standard_normal((131072, 64)).astype(np.float32))
    cpu.erase(np.arange(0, 131072, 13))
    gpu = DeviceEngine(cfg, device=cuda_device)
    gpu.load_state(cpu.x, cpu.aux, cpu.valid)
    q = rng.standard_normal((20, 64)).astype(np.float32)
    cuda_topk.reset_launches()
    for k in (16, 100):
        v, i = gpu.search(q, k)
        vc, ic = cpu.search(q, k)
        np.testing.assert_array_equal(i, ic)
        np.testing.assert_allclose(v, vc, rtol=1e-6)
    assert {n: c for n, c in cuda_topk.launches.items() if c} == {
        "fused_topk[int8-cosine]": 2, "sampled_submax[int8-cosine]": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("metric", METRICS)
def test_cuda_engine_launches_k1_for_every_leg(rng, cuda_device, dtype,
                                               metric):
    """Every dtype and metric searches on the card through K1 (no
    ConfigError, no plain version), to the CPU engine's results."""
    cfg = CollectionConfig(name="v", dim=48, metric=metric, dtype=dtype,
                           segment_rows=4096, shards=1)
    cpu = DeviceEngine(cfg, device="cpu")
    cpu.write(np.arange(3000),
              rng.standard_normal((3000, 48)).astype(np.float32))
    cpu.erase(np.arange(0, 3000, 9))
    gpu = DeviceEngine(cfg, device=cuda_device)
    gpu.load_state(cpu.x, cpu.aux, cpu.valid)
    if gpu.has_norms:
        assert torch.equal(gpu.norms.cpu(), cpu.norms)
    q = rng.standard_normal((10, 48)).astype(np.float32)
    cuda_topk.reset_launches()
    v, i = gpu.search(q, 10)
    vc, ic = cpu.search(q, 10)
    np.testing.assert_array_equal(i, ic)
    np.testing.assert_allclose(v, vc, rtol=1e-5, atol=1e-5)
    leg = cuda_topk.leg_name(gpu.x, metric, gpu.packed)
    assert cuda_topk.launches[f"fused_topk[{leg}]"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("precision", ["high", "exact"])
def test_cuda_engine_float32_high_precision_runs_the_f32x3_leg(
        rng, cuda_device, metric, precision):
    """float32 rows at "high"/"exact" search on the card through K1's and
    K3's three-product leg (never the plain scan), with and without the
    rescore, to the CPU engine's slots; the floor opens at k 100."""
    cfg = CollectionConfig(name="x3", dim=64, metric=metric, dtype="float32",
                           segment_rows=131072, shards=1)
    cpu = DeviceEngine(cfg, device="cpu")
    cpu.write(np.arange(131072),
              rng.standard_normal((131072, 64)).astype(np.float32))
    cpu.erase(np.arange(0, 131072, 11))
    gpu = DeviceEngine(cfg, device=cuda_device)
    gpu.load_state(cpu.x, cpu.aux, cpu.valid)
    q = rng.standard_normal((20, 64)).astype(np.float32)
    cuda_topk.reset_launches()
    for rescore in (True, False):
        v, i = gpu.search(q, 100, precision=precision, rescore=rescore)
        vc, ic = cpu.search(q, 100, precision=precision, rescore=rescore)
        np.testing.assert_array_equal(i, ic)
        np.testing.assert_allclose(v, vc, rtol=1e-5, atol=1e-5)
    assert {n: c for n, c in cuda_topk.launches.items() if c} == {
        f"fused_topk[f32x3-{metric}]": 2,
        f"sampled_submax[f32x3-{metric}]": 2}


@pytest.mark.cuda
@pytest.mark.parametrize("leg", cuda_topk.LEGS)
def test_cuda_k1_ties_across_list_cuts(leg, cuda_device):
    """Copies of row 7, 40 in each of the first seven row tiles of K1's
    part 0 (tiles 0, parts, 2 parts, ...), query 0 = row 7, no floor: the
    first four tiles fill query 0's list past k, so the first cut raises
    its gate to the copies' score, and the copies in the later tiles meet
    a gate equal to their score (and lose the tie by slot). Rows of -1/0/1
    and queries of four +-2 make every score exact in any summation order,
    so K1 must EQUAL the plain version on every leg, ties throughout."""
    rng = np.random.default_rng(77)
    b, d, k = 8, 128, 112
    dtype, metric = leg.split("-")
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    _, parts, _ = cuda_topk.topk_plan(8 * cuda_topk.TILE_ROWS * sms, b, k,
                                      sms)
    n = 8 * parts * cuda_topk.TILE_ROWS
    copies = [t * parts * cuda_topk.TILE_ROWS + r for t in range(7)
              for r in range(8, 48)]
    x = rng.integers(-1, 2, (n, d)).astype(np.float32)
    x[7] = 0.0
    x[7, :4] = 2.0
    x[copies] = x[7]
    q = np.zeros((b, d), np.float32)
    for row in q:
        row[rng.choice(d, 4, replace=False)] = rng.choice([-2.0, 2.0], 4)
    q[0] = x[7]
    rows, aux = TD.prepare_rows(torch.from_numpy(x), metric=metric,
                                dtype=_ROW_DTYPE[dtype])
    valid = torch.ones(n, dtype=torch.bool)
    qt = torch.from_numpy(q)
    kw = leg_keywords(dtype)
    if dtype in ("int8", "int4") and metric == "l2":
        qt, qs = TD.prepare_queries(qt, metric=metric, quantize=True,
                                    return_scale=True)
        kw.update(row_bias=-TD.row_norms2(rows, aux, kw["packed"]),
                  q_scale=qs)
    else:
        qt = TD.prepare_queries(qt, metric=metric,
                                quantize=dtype in ("int8", "int4"))
    args = [t.to(cuda_device) for t in (rows, aux, valid, qt)]
    kw = {key: v.to(cuda_device) if torch.is_tensor(v) else v
          for key, v in kw.items()}
    v, i = cuda_topk.fused_topk(*args, k=k, metric=metric, **kw)
    vp, ip = cuda_topk.fused_topk_plain(*args, k=k, metric=metric, **kw)
    torch.cuda.synchronize()
    assert torch.equal(v, vp) and torch.equal(i, ip)
    assert i[0].tolist() == [7] + copies[:k - 1]


# -- The floor and gate kernels (ops/cuda_floor.py) -------------------------

FLOOR_SAMPLES = [(16384, 2), (2048, 8)]  # (block_rows, s_blocks)


@pytest.mark.cuda
@pytest.mark.parametrize("leg", cuda_floor.LEGS)
@pytest.mark.parametrize("k", [28, 112])
@pytest.mark.parametrize("skip,margin", [(False, None), (True, None),
                                         (False, 0.01), (True, 0.01)],
                         ids=["x8", "x8-skip", "x6", "x6-skip"])
def test_cuda_fused_theta_matches_plain(rng, cuda_device, leg, k, skip,
                                        margin):
    """X6/X8 at 65,536 x 768, b256, with dead rows, against the plain
    version (int8/int4 EQUAL, theta0 too; float legs within the bound);
    theta0 bit-equal to bisect_floor of K3's sub-maxima less the margin on
    every leg; and the result EQUAL to K1 without a floor (the floor is
    sound, margin 0 included, because sample and scan score alike)."""
    metric = leg.split("-")[1]
    args, kw = make_state(rng, 65536, 768, 256, cuda_device, leg, 7)
    blk, s_blocks = FLOOR_SAMPLES[k == 112]
    th = dict(k=k, metric=metric, block_rows=blk, s_blocks=s_blocks,
              margin=margin, skip_sample_dots=skip, **kw)
    v, i, t0 = cuda_floor.fused_theta(*args, return_theta=True, **th)
    vp, ip, t0p = cuda_floor.fused_theta_plain(*args, return_theta=True,
                                               **th)
    sample, skw = sample_of(args, kw, blk * s_blocks)
    sub = cuda_topk.sampled_submax(*sample, metric=metric, block_rows=blk,
                                   **skw)
    v0, i0 = cuda_topk.fused_topk(*args, k=k, metric=metric, **kw)
    torch.cuda.synchronize()
    bound = cuda_topk.score_error_bound(*args, metric=metric)
    msg = cuda_topk.topk_disagreement(v, i, vp, ip, bound)
    assert msg is None, msg
    if leg.split("-")[0] in ("int8", "int4"):
        assert torch.equal(t0, t0p)
    assert torch.equal(t0, TD.bisect_floor(sub, k) - (margin or 0.0))
    assert torch.isfinite(t0).all()
    assert torch.equal(v, v0) and torch.equal(i, i0)


@pytest.mark.cuda
@pytest.mark.parametrize("leg", ["int8-cosine", "int8-dot"])
@pytest.mark.parametrize("k", [28, 112])
@pytest.mark.parametrize("floor", [False, True])
def test_cuda_fused_intgate_matches_plain(rng, cuda_device, leg, k, floor):
    """X9 at 65,536 x 768, b256, with dead rows: EQUAL to its plain version
    and to K1 from the same floor."""
    metric = leg.split("-")[1]
    args, _ = make_state(rng, 65536, 768, 256, cuda_device, leg, 7)
    theta0 = None
    if floor:
        sub = cuda_topk.sampled_submax(*[a[:32768] for a in args[:3]],
                                       args[3], metric=metric,
                                       block_rows=16384)
        theta0 = TD.threshold_from_submax(sub, k, method="count")
    v, i = cuda_floor.fused_intgate(*args, k=k, metric=metric, theta0=theta0)
    vp, ip = cuda_floor.fused_intgate_plain(*args, k=k, metric=metric,
                                            theta0=theta0)
    v1, i1 = cuda_topk.fused_topk(*args, k=k, metric=metric, theta0=theta0)
    torch.cuda.synchronize()
    assert torch.equal(v, vp) and torch.equal(i, ip)
    assert torch.equal(v, v1) and torch.equal(i, i1)


def tie_state(leg, dev, b=8, d=128, k=112):
    """The K1 tie case across list cuts (test_cuda_k1_ties_across_list_cuts)
    as kernel inputs: (args, kw, copies)."""
    rng = np.random.default_rng(77)
    dtype, metric = leg.split("-")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    _, parts, _ = cuda_topk.topk_plan(8 * cuda_topk.TILE_ROWS * sms, b, k,
                                      sms)
    n = 8 * parts * cuda_topk.TILE_ROWS
    copies = [t * parts * cuda_topk.TILE_ROWS + r for t in range(7)
              for r in range(8, 48)]
    x = rng.integers(-1, 2, (n, d)).astype(np.float32)
    x[7] = 0.0
    x[7, :4] = 2.0
    x[copies] = x[7]
    q = np.zeros((b, d), np.float32)
    for row in q:
        row[rng.choice(d, 4, replace=False)] = rng.choice([-2.0, 2.0], 4)
    q[0] = x[7]
    rows, aux = TD.prepare_rows(torch.from_numpy(x), metric=metric,
                                dtype=_ROW_DTYPE[dtype])
    qt = TD.prepare_queries(torch.from_numpy(q), metric=metric,
                            quantize=dtype in ("int8", "int4"))
    kw = dict(packed=dtype == "int4")
    if dtype in ("int8", "int4") and metric == "l2":
        qt, qs = TD.prepare_queries(torch.from_numpy(q), metric=metric,
                                    quantize=True, return_scale=True)
        kw.update(row_bias=-TD.row_norms2(rows, aux, kw["packed"]).to(dev),
                  q_scale=qs.to(dev))
    args = [t.to(dev) for t in (rows, aux, torch.ones(n, dtype=torch.bool),
                                qt)]
    return args, kw, copies


@pytest.mark.cuda
@pytest.mark.parametrize("leg", cuda_floor.LEGS)
def test_cuda_fused_theta_ties_across_list_cuts(leg, cuda_device):
    """K1's tie case across list cuts through fused_theta (skip on, the
    sample's tiles revisited) and, on the int8 legs, fused_intgate: every
    score is exact, so both EQUAL the plain version, copies of row 7
    lowest slot first."""
    k = 112
    args, kw, copies = tie_state(leg, cuda_device)
    metric = leg.split("-")[1]
    th = dict(k=k, metric=metric, block_rows=1024, s_blocks=2,
              skip_sample_dots=True, **kw)
    got = cuda_floor.fused_theta(*args, **th)
    want = cuda_floor.fused_theta_plain(*args, **th)
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert got[1][0].tolist() == [7] + copies[:k - 1]
    if leg in cuda_floor.INTGATE_LEGS:
        v, i = cuda_floor.fused_intgate(*args, k=k, metric=metric)
        vp, ip = cuda_topk.fused_topk_plain(*args, k=k, metric=metric)
        torch.cuda.synchronize()
        assert torch.equal(v, vp) and torch.equal(i, ip)


@pytest.mark.cuda
def test_cuda_fused_theta_refuses_a_grid_that_is_not_co_resident(
        rng, cuda_device):
    """More query groups than SMs: the cooperative grid cannot be resident
    at once, and the launch raises instead of hanging."""
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    args, kw = make_state(rng, 4096, 64, 256 * (sms + 1), cuda_device,
                          "int8-cosine")
    with pytest.raises(RuntimeError, match="co-resident"):
        cuda_floor.fused_theta(*args, k=8, metric="cosine", block_rows=512,
                               s_blocks=1, **kw)


# -- The extraction experiments (ops/cuda_extract.py) -----------------------

X_KERNELS = list(cuda_extract.KERNELS)
# name, n (not a multiple of the block), dim, batch, k, block_rows, offset
X_CASES = [("small", 8492, 128, 40, 28, 1024, 1000),
           ("b264_k112", 65636, 96, 264, 112, 2048, 7)]
_X_ROW = {"int8": torch.int8, "bf16": torch.bfloat16, "f32": torch.float32}


def x_args(rng, n, d, b, dev, dtype, offset, dead_every=5, x=None, q=None):
    """The experiments' inputs (x, aux2d, mask2d, q, offset) on ``dev``:
    rows of one dtype (int8 quantized, with an int8 query), positive aux,
    -inf on every ``dead_every``-th slot."""
    if x is None:
        x = rng.standard_normal((n, d)).astype(np.float32)
        q = rng.standard_normal((b, d)).astype(np.float32)
    xt = torch.from_numpy(x)
    qt = torch.from_numpy(q)
    if dtype == "int8":
        xt, _ = TD.prepare_rows(xt, metric="cosine", dtype=torch.int8)
        qt = TD.prepare_queries(qt, metric="cosine", quantize=True)
    else:
        xt = xt.to(_X_ROW[dtype])
    aux = torch.from_numpy(rng.uniform(0.5, 2.0, n).astype(np.float32))
    mask = torch.zeros(n)
    if dead_every:
        mask[::dead_every] = float("-inf")
    off = torch.tensor([offset], dtype=torch.int32)
    return [t.to(dev) for t in (xt, aux.reshape(1, n), mask.reshape(1, n),
                                qt, off)]


def x_agree(dtype, metric, args, got, want):
    if dtype == "int8":
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        return
    n = args[0].shape[0]
    bound = cuda_topk.score_error_bound(
        args[0], args[1].reshape(n), torch.isfinite(args[2].reshape(n)),
        args[3], metric=metric)
    msg = cuda_topk.topk_disagreement(*got, *want, bound)
    assert msg is None, msg


@pytest.mark.cuda
@pytest.mark.parametrize("case", X_CASES, ids=[c[0] for c in X_CASES])
@pytest.mark.parametrize("mode,leg", [
    (kern, leg) for kern in X_KERNELS
    for leg in cuda_extract.kernel_legs(kern)])
def test_cuda_extract_matches_plain(rng, cuda_device, case, mode, leg):
    """Every kernel on every leg it takes, against its plain twin: int8
    EQUAL, bfloat16/float32 within the score bound; the floor's ids -1."""
    _, n, d, b, k, blk, offset = case
    dtype, metric = leg.split("-")
    args = x_args(rng, n, d, b, cuda_device, dtype, offset)
    kw = dict(k=k, metric=metric, block_rows=blk, precision_name="fast")
    cuda_extract.reset_launches()
    got = cuda_extract.run_kernel(mode, *args, **kw)
    want = cuda_extract.run_kernel(mode, *args, plain=True, **kw)
    torch.cuda.synchronize()
    assert cuda_extract.launches[f"extract_{mode}[{leg}]"] == 1
    assert got[0].shape == (b, k) and got[1].dtype == torch.int32
    x_agree(dtype, metric, args, got, want)
    if mode == "floor":
        assert (got[1] == -1).all()
    else:
        assert int(got[1].max()) < n // blk * blk + offset


@pytest.mark.cuda
@pytest.mark.parametrize("k", [28, 112])
@pytest.mark.parametrize("mode", [k for k in X_KERNELS if k != "floor"])
@pytest.mark.parametrize("dtype", ["int8", "bf16", "f32"])
def test_cuda_extract_ties_across_list_cuts(cuda_device, mode, dtype, k):
    """Copies of row 7, 40 in each of the first seven row tiles of part 0,
    query 0 = row 7 (K1's tie case, test_cuda_k1_ties_across_list_cuts):
    the copies meet gates and carries that earlier copies raised to their
    score. Rows of -1/0/1 and queries of four +-2 under dot make every
    score exact, so each mode EQUALS its plain twin, lowest slot first. At
    k 28 X2's carry lies in shared memory, at k 112 in global memory."""
    rng = np.random.default_rng(78)
    b, d = 8, 128
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    _, parts, _, _, _ = cuda_extract.extract_plan(
        mode, 8 * cuda_topk.TILE_ROWS * sms, b, k, sms)
    n = 8 * parts * cuda_topk.TILE_ROWS
    copies = [t * parts * cuda_topk.TILE_ROWS + r for t in range(7)
              for r in range(8, 48)]
    x = rng.integers(-1, 2, (n, d)).astype(np.float32)
    x[7] = 0.0
    x[7, :4] = 2.0
    x[copies] = x[7]
    q = np.zeros((b, d), np.float32)
    for row in q:
        row[rng.choice(d, 4, replace=False)] = rng.choice([-2.0, 2.0], 4)
    q[0] = x[7]
    args = x_args(rng, n, d, b, cuda_device, "f32", 0, dead_every=0, x=x,
                  q=q)
    if dtype == "int8":
        args[0] = args[0].to(torch.int8)
        args[3] = args[3].to(torch.int8)
    else:
        args[0] = args[0].to(_X_ROW[dtype])
    metric = "cosine" if mode.startswith("unroll") else "dot"
    if metric == "cosine":
        args[1] = torch.ones_like(args[1])
    kw = dict(k=k, metric=metric, block_rows=2 * cuda_topk.TILE_ROWS,
              precision_name="fast")
    got = cuda_extract.run_kernel(mode, *args, **kw)
    want = cuda_extract.run_kernel(mode, *args, plain=True, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert got[1][0].tolist() == [7] + copies[:k - 1]


@pytest.mark.cuda
@pytest.mark.parametrize("blk", [512, 2048])
@pytest.mark.parametrize("k", [28, 112])
def test_cuda_kexp2_count_matches_closed_form(rng, cuda_device, blk, k):
    """X2's count (one part per query group, the carry read after every
    block) EQUALS the plain version's closed form at tiles 1, 2 and 4, on
    int8 rows (exact scores) with dead slots; its top-k equals the timed
    (count off) run's."""
    args = x_args(rng, 65536 + 300, 128, 40, cuda_device, "int8", 11)
    kw = dict(k=k, metric="cosine", block_rows=blk, precision_name="fast")
    v0, i0, c0 = cuda_extract.kexp2_call(*args, **kw)
    assert int(c0[0]) == 0
    for tiles in (1, 2, 4):
        v, i, c = cuda_extract.kexp2_call(*args, tiles=tiles, count=True,
                                          **kw)
        vp, ip, cp = cuda_extract.kexp2_plain(*args, tiles=tiles,
                                              count=True, **kw)
        torch.cuda.synchronize()
        assert torch.equal(v, vp) and torch.equal(i, ip)
        assert torch.equal(v, v0) and torch.equal(i, i0)
        assert int(c[0]) == int(cp[0]) > 0


@pytest.mark.cuda
def test_cuda_extract_refuses_what_it_cannot_score(rng, cuda_device):
    """float32 rows at precision high/exact raise on the card (no exact
    scorer; TF32 never stands in), and so do rows TMA cannot load."""
    args = x_args(rng, 2048, 128, 8, cuda_device, "f32", 0)
    for prec in ("high", "exact"):
        with pytest.raises(ValueError, match="no exact scorer"):
            cuda_extract.kexp3_call(*args, k=8, metric="dot", block_rows=1024,
                                    precision_name=prec)
    args = x_args(rng, 2048, 30, 8, cuda_device, "int8", 0)
    with pytest.raises(ValueError, match="TMA"):
        cuda_extract.kexp_call("gate", *args, k=8, metric="dot",
                               block_rows=1024, precision_name="fast")



@pytest.mark.cuda
@pytest.mark.parametrize("dtype,metric", [("int8", "cosine"),
                                          ("int8", "l2"),
                                          ("bfloat16", "cosine")])
def test_cuda_tensor_query_stays_on_the_card(rng, cuda_device, dtype,
                                             metric):
    """A CUDA tensor as the query with ``as_numpy=False``: CUDA tensors
    out, equal to the numpy path's answer on the same engine, for the
    kernels and for the plain scan."""
    cfg = CollectionConfig(name="t", dim=64, metric=metric, dtype=dtype,
                           segment_rows=4096)
    eng = DeviceEngine(cfg, device=cuda_device)
    eng.write(np.arange(4096),
              rng.standard_normal((4096, 64)).astype(np.float32))
    eng.erase(np.arange(0, 4096, 7))
    q = rng.standard_normal((12, 64)).astype(np.float32)
    for kw in ({}, {"impl": "scan", "precision": "exact"},
               {"rescore": False}, {"margin": 40}):
        want_v, want_i = eng.search(q, 16, **kw)
        v, i = eng.search(torch.from_numpy(q).to(cuda_device), 16,
                          as_numpy=False, **kw)
        assert v.is_cuda and i.is_cuda, kw
        np.testing.assert_array_equal(i.cpu().numpy(), want_i, err_msg=str(kw))
        np.testing.assert_array_equal(v.cpu().numpy(), want_v, err_msg=str(kw))


# -- row sharding on the card ------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
def test_cuda_four_shards_answer_as_one(rng, cuda_device, dtype):
    """A 4-shard engine on cuda:0 (262,144 x 768 rows a shard) answers as
    the one-shard engine on the same rows: int8 ids and values EQUAL;
    bfloat16 values within ``score_error_bound`` and ids equal outside
    near-ties (``topk_disagreement``). K1 launches once a shard a search,
    and K3 once a shard where the floor's gate opens at 262,144 rows."""
    import dataclasses
    from vrod_tpu_torch.engine import FloorSettings, floor_gate
    n, d, chunk = 4 * 262144, 768, 131072
    cfg = CollectionConfig(name="s4", dim=d, metric="cosine", dtype=dtype,
                           shards=4)
    four = DeviceEngine(cfg, devices=[cuda_device] * 4)
    one = DeviceEngine(dataclasses.replace(cfg, shards=1),
                       device=cuda_device)
    for e in (four, one):
        e.ensure_capacity(n)
    assert four.shards == 4 and four.rows_local == 262144
    assert four.capacity == one.capacity == n
    for lo in range(0, n, chunk):
        v = rng.standard_normal((chunk, d), dtype=np.float32)
        for e in (four, one):
            e.write(np.arange(lo, lo + chunk), v)
    for e in (four, one):
        e.erase(np.arange(0, n, 11))
    q = rng.standard_normal((256, d)).astype(np.float32)
    leg = cuda_topk.leg_name(one.x, "cosine")
    qp = TD.prepare_queries(torch.from_numpy(q).to(cuda_device),
                            metric="cosine")
    bound = cuda_topk.score_error_bound(one.x, one.aux, one.valid, qp,
                                        metric="cosine")
    for k in (16, 100):
        k_scan = four.scan_widths(k)[1]
        opens = floor_gate(four.rows_local, k_scan, d, four.dtype.itemsize,
                           four.quant, FloorSettings.from_env())[0]
        cuda_topk.reset_launches()
        v4, i4 = four.search(q, k)
        assert cuda_topk.launches[f"fused_topk[{leg}]"] == 4
        assert cuda_topk.launches[f"sampled_submax[{leg}]"] == 4 * opens
        v1, i1 = one.search(q, k)
        if dtype == "int8":
            np.testing.assert_array_equal(i4, i1)
            np.testing.assert_array_equal(v4, v1)
        else:
            assert cuda_topk.topk_disagreement(v4, i4, v1, i1, bound) \
                is None


_TWO_RANKS = r'''
import os, sys
rank, port = int(sys.argv[1]), sys.argv[2]
os.environ.update(VROD_COORDINATOR=f"127.0.0.1:{port}",
                  VROD_NUM_PROCESSES="2", VROD_PROCESS_ID=str(rank))
import numpy as np
import torch
from vrod_tpu_torch.config import CollectionConfig
from vrod_tpu_torch.engine import DeviceEngine
from vrod_tpu_torch.ops import cuda_topk
from vrod_tpu_torch.parallel import distributed
distributed.initialize(device="cuda:0")
assert distributed.backend() == "gloo"   # two ranks share one card
devices = distributed.global_devices(["cuda:0"] * 2)
cfg = CollectionConfig(name="r", dim=128, metric="cosine", dtype="int8",
                       segment_rows=16384, shards=4)
eng = DeviceEngine(cfg, devices=devices)
ref = DeviceEngine(CollectionConfig(name="ref", dim=128, metric="cosine",
                                    dtype="int8", segment_rows=65536),
                   device="cuda:0")
assert eng.multiprocess and eng.capacity == ref.capacity == 65536
rng = np.random.default_rng(5)
v = rng.standard_normal((65536, 128)).astype(np.float32)
for e in (eng, ref):
    e.write(np.arange(65536), v)
    e.erase(np.arange(0, 65536, 7))
q = rng.standard_normal((64, 128)).astype(np.float32)
cuda_topk.reset_launches()
got = eng.search(q, 16)
assert cuda_topk.launches["fused_topk[int8-cosine]"] == 2
want = ref.search(q, 16)
np.testing.assert_array_equal(got[1], want[1])
np.testing.assert_array_equal(got[0], want[0])
print(f"RANK{rank}_OK", flush=True)
'''


@pytest.mark.cuda
def test_cuda_two_ranks_share_one_card_over_gloo(tmp_path, cuda_device):
    """Two processes on one card, 2 shards each: the backend rule picks
    gloo (NCCL refuses a shared card), and the 4-shard search equals the
    one-shard engine's on both ranks. Each rank has its own timeout."""
    import os
    import socket
    import subprocess
    import sys
    from pathlib import Path
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    script = tmp_path / "rank.py"
    script.write_text(_TWO_RANKS)
    repo = Path(__file__).resolve().parent.parent
    env = dict(os.environ, PYTHONPATH=str(repo))
    procs = [subprocess.Popen([sys.executable, str(script), str(r),
                               str(port)], cwd=repo, env=env, text=True,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for r in range(2)]
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"RANK{r}_OK" in out, out[-3000:]
        assert "backend gloo" in out, out[-3000:]


# -- filtered search and REINDEX on the card -------------------------------


@pytest.mark.cuda
def test_cuda_filtered_search_then_reindex_matches_cpu(rng, cuda_device,
                                                       tmp_path):
    """A small int8 cosine collection on cuda:0 and the same rows on the
    port's CPU path: a ``within_ids`` and an ``exclude_ids`` search, then a
    delete of a third of the rows and REINDEX (rows move, the capacity
    shrinks), then the filtered searches again. Every answer on the card
    has the CPU path's ids, and its scores within 1e-5 (the card's float32
    rescore sums in another order)."""
    from vrod_tpu_torch.collection import Collection
    n, d, k = 6144, 64, 10
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((16, d)).astype(np.float32)
    cols = []
    for dev in (cuda_device, torch.device("cpu")):
        cfg = CollectionConfig(name="fr", dim=d, metric="cosine",
                               dtype="int8", segment_rows=1024)
        col = Collection.create(tmp_path / f"c{len(cols)}", cfg,
                                device=dev)
        col.bulk_insert(vecs)
        cols.append(col)
    ids = np.arange(1, n + 1)
    within = rng.choice(ids, 1500, replace=False)
    exclude = rng.choice(ids, 1500, replace=False)
    gone = rng.choice(ids, n // 3, replace=False)

    def answers(col):
        out = []
        for kw in ({"within_ids": within}, {"exclude_ids": exclude}):
            hits = col.search_similar(q, k, **kw)
            out.append((np.array([[h.record_id for h in hs] for hs in hits]),
                        np.array([[h.score for h in hs] for hs in hits])))
        return out

    def same(a, b):
        for (ia, sa), (ib, sb) in zip(a, b):
            np.testing.assert_array_equal(ia, ib)
            np.testing.assert_allclose(sa, sb, rtol=0, atol=1e-5)

    same(*[answers(c) for c in cols])
    caps = []
    for col in cols:
        col.delete_many(gone)
        cap = col.engine.capacity
        assert col.reindex() > 0
        caps.append((cap, col.engine.capacity))
    assert caps[0] == caps[1] and caps[0][1] < caps[0][0], caps
    after = [answers(c) for c in cols]
    same(*after)
    gone_set = set(gone.tolist())
    for ia, _ in after[0]:
        assert not gone_set & set(ia.ravel().tolist())
    for col in cols:
        col.close()
