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

The floor and gate kernels (``cuda_floor``: X6/X8 on every leg of K1,
f32x3 included) and the extraction kernels (``cuda_extract``: X1-X4, on
int8, bfloat16 and float32 rows with the experiments' epilogues, float32
in TF32 at precision "fast" and as leg f32x3 at "high" and "exact") are
held to their plain versions by the same rules, ties across list cuts
EXACTLY.
"""

import ctypes

import numpy as np
import pytest
import torch

from vrod_tpu_torch.config import DTYPES, METRICS, CollectionConfig
from vrod_tpu_torch.engine import DeviceEngine
from vrod_tpu_torch.ops import _build
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


def tie_tiles(k, cap):
    """Row tiles of part 0 that hold copies of row 7 (40 each) in the ties
    case across list cuts: every tile appends its copies while the k-th is
    below their score, so after ceil(k / 40) tiles k copies are listed, and
    a list of cap places is cut at least every ceil((cap - k) / 40) tiles;
    by then a cut has raised the k-th to the copies' score, and the copies
    in the two tiles after meet a k-th equal to theirs."""
    return -(-k // 40) + -(-(cap - k) // 40) + 2


def floor_tie_tiles(k):
    """Row tiles of part 0 that hold copies of row 7 in the ties case
    across the cuts of the scan from a floor below every score: every row
    passes, so each FLOOR_CUT_TILES tiles fill a list past its limit and
    are cut; the first cut after k copies raises the gate to their score,
    and the copies in the three tiles after meet a gate equal to theirs."""
    every = cuda_topk.FLOOR_CUT_TILES
    return every * -(-k // (40 * every)) + 3


def tie_rows(dev, b, k, floor=False):
    """(n, copies) of the ties case across K1's list cuts for b queries at
    top-k: part 0 walks tiles 0, parts, 2 parts, ... (``topk_plan``, or
    ``floor_plan`` from a floor), its first ``tie_tiles`` (or
    ``floor_tie_tiles``) hold the copies at rows 8..47."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    if floor:
        parts = cuda_topk.floor_plan(1 << 30, b, k, sms).parts
        tiles = floor_tie_tiles(k)
    else:
        plan = cuda_topk.topk_plan(1 << 30, b, k, sms)
        parts = plan.parts
        tiles = tie_tiles(k, plan.cap)
    copies = [t * parts * cuda_topk.TILE_ROWS + r for t in range(tiles)
              for r in range(8, 48)]
    return (tiles + 1) * parts * cuda_topk.TILE_ROWS, copies


def floor_tie_placement(dev, b, k, placement):
    """(n, copies) of the ties cases of the scan from a floor below every
    score (every row passes, so each FLOOR_CUT_TILES tiles of part 0 fill
    a list past its limit and are cut) with copies of row 7 in both
    consumer warpgroups' halves of a tile (rows 0-63 and 64-127), in part
    0's tiles 0, parts, 2 parts, ...: "halves", rows 8..127 of its first
    tile (at k 112 the k-th copy falls in the second half, at k 28 every
    copy of the second half loses its tie); "cut", on both sides of the
    first cut point: k - 10 copies around the halves' border of the first
    tile, 20 at the start of the second half of the fourth (the last
    before the cut) and 40 at the start of each half of the fifth (the
    first after). The k-th copy is among the fourth tile's, so a cut that
    saw the fifth tile's first half before the fourth tile's second half
    was tested would keep later slots."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    parts = cuda_topk.floor_plan(1 << 30, b, k, sms).parts

    def rows(t, r):
        return [t * parts * cuda_topk.TILE_ROWS + i for i in r]

    if placement == "halves":
        copies = rows(0, range(8, 128))
    else:
        h = (k - 10) // 2
        copies = (rows(0, range(64 - h, 54 + k - h)) + rows(3, range(64, 84))
                  + rows(4, range(8, 48)) + rows(4, range(64, 104)))
    return 7 * parts * cuda_topk.TILE_ROWS, copies


def check_k1_ties(leg, dev, k, n, copies, floor, d=128, lib=None):
    """K1 at top-k on n rows of -1/0/1 (dim d, b 8) with copies of row 7
    (four 2s) at the slots ``copies``, query 0 = row 7, other queries four
    +-2s, so every score is exact in any summation order: K1 (from a floor
    of -1e30 below every score, or none; by ``fused_topk``, or launched
    from kernel library ``lib``) EQUALS the plain version on every leg,
    and query 0's top-k is row 7 and then the copies, lowest slot first."""
    rng = np.random.default_rng(77)
    b = 8
    dtype, metric = leg.split("-")
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
    args = [t.to(dev) for t in (rows, aux, valid, qt)]
    kw = {key: v.to(dev) if torch.is_tensor(v) else v
          for key, v in kw.items()}
    if floor:
        kw["theta0"] = torch.full((b,), -1e30, device=dev)
    before = cuda_topk.floor_scans[leg]
    if lib is None:
        v, i = cuda_topk.fused_topk(*args, k=k, metric=metric, **kw)
    else:
        call = cuda_topk._Call(*args, metric, kw.get("row_bias"),
                               kw.get("q_scale"), kw["packed"],
                               kw.get("precision", "fast"))
        v, i = cuda_topk._topk_cuda(lib, call, k, 0, kw.get("theta0"))
    vp, ip = cuda_topk.fused_topk_plain(*args, k=k, metric=metric, **kw)
    torch.cuda.synchronize()
    assert cuda_topk.floor_scans[leg] - before == int(floor)
    assert torch.equal(v, vp) and torch.equal(i, ip)
    assert i[0].tolist() == [7] + copies[:k - 1]


@pytest.mark.cuda
@pytest.mark.parametrize("leg", cuda_topk.LEGS)
@pytest.mark.parametrize("k", [112, 300])
@pytest.mark.parametrize("floor", [False, True])
def test_cuda_k1_ties_across_list_cuts(leg, cuda_device, k, floor):
    """Copies of row 7, 40 in each of the first row tiles of K1's part 0
    (tiles 0, parts, 2 parts, ...: ``tie_rows``), query 0 = row 7: the
    copies fill query 0's list past k, so a cut raises its gate to the
    copies' score, and the copies in the later tiles meet a gate equal to
    their score (and lose the tie by slot). No floor: the gated core, k 112
    with the lists on chip, 300 in global memory; a floor of -1e30 (below
    every score): the scan from a floor, at both k (``check_k1_ties``)."""
    n, copies = tie_rows(cuda_device, 8, k, floor)
    check_k1_ties(leg, cuda_device, k, n, copies, floor)


def floor_lib(defines):
    """The scan from a floor built from ``csrc/fused_topk_floor.cu`` alone
    with ``defines`` (the library's flags besides), its entry bound."""
    return _build.bind_floor(ctypes.CDLL(str(
        _build.build(defines, ("fused_topk_floor.cu",)))))


# The scan from a floor's schedules: (row dim, build defines, copying).
# At dim 128 int8 and bf16 rows (128 and 256 bytes) load by TMA, where the
# build's two consumer warpgroups run in lockstep, or in turns with
# VROD_PROBE_PINGPONG (tools/kernel_probe.py's switch); at dim 100 (100
# and 200 bytes) TMA cannot load them, and the copying build takes turns.
FLOOR_SCHEDULES = {"tma-lockstep": (128, (), False),
                   "tma-pingpong": (128, ("VROD_PROBE_PINGPONG",), False),
                   "copying-pingpong": (100, (), True)}


@pytest.mark.cuda
@pytest.mark.parametrize("leg", ["int8-cosine", "bf16-cosine"])
@pytest.mark.parametrize("k", [28, 112])
@pytest.mark.parametrize("placement", ["halves", "cut"])
@pytest.mark.parametrize("schedule", list(FLOOR_SCHEDULES))
def test_cuda_floor_ties_across_warpgroups_and_cuts(leg, cuda_device, k,
                                                    placement, schedule):
    """The scan from a floor, whose two consumer warpgroups (tile rows 0-63
    and 64-127) test a tile together, or in turns half a tile apart, and
    cut only where both have tested the same tiles: copies of row 7 in
    both halves of one tile, and on both sides of a cut point
    (``floor_tie_placement``), EQUAL to the plain version, lowest slot
    first (``check_k1_ties``), in each schedule (``FLOOR_SCHEDULES``; the
    build of csrc/fused_topk_floor.cu alone), the copying build's launches
    counted as such (``copy_launches``)."""
    d, defines, copying = FLOOR_SCHEDULES[schedule]
    n, copies = floor_tie_placement(cuda_device, 8, k, placement)
    before = cuda_topk.copy_launches[f"fused_topk[{leg}]"]
    check_k1_ties(leg, cuda_device, k, n, copies, True, d,
                  floor_lib(defines))
    assert cuda_topk.copy_launches[f"fused_topk[{leg}]"] - before == \
        int(copying)


# K1 at every k the lists take: 1, 16, 28, 112, 136, the largest k whose
# lists fit on chip (topk_layout: 258, beside a ring of 3) and the next.
K1_EDGE = max(k for k in range(1, 1281)
              if cuda_topk.topk_layout(k).on_chip)
K1_KS = [1, 16, 28, 112, 136, K1_EDGE, K1_EDGE + 1]


@pytest.mark.cuda
@pytest.mark.parametrize("leg", cuda_topk.LEGS)
@pytest.mark.parametrize("floor", [False, True])
@pytest.mark.parametrize("d", [768, 30])
def test_cuda_k1_every_k_matches_plain(rng, cuda_device, leg, floor, d):
    """K1's long scan at 69,632 rows (past the small scan's 67,456 at
    b256), b256 (four query groups), dims 768 and 30 (the copying
    producer), with dead slots, from K3's floor and with none, at every k
    of K1_KS (both sides of the lists' on-chip edge), against the plain
    version; and the default ring's edge is where the plan puts it."""
    assert K1_EDGE == 258
    metric = leg.split("-")[1]
    args, kw = make_state(rng, 69632, d, 256, cuda_device, leg, 7)
    bound = bound_of(args, kw, metric)
    sample, skw = sample_of(args, kw, 8192)
    sub = cuda_topk.sampled_submax(*sample, metric=metric, block_rows=2048,
                                   **skw)
    for k in K1_KS:
        theta0 = TD.threshold_from_submax(sub, k, method="count") \
            if floor else None
        small = dict(cuda_topk.small_scans)
        fl = cuda_topk.floor_scans[leg]
        v, i = cuda_topk.fused_topk(*args, k=k, metric=metric,
                                    theta0=theta0, **kw)
        vp, ip = cuda_topk.fused_topk_plain(*args, k=k, metric=metric,
                                            theta0=theta0, **kw)
        torch.cuda.synchronize()
        assert cuda_topk.small_scans == small, "took the small scan"
        assert cuda_topk.floor_scans[leg] - fl == int(floor), "wrong scan"
        msg = cuda_topk.topk_disagreement(v, i, vp, ip, bound)
        assert msg is None, f"k {k}: {msg}"


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 2, 8, 16, 64, 100, 128, 200, 256, 300,
                               512, 1024])
def test_cuda_k1_batch_sweep_matches_plain(rng, cuda_device, b):
    """K1's long scan at every batch size of the bench's sweep and between
    (one to 16 query groups of 64 without a floor, one to four of 256 from
    one) at 69,632 x 128 (past the small scan's
    67,456 rows), int8 cosine with dead slots, k 100 without a floor and
    k 16 from K3's floor, EQUAL to the plain version; each call takes the
    long scan."""
    args, kw = make_state(rng, 69632, 128, b, cuda_device, "int8-cosine", 7)
    sample, skw = sample_of(args, kw, 32768)
    sub = cuda_topk.sampled_submax(*sample, metric="cosine",
                                   block_rows=16384, **skw)
    for k, floor in ((100, False), (16, True)):
        theta0 = TD.threshold_from_submax(sub, k, method="count") \
            if floor else None
        small = dict(cuda_topk.small_scans)
        fl = cuda_topk.floor_scans["int8-cosine"]
        v, i = cuda_topk.fused_topk(*args, k=k, metric="cosine",
                                    theta0=theta0)
        vp, ip = cuda_topk.fused_topk_plain(*args, k=k, metric="cosine",
                                            theta0=theta0)
        torch.cuda.synchronize()
        assert cuda_topk.small_scans == small
        assert cuda_topk.floor_scans["int8-cosine"] - fl == int(floor)
        assert torch.equal(v, vp) and torch.equal(i, ip), (b, k)


@pytest.mark.cuda
def test_cuda_topk_smem_is_within_the_plan(cuda_device):
    """The long scan's whole shared memory (the library's account of the
    built kernel, vrod_topk_smem) is at most the plan's ``topk_smem`` and
    the card's limit at every k to 1280, the lists on chip or not, on the
    f32x3 legs (stages of both query halves) and on every other; and the
    scan from a floor's (vrod_topk_floor_smem) at most ``floor_smem``."""
    lib = _build.load()
    ring = cuda_topk.lib_ring(lib)
    for split in (False, True):
        for k in range(1, 1281):
            lay = cuda_topk.topk_layout(k, ring, split)
            need = lib.vrod_topk_smem(lay.ring, lay.cap, int(lay.on_chip),
                                      int(split))
            assert 0 < need <= cuda_topk.topk_smem(lay, split) \
                <= cuda_topk.SMEM_LIMIT, (k, lay, split)
    # The scan from a floor (every leg's ring of 48 KB stages; the radix
    # select's histograms past FLOOR_SORT_K), its static part the largest
    # build's.
    for k in range(1, 1281):
        need = lib.vrod_topk_floor_smem(k)
        assert 0 < need <= cuda_topk.floor_smem(k) <= cuda_topk.SMEM_LIMIT, k


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
    bound = bound_of(args, kw, metric)
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
    n, copies = tie_rows(dev, b, k)
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
    kw = leg_keywords(dtype)
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
           ("b264_k112", 65636, 96, 264, 112, 2048, 7),
           ("b256_k108", 131172, 128, 256, 108, 2048, 11)]
GATED = ["gate", "unroll2", "unroll4", "pingpong"]
_X_ROW = {"int8": torch.int8, "bf16": torch.bfloat16, "f32": torch.float32,
          "f32x3": torch.float32}


def x_precision(dtype):
    """The experiments' precision_name of a row kind: f32x3 is float32 at
    "exact" (and "high", the same leg), the others "fast"."""
    return "exact" if dtype == "f32x3" else "fast"


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
        args[3], metric=metric, precision=x_precision(dtype))
    msg = cuda_topk.topk_disagreement(*got, *want, bound)
    assert msg is None, msg


@pytest.mark.cuda
@pytest.mark.parametrize("case", X_CASES, ids=[c[0] for c in X_CASES])
@pytest.mark.parametrize("mode,leg", [
    (kern, leg) for kern in X_KERNELS
    for leg in cuda_extract.kernel_legs(kern)])
def test_cuda_extract_matches_plain(rng, cuda_device, case, mode, leg):
    """Every kernel on every leg it takes, against its plain twin, at k 28,
    112 and 108 with dead slots: int8 EQUAL, bfloat16/float32 within the
    score bound (f32x3: float32 at "exact"); the floor's ids -1."""
    _, n, d, b, k, blk, offset = case
    dtype, metric = leg.split("-")
    args = x_args(rng, n, d, b, cuda_device, dtype, offset)
    kw = dict(k=k, metric=metric, block_rows=blk,
              precision_name=x_precision(dtype))
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
@pytest.mark.parametrize("dtype", ["int8", "bf16", "f32", "f32x3"])
def test_cuda_extract_ties_across_list_cuts(cuda_device, mode, dtype, k):
    """Copies of row 7, 40 in each of the first seven row tiles of part 0,
    query 0 = row 7 (K1's tie case, test_cuda_k1_ties_across_list_cuts):
    the copies meet gates and carries that earlier copies raised to their
    score. Rows of -1/0/1 and queries of four +-2 under dot make every
    score exact, so each mode EQUALS its plain twin, lowest slot first. X2's
    carry and the store's lists lie in shared memory at both k (query groups
    of 64 at every k)."""
    rng = np.random.default_rng(78)
    b, d = 8, 128
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    parts = cuda_extract.extract_plan(
        mode, 8 * cuda_topk.TILE_ROWS * sms, b, k, sms).parts
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
              precision_name=x_precision(dtype))
    got = cuda_extract.run_kernel(mode, *args, **kw)
    want = cuda_extract.run_kernel(mode, *args, plain=True, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert got[1][0].tolist() == [7] + copies[:k - 1]


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 33, 34, 112, 128, 150, 230])
@pytest.mark.parametrize("b", [1, 200, 300])
@pytest.mark.parametrize("mode", ["carry", "store"])
def test_cuda_carry_and_store_edges(rng, cuda_device, mode, b, k):
    """The redesigned store and carry at their plans' edges: k 1, 33/34
    (where X2's old carry left shared memory), 112 and 128, and past the
    on-chip limits, where the lists (k 150) and then the carry too (k 230)
    live in global memory; one query, a batch that is no multiple of the
    group (200) and 300 (five groups of 64): int8 EQUAL to the plain twin,
    one launch a call, and every slot of a whole block (the rows past the
    last one unread)."""
    on_chip = cuda_extract.extract_plan(mode, 16384, b, k, 132).on_chip
    assert on_chip == (k <= (226 if mode == "carry" else 144))
    n, blk, offset = 16384 + 77, 1024, 3
    args = x_args(rng, n, 128, b, cuda_device, "int8", offset)
    kw = dict(k=k, metric="cosine", block_rows=blk, precision_name="fast")
    cuda_extract.reset_launches()
    got = cuda_extract.run_kernel(mode, *args, **kw)
    want = cuda_extract.run_kernel(mode, *args, plain=True, **kw)
    torch.cuda.synchronize()
    assert cuda_extract.launches[f"extract_{mode}[int8-cosine]"] == 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert int(got[1].max()) < n // blk * blk + offset


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 33, 112, 128, 210, 211, 230])
@pytest.mark.parametrize("b", [1, 200, 300])
@pytest.mark.parametrize("mode", GATED)
def test_cuda_gated_edges(rng, cuda_device, mode, b, k):
    """The gated kernels (X1's gate, X4, X3) at their plan's edges: k 1,
    33, 112, 128, the last k whose 242-entry lists stay in shared memory
    (210) and past it (211, 230: lists of K1's capacity in global memory);
    one query, a batch that is no multiple of the group (200) and 300
    (five groups of 64): int8 EQUAL to the plain twin, one launch a call,
    and every slot of a whole block."""
    on_chip = cuda_extract.extract_plan(mode, 16384, b, k, 132).on_chip
    assert on_chip == (k <= 210)
    n, blk, offset = 16384 + 77, 1024, 3
    args = x_args(rng, n, 128, b, cuda_device, "int8", offset)
    kw = dict(k=k, metric="cosine", block_rows=blk, precision_name="fast")
    cuda_extract.reset_launches()
    got = cuda_extract.run_kernel(mode, *args, **kw)
    want = cuda_extract.run_kernel(mode, *args, plain=True, **kw)
    torch.cuda.synchronize()
    assert cuda_extract.launches[f"extract_{mode}[int8-cosine]"] == 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert int(got[1].max()) < n // blk * blk + offset


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["int8", "bf16", "f32", "f32x3"])
@pytest.mark.parametrize("k", [28, 108, 112])
def test_cuda_pingpong_matches_plain_across_tiles(rng, cuda_device, dtype,
                                                  k):
    """X3 (the gate of one tile under the wgmmas of the next, accumulators
    alternating by tile) on every dtype at k 28, 108 and 112, dead slots,
    300 queries, cosine, over 40,000 rows (tiles of odd and even count per
    part): int8 EQUAL, the float rows within the bound."""
    args = x_args(rng, 40000, 128, 300, cuda_device, dtype, 5)
    kw = dict(k=k, metric="cosine", block_rows=1024,
              precision_name=x_precision(dtype))
    got = cuda_extract.kexp3_call(*args, **kw)
    want = cuda_extract.kexp3_plain(*args, **kw)
    torch.cuda.synchronize()
    x_agree(dtype, "cosine", args, got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 80, 81, 112, 130, 131, 146, 147, 162,
                               163, 211, 230])
@pytest.mark.parametrize("b", [1, 200, 300])
@pytest.mark.parametrize("mode", X_KERNELS)
def test_cuda_f32x3_extract_edges(rng, cuda_device, mode, b, k):
    """The f32x3 builds (float32 rows at "exact", cosine; stages of both
    query halves) at the plans' edges: k 1, 112, the store's lists' last
    on-chip k and the first past it (80, 81), X2's carry's stage of 32 and
    16 places (130, 131) and its last on-chip k and the next (162, 163),
    the gated lists' (146, 147), 211 and 230; one query, 200 and 300:
    within the bound of the plain twin, one launch a call, every slot of a
    whole block."""
    n, blk, offset = 16384 + 77, 1024, 3
    args = x_args(rng, n, 128, b, cuda_device, "f32x3", offset)
    kw = dict(k=k, metric="cosine", block_rows=blk, precision_name="exact")
    cuda_extract.reset_launches()
    got = cuda_extract.run_kernel(mode, *args, **kw)
    want = cuda_extract.run_kernel(mode, *args, plain=True, **kw)
    torch.cuda.synchronize()
    assert cuda_extract.launches[f"extract_{mode}[f32x3-cosine]"] == 1
    x_agree("f32x3", "cosine", args, got, want)
    if mode != "floor":
        assert int(got[1].max()) < n // blk * blk + offset


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["high", "exact"])
def test_cuda_f32x3_precisions_launch_the_split_builds(rng, cuda_device,
                                                       precision):
    """float32 rows at "high" and at "exact" launch the f32x3 build of
    every extraction kernel and of X6/X8 (counted under leg f32x3, never
    under f32), each within the bound of its plain version at b256."""
    metric = "l2"
    args = x_args(rng, 65536, 768, 256, cuda_device, "f32", 0)
    cuda_extract.reset_launches()
    cuda_floor.reset_launches()
    for mode in X_KERNELS:
        m = "cosine" if mode.startswith("unroll") else metric
        kw = dict(k=28, metric=m, block_rows=2048, precision_name=precision)
        got = cuda_extract.run_kernel(mode, *args, **kw)
        want = cuda_extract.run_kernel(mode, *args, plain=True, **kw)
        torch.cuda.synchronize()
        x_agree("f32x3", m, args, got, want)
        assert cuda_extract.launches[f"extract_{mode}[f32x3-{m}]"] == 1
    fargs, _ = make_state(rng, 65536, 768, 256, cuda_device, "f32-dot", 7)
    th = dict(k=28, metric="dot", block_rows=16384, s_blocks=2,
              precision=precision)
    got = cuda_floor.fused_theta(*fargs, **th)
    want = cuda_floor.fused_theta_plain(*fargs, **th)
    torch.cuda.synchronize()
    msg = cuda_topk.topk_disagreement(*got, *want, cuda_topk.score_error_bound(
        *fargs, metric="dot", precision=precision))
    assert msg is None, msg
    assert cuda_floor.launches["fused_theta[f32x3-dot]"] == 1
    assert not any(c for name, c in list(cuda_extract.launches.items())
                   + list(cuda_floor.launches.items())
                   if "[f32-" in name)


@pytest.mark.cuda
@pytest.mark.parametrize("iters", [4, 30])
def test_cuda_fused_theta_bisect_iters(rng, cuda_device, iters):
    """The kernel's bisection runs ``bisect_iters`` steps: theta0 bit-equal
    to bisect_floor of K3's sub-maxima in that many steps, and the top-k
    EQUAL to K1 without a floor (int8) at every count."""
    args, kw = make_state(rng, 65536, 768, 256, cuda_device, "int8-cosine", 7)
    v, i, t0 = cuda_floor.fused_theta(*args, k=28, metric="cosine",
                                      block_rows=16384, s_blocks=2,
                                      return_theta=True, bisect_iters=iters)
    sub = cuda_topk.sampled_submax(*[a[:32768] for a in args[:3]], args[3],
                                   metric="cosine", block_rows=16384)
    v0, i0 = cuda_topk.fused_topk(*args, k=28, metric="cosine")
    torch.cuda.synchronize()
    assert torch.equal(t0, TD.bisect_floor(sub, 28, iters))
    assert torch.equal(v, v0) and torch.equal(i, i0)


@pytest.mark.cuda
def test_cuda_extract_smem_is_the_kernels(cuda_device):
    """The plans' shared memory (``carry_smem``, ``store_smem``,
    ``gate_smem``: the ring, the stages or the score tile, the carry or the
    lists, the static part) is the kernels' own, as the library reports it
    from the built kernels (their static size and ``narrow_smem``), on chip
    and off, at every k to 256 and the capacities of both placements, in
    the TMA builds and the copying builds alike, on the f32x3 legs (stages
    of both query halves) and on every other."""
    lib = _build.load()
    for tma, split in ((t, s) for t in (True, False) for s in (0, 1)):
        carry, store, gate = (cuda_extract.entry(lib, mode, tma, "_smem")
                              for mode in ("carry", "store", "gate"))
        for k in range(1, 257):
            for stage in cuda_extract.CARRY_STAGES:
                for on_chip in (True, False):
                    assert carry(k, stage, int(on_chip), split) \
                        == cuda_extract.carry_smem(k, stage, on_chip,
                                                   split), \
                        (k, stage, tma, split)
            cap, on_chip = cuda_extract.store_plan(k, split)
            assert store(cap, int(on_chip), split) \
                == cuda_extract.store_smem(cap, on_chip, split), \
                (k, tma, split)
            cap, on_chip = cuda_extract.gate_plan(k, split)
            assert gate(cap, int(on_chip), split) \
                == cuda_extract.gate_smem(cap, on_chip, split), \
                (k, tma, split)
        room = cuda_extract.store_plan(1, split)[0]
        assert store(room + 1, 1, split) > cuda_extract.SMEM_BYTES
        room = cuda_extract.gate_plan(1, split)[0]
        assert gate(room + 1, 1, split) > cuda_extract.SMEM_BYTES


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
    """Nothing the experiments take is refused. float32 rows at precision
    high/exact, which raised before the kernels had an f32x3 build, launch
    it (three TF32 products; TF32 never stands in) and agree with the
    plain version. Rows TMA cannot load, which raised before the kernels
    had a copying build (int8 dim 30, and an 8-byte-offset contiguous view
    of int8 dim-128 rows), launch each of the seven kernels' copying build
    (``copy_launches``) and EQUAL its plain twin."""
    args = x_args(rng, 2048, 128, 8, cuda_device, "f32", 0)
    for prec in ("high", "exact"):
        cuda_extract.reset_launches()
        kw = dict(k=8, metric="dot", block_rows=1024, precision_name=prec)
        got = cuda_extract.kexp3_call(*args, **kw)
        want = cuda_extract.kexp3_plain(*args, **kw)
        torch.cuda.synchronize()
        assert cuda_extract.launches["extract_pingpong[f32x3-dot]"] == 1
        assert cuda_extract.copy_launches["extract_pingpong[f32x3-dot]"] == 0
        x_agree("f32x3", "dot", args, got, want)
    dim30 = x_args(rng, 2048 + 77, 30, 40, cuda_device, "int8", 5)
    aligned = x_args(rng, 2048 + 77, 128, 40, cuda_device, "int8", 5)
    flat = torch.empty(aligned[0].numel() + 8, dtype=torch.int8,
                       device=cuda_device)
    view = flat[8:].view(aligned[0].shape)
    view.copy_(aligned[0])
    assert view.data_ptr() % 16 == 8 and view.is_contiguous()
    for what, args in (("dim 30", dim30),
                       ("offset view", [view] + aligned[1:])):
        for kern in X_KERNELS:
            leg = "int8-cosine" if kern.startswith("unroll") else "int8-dot"
            kw = dict(k=28, metric=leg.split("-")[1], block_rows=1024,
                      precision_name="fast")
            cuda_extract.reset_launches()
            got = cuda_extract.run_kernel(kern, *args, **kw)
            want = cuda_extract.run_kernel(kern, *args, plain=True, **kw)
            torch.cuda.synchronize()
            name = f"extract_{kern}[{leg}]"
            assert cuda_extract.launches[name] == 1, (what, kern)
            assert cuda_extract.copy_launches[name] == 1, (what, kern)
            x_agree("int8", leg.split("-")[1], args, got, want)


# Rows TMA cannot load, by each granule of the copying producer
# (cuda_topk.copy_granule): dim and granule of each row kind. int8 dim 100
# (glove-100's 100 bytes) copies by 4, bfloat16 dim 100 (200 bytes) by 8,
# packed int4 dim 100 (50 bytes) by 2, float32 dim 25 (100 bytes; f32x3's
# split query too) by 4.
COPY_WIDTHS = {"int8": (100, 4), "int4": (100, 2), "bf16": (100, 8),
               "f32": (25, 4), "f32x3": (25, 4)}
COPY_ROWS = 69632 + 77  # past the small scan at b256, no multiple of 128


@pytest.mark.cuda
@pytest.mark.parametrize("leg", cuda_topk.LEGS)
def test_cuda_copy_granules_match_plain(rng, cuda_device, leg):
    """K3, K1 (its scan from a floor and its gated core), X6/X8 and, on its
    legs, X9 on rows TMA cannot load, at the leg's COPY_WIDTHS and
    COPY_ROWS rows, b256, with dead slots, at k 28 and 211 (past the
    gated lists' on-chip edge), against their plain versions (int8/int4
    EQUAL, float legs within the bound; K3's max K1's top-1 bit for bit):
    every K1 and K3 launch copied, by the granule the shape gives."""
    dtype, metric = leg.split("-")
    d, granule = COPY_WIDTHS[dtype]
    args, kw = make_state(rng, COPY_ROWS, d, 256, cuda_device, leg, 7)
    call = cuda_topk._Call(*args, metric, kw.get("row_bias"),
                           kw.get("q_scale"), kw["packed"],
                           kw.get("precision", "fast"))
    assert call.granule == granule
    bound = bound_of(args, kw, metric)
    cuda_topk.reset_launches()
    sample, skw = sample_of(args, kw, 8192)
    sub = cuda_topk.sampled_submax(*sample, metric=metric, block_rows=2048,
                                   **skw)
    subp = cuda_topk.sampled_submax_plain(*sample, metric=metric,
                                          block_rows=2048, **skw)
    top1, _ = cuda_topk.fused_topk(*sample, k=1, metric=metric, **skw)
    torch.cuda.synchronize()
    assert torch.equal(torch.isneginf(sub), torch.isneginf(subp))
    fin = torch.isfinite(subp)
    assert not ((sub - subp).abs().where(fin, 0.0)
                > bound_of(sample, skw, metric)).any()
    assert torch.equal(top1[:, 0], sub.amax(dim=1))
    for k in (28, 211):
        for floor in (False, True):
            theta0 = TD.threshold_from_submax(sub, k, method="count") \
                if floor else None
            v, i = cuda_topk.fused_topk(*args, k=k, metric=metric,
                                        theta0=theta0, **kw)
            vp, ip = cuda_topk.fused_topk_plain(*args, k=k, metric=metric,
                                                theta0=theta0, **kw)
            torch.cuda.synchronize()
            msg = cuda_topk.topk_disagreement(v, i, vp, ip, bound)
            assert msg is None, f"k {k}, floor {floor}: {msg}"
    assert cuda_topk.floor_scans[leg] == 2
    assert cuda_topk.copy_launches == cuda_topk.launches
    assert cuda_topk.launches[f"fused_topk[{leg}]"] == 5
    th = dict(k=28, metric=metric, block_rows=2048, s_blocks=8, **kw)
    v, i, t0 = cuda_floor.fused_theta(*args, return_theta=True, **th)
    vp, ip, t0p = cuda_floor.fused_theta_plain(*args, return_theta=True,
                                               **th)
    torch.cuda.synchronize()
    assert cuda_topk.topk_disagreement(v, i, vp, ip, bound) is None
    if dtype in ("int8", "int4"):
        assert torch.equal(t0, t0p)
    if leg in ("int8-cosine", "int8-dot"):
        theta0 = TD.threshold_from_submax(sub, 28, method="count")
        for t in (None, theta0):
            v, i = cuda_floor.fused_intgate(*args, k=28, metric=metric,
                                            theta0=t)
            vp, ip = cuda_floor.fused_intgate_plain(*args, k=28,
                                                    metric=metric, theta0=t)
            torch.cuda.synchronize()
            assert torch.equal(v, vp) and torch.equal(i, ip)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [28, 211])
@pytest.mark.parametrize("mode,leg", [
    (kern, leg) for kern in X_KERNELS
    for leg in cuda_extract.kernel_legs(kern)])
def test_cuda_extract_copy_granules_match_plain(rng, cuda_device, k, mode,
                                                leg):
    """Every extraction kernel on every leg it takes, on rows TMA cannot
    load at its row kind's COPY_WIDTHS (int8 by 4 bytes, bfloat16 by 8,
    float32 and f32x3 by 4), 4,173 rows (no multiple of 128; whole blocks
    of 1,024), b256, k 28 and 211: one launch of the copying build, EQUAL
    to the plain twin at int8, within the bound at the float legs."""
    dtype, metric = leg.split("-")
    d, granule = COPY_WIDTHS[dtype]
    args = x_args(rng, 4096 + 77, d, 256, cuda_device, dtype, 3)
    kw = dict(k=k, metric=metric, block_rows=1024,
              precision_name=x_precision(dtype))
    cuda_extract.reset_launches()
    got = cuda_extract.run_kernel(mode, *args, **kw)
    want = cuda_extract.run_kernel(mode, *args, plain=True, **kw)
    torch.cuda.synchronize()
    name = f"extract_{mode}[{leg}]"
    assert cuda_extract.launches[name] == 1
    assert cuda_extract.copy_launches[name] == 1
    x_agree(dtype, metric, args, got, want)


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
