"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU with nvcc: they are marked ``cuda`` and
skip where there is none. The file imports no JAX, so a GPU machine without
it runs them with:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Every leg of K1/K3 (int8 and packed int4 rows with an int8 query, bfloat16
and float32 rows with a float query; metrics cosine, dot and l2):
- int8/int4 scores are exact integer dots followed by the same rounded
  float32 ops, so kernel and plain version must be EQUAL: values and
  slots, ties and empty ranks included;
- bfloat16/float32 sums run in another order on the tensor cores, so
  values agree within ``cuda_topk.score_error_bound`` and slots are equal
  outside near-ties (``cuda_topk.topk_disagreement``).
"""

import numpy as np
import pytest
import torch

from vrod_tpu_torch.config import DTYPES, METRICS, CollectionConfig
from vrod_tpu_torch.engine import DeviceEngine
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
              "f32": torch.float32}


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
    kw = dict(packed=dtype == "int4")
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
    bound = cuda_topk.score_error_bound(*args, metric=metric)
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
    kw = dict(packed=dtype == "int4")
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
