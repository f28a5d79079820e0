"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU with nvcc: they are marked ``cuda`` and
skip where there is none. The file imports no JAX, so a GPU machine without
it runs them with:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

int8 scores are exact integer dots times one float32 multiply (plus an
exact 0/-inf mask), so kernel and plain version must be EQUAL: values and
slots, ties and empty ranks included.
"""

import numpy as np
import pytest
import torch

from vrod_tpu.config import CollectionConfig
from vrod_tpu.errors import ConfigError
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
]


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


def make_state(rng, n, d, b, dev, dead_every=0, ties=False):
    x = rng.standard_normal((n, d)).astype(np.float32)
    if ties:
        x[200:260] = x[3]
        x[700:720] = x[900]
    rows, aux = TD.prepare_rows(torch.from_numpy(x), metric="cosine",
                                dtype=torch.int8)
    valid = torch.ones(n, dtype=torch.bool)
    if dead_every:
        valid[::dead_every] = False
    q = rng.standard_normal((b, d)).astype(np.float32)
    if ties:
        q[0] = x[3]
    q8 = TD.prepare_queries(torch.from_numpy(q), metric="cosine",
                            quantize=True)
    return [t.to(dev) for t in (rows, aux, valid, q8)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_cuda_kernels_match_plain(rng, case, cuda_device):
    _, n, d, b, k, dead_every, floor, offset, ties = case
    args = make_state(rng, n, d, b, cuda_device, dead_every, ties)
    sample = [a[:n // 2] for a in args[:3]] + [args[3]]
    sub = cuda_topk.sampled_submax(*sample, metric="cosine", block_rows=256)
    sub_p = cuda_topk.sampled_submax_plain(*sample, metric="cosine",
                                           block_rows=256)
    torch.cuda.synchronize()
    assert torch.equal(sub, sub_p)
    theta0 = TD.threshold_from_submax(sub, k, method="count") \
        if floor else None
    v, i = cuda_topk.fused_topk(*args, k=k, metric="cosine",
                                index_offset=offset, theta0=theta0)
    vp, ip = cuda_topk.fused_topk_plain(*args, k=k, metric="cosine",
                                        index_offset=offset, theta0=theta0)
    torch.cuda.synchronize()
    assert torch.equal(i, ip) and torch.equal(v, vp)
    if ties:
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
    assert cuda_topk.launches == {"fused_topk": 2, "sampled_submax": 1}


@pytest.mark.cuda
def test_cuda_engine_refuses_legs_without_kernels(cuda_device):
    for dtype, metric in (("int8", "l2"), ("bfloat16", "cosine"),
                          ("int4", "dot")):
        cfg = CollectionConfig(name="r", dim=32, metric=metric, dtype=dtype)
        with pytest.raises(ConfigError, match="ROADMAP Queue 2"):
            DeviceEngine(cfg, device=cuda_device)
