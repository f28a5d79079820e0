"""The Python-side arithmetic of the CUDA kernels' launches, on the CPU:
K1's persistent plan and K3's segments must cover every slot exactly once,
as the chunked plan they replace did, and the TMA dispatch must send the
shapes TMA cannot load (rows not a multiple of 16 bytes, unaligned bases)
to the copying producer. A build with extra defines (the measurement
scripts' variants) lives beside the default library, never in its place.
(K3's segments are its clusters' blocks: ``submax_tiles``.) The
extraction kernels' plans (``cuda_extract.extract_plan``) are K1's
grid with each kernel's list capacity, and X2's carry goes to shared
memory only where it fits beside the ring."""

import pytest
import torch

from vrod_tpu_torch.ops import _build
from vrod_tpu_torch.ops import cuda_extract
from vrod_tpu_torch.ops import cuda_topk as K

SHAPES = [(1, 8), (30, 40), (127, 8), (128, 256), (129, 256), (1000, 40),
          (8192, 256), (65536, 256), (65536, 300), (1_048_576, 256),
          (1_000_000, 4096), (262144, 16)]


def old_plan(n, b, k, sms, q_tile=32, sub=512, tile=64):
    """The chunked plan K1 had before the persistent grid: (nchunks,
    chunk_rows)."""
    qtiles = -(-b // q_tile)
    target = max(1, 4 * sms // qtiles)
    nchunks = min(target, max(1, -(-n // sub)))
    chunk_rows = -(-n // nchunks)
    chunk_rows = max(tile, -(-chunk_rows // tile) * tile)
    return max(1, -(-n // chunk_rows)), chunk_rows


@pytest.mark.parametrize("n,b", SHAPES)
@pytest.mark.parametrize("sms", [132, 7, 1])
def test_topk_plan_covers_every_slot_once(n, b, sms):
    groups, parts, cap = K.topk_plan(n, b, 28, sms)
    assert groups * K.GROUP_QUERIES >= b > (groups - 1) * K.GROUP_QUERIES
    assert 1 <= parts and groups * parts <= max(sms, groups)
    # The kernel cuts every (cap - k) / 128 - 1 tiles, and a list cut to k
    # still takes every candidate of the tiles until the next cut.
    cut_every = (cap - 28) // K.TILE_ROWS - 1
    assert cut_every == K.CUT_TILES
    assert cap - cut_every * K.TILE_ROWS > 28
    hits = torch.zeros(n, dtype=torch.int32)
    for p in range(parts):
        tiles = list(K.part_tiles(p, parts, n))
        assert tiles == sorted(tiles)    # ascending slots within a part
        for t in tiles:
            hits[t * K.TILE_ROWS:(t + 1) * K.TILE_ROWS] += 1
    assert bool((hits == 1).all())
    nchunks, rows = old_plan(n, b, 28, sms)
    old = torch.zeros(n, dtype=torch.int32)
    for c in range(nchunks):
        old[c * rows:(c + 1) * rows] += 1
    assert torch.equal(hits, old)


@pytest.mark.parametrize("n,blk", [(32768, 16384), (131072, 16384),
                                   (131072, 8192), (24576, 8192),
                                   (4096, 256), (256, 256), (8192, 4096)])
@pytest.mark.parametrize("b", [8, 40, 256, 300])
def test_submax_plan_segments_tile_each_block(n, blk, b):
    width, groups, spb = K.submax_plan(n, b, blk, 132)
    assert groups == -(-b // width)
    assert spb & (spb - 1) == 0 and (blk // K.TILE_ROWS) % spb == 0
    assert (n // blk) * spb * groups <= max(132, (n // blk) * groups)
    hits = torch.zeros(n, dtype=torch.int32)
    for j in range(n // blk):
        for sg in range(spb):
            for t in K.submax_tiles(j, sg, blk, spb):
                hits[t * K.TILE_ROWS:(t + 1) * K.TILE_ROWS] += 1
    assert bool((hits == 1).all())


@pytest.mark.parametrize("dtype,dim,packed,tma", [
    (torch.int8, 768, False, True), (torch.int8, 96, False, True),
    (torch.int8, 30, False, False), (torch.int8, 80, False, True),
    (torch.int8, 15, True, False),   # packed int4 dim 30
    (torch.int8, 48, True, True),    # packed int4 dim 96
    (torch.bfloat16, 30, False, False), (torch.bfloat16, 96, False, True),
    (torch.float32, 30, False, False), (torch.float32, 96, False, True),
])
def test_tma_dispatch_by_shape(dtype, dim, packed, tma):
    x = torch.zeros((64, dim), dtype=dtype)
    qdim = 2 * dim if packed else dim
    q = torch.zeros((40, qdim), dtype=torch.int8 if dtype == torch.int8
                    else dtype)
    row_bytes = dim * x.element_size()
    assert K.use_tma(x, q, row_bytes) is tma
    if tma:   # an unaligned base goes to the copying producer too
        flat = torch.zeros(64 * dim + 1, dtype=dtype)
        assert not K.use_tma(flat[1:].view(64, dim), q, row_bytes)


@pytest.mark.parametrize("defines", [("VROD_K1_RING=3",),
                                     ("VROD_PROBE_NO_GATE",),
                                     ("VROD_PROBE_NO_GATE",
                                      "VROD_PROBE_NO_MMA")])
def test_build_variants_beside_the_default(defines):
    default = _build.library_path()
    variant = _build.library_path(defines)
    assert variant != default and variant.parent == default.parent
    assert variant == _build.library_path(tuple(defines))
    assert _build.library_path(()) == default


@pytest.mark.parametrize("n,b,k,blk,s_blocks", [
    (1_000_000, 256, 28, 16384, 2), (1_000_000, 256, 112, 2048, 64),
    (1_048_576, 256, 108, 8192, 16), (4096, 8, 112, 512, 2),
    (65536, 256, 28, 16384, 1), (262144, 40, 24, 256, 1)])
@pytest.mark.parametrize("sms", [132, 7])
def test_theta_plan_is_k1_grid_and_whole_sample_blocks(n, b, k, blk,
                                                       s_blocks, sms):
    """fused_theta runs K1's persistent grid (co-resident: about one block
    per SM) and scores the sample's whole tiles, blk / 128 per block."""
    from vrod_tpu_torch.ops import cuda_floor as F
    if s_blocks * 128 < 2 * k:
        with pytest.raises(ValueError, match="2k sub-maxima"):
            F.theta_plan(n, b, k, blk, s_blocks, sms)
        return
    groups, parts, cap, sample_tiles, blk_tiles = F.theta_plan(
        n, b, k, blk, s_blocks, sms)
    assert (groups, parts, cap) == K.topk_plan(n, b, k, sms)
    assert groups * parts <= max(sms, groups)
    assert sample_tiles * K.TILE_ROWS == s_blocks * blk <= n
    assert blk_tiles * K.TILE_ROWS == blk
    # Every sample tile lies in one part's walk and one sample block.
    seen = sorted(t for p in range(parts)
                  for t in K.part_tiles(p, parts, n) if t < sample_tiles)
    assert seen == list(range(sample_tiles))
    assert {t // blk_tiles for t in seen} == set(range(s_blocks))


@pytest.mark.parametrize("blk,s_blocks,n", [(100, 2, 4096), (0, 2, 4096),
                                            (512, 0, 4096), (512, 9, 4096)])
def test_theta_plan_refuses_bad_samples(blk, s_blocks, n):
    from vrod_tpu_torch.ops import cuda_floor as F
    with pytest.raises(ValueError):
        F.theta_plan(n, 8, 8, blk, s_blocks, 132)


@pytest.mark.parametrize("k,ring,smem", [(8, 4, True), (9, 4, True),
                                         (10, 3, True), (28, 3, True),
                                         (33, 3, True), (34, 4, False),
                                         (108, 4, False), (112, 4, False)])
def test_carry_plan_keeps_the_carry_in_shared_memory_when_it_fits(k, ring,
                                                                  smem):
    """X2's carry (256 queries x k x 8 bytes) sits beside the deepest ring
    of 4 or 3 stages that leaves it room in a block's 227 KB, else in
    global memory beside 4 stages: 4 stages to k 9, 3 to k 33."""
    assert cuda_extract.carry_plan(k) == (ring, smem)
    need = 1024 + ring * cuda_extract.STAGE_BYTES + 256 * k * 8 \
        + cuda_extract.CARRY_STATIC_BYTES
    assert (need <= cuda_extract.SMEM_BYTES) == smem


@pytest.mark.parametrize("kernel", list(cuda_extract.KERNELS))
@pytest.mark.parametrize("n,b,k", [(1 << 20, 256, 28), (1 << 20, 264, 112),
                                   (4096, 8, 16)])
@pytest.mark.parametrize("count", [False, True])
def test_extract_plan_is_k1_grid_with_each_kernels_lists(kernel, n, b, k,
                                                         count):
    """Every extraction kernel runs K1's persistent grid; its list capacity
    is K1's for the gated kernels (cut every 4 tiles), k + 1 tile for the
    store kernel (cut every tile), k for X2's carry and none for the floor;
    X2 with ``count`` runs one part per query group (rows in global
    order)."""
    groups, parts, cap, ring, smem = cuda_extract.extract_plan(
        kernel, n, b, k, 132, count=count and kernel == "carry")
    g1, p1, cap1 = K.topk_plan(n, b, k, 132)
    assert groups == g1
    want_cap = {"floor": 0, "store": k + 128, "carry": k}.get(kernel, cap1)
    assert cap == want_cap
    assert parts == (1 if count and kernel == "carry" else p1)
    if kernel == "carry":
        assert (ring, smem) == cuda_extract.carry_plan(k)
    else:
        assert (ring, smem) == (4, False)
    with pytest.raises(ValueError, match="kernel"):
        cuda_extract.extract_plan("unroll8", n, b, k, 132)
