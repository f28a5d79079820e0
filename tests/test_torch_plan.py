"""The Python-side arithmetic of the CUDA kernels' launches, on the CPU:
K1's persistent plans and K3's segments must cover every slot exactly
once, as the chunked plan they replace did; K1's gated core (no floor)
takes query groups of 64 with lists on chip while they fit within a
block's shared memory, its scan from a floor groups of 256 with lists of k
+ 5 tiles in scratch, and ``scan_route`` picks between them and the small
scan by the call's floor and shapes; and the TMA dispatch must send the
shapes TMA cannot load (rows not a multiple of 16 bytes, unaligned bases)
to the copying producer. A build with extra defines (the measurement
scripts' variants) lives beside the default library, never in its place.
(K3's segments are its clusters' blocks: ``submax_tiles``.) The
extraction kernels' plans (``cuda_extract.extract_plan``): the floor
runs K1's grid; the store, X2's carry and the gated kernels (X1's gate,
X3, X4) take query groups of 64 whose lists and carry stay in shared
memory to k 128 at least, within a block's 227 KB."""

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
    groups, parts, cap, on_chip, _ = K.topk_plan(n, b, 28, sms)
    assert groups * K.GROUP_QUERIES >= b > (groups - 1) * K.GROUP_QUERIES
    assert 1 <= parts and groups * parts <= max(sms, groups)
    # No cut cadence: a list cut to k (when full) has room for a warp's
    # worth more, on chip at k 28.
    assert on_chip and cap >= 28 + K.LIST_SLACK
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


@pytest.mark.parametrize("n,b", SHAPES)
@pytest.mark.parametrize("sms", [132, 7, 1])
def test_floor_plan_covers_every_slot_once(n, b, sms):
    """The scan from a floor: query groups of 256, about one block per SM,
    lists of k + (FLOOR_CUT_TILES + 1) tiles, and its parts' tiles cover
    every slot once, in ascending order within a part, as the chunked plan
    did."""
    groups, parts, cap = K.floor_plan(n, b, 28, sms)
    assert K.FLOOR_GROUP == 256 and K.FLOOR_CUT_TILES == 4
    assert groups * 256 >= b > (groups - 1) * 256
    assert 1 <= parts and groups * parts <= max(sms, groups)
    assert cap == 28 + 5 * K.TILE_ROWS
    hits = torch.zeros(n, dtype=torch.int32)
    for p in range(parts):
        tiles = list(K.part_tiles(p, parts, n))
        assert tiles == sorted(tiles)
        for t in tiles:
            hits[t * K.TILE_ROWS:(t + 1) * K.TILE_ROWS] += 1
    assert bool((hits == 1).all())
    nchunks, rows = old_plan(n, b, 28, sms)
    old = torch.zeros(n, dtype=torch.int32)
    for c in range(nchunks):
        old[c * rows:(c + 1) * rows] += 1
    assert torch.equal(hits, old)


@pytest.mark.parametrize("n,b,k", [(8192, 256, 28), (67456, 256, 28),
                                   (67457, 256, 28), (1 << 20, 256, 28),
                                   (1 << 20, 1, 112), (8192, 256, 65),
                                   (131072, 1024, 16), (69632, 300, 1280)])
@pytest.mark.parametrize("floor", [False, True])
def test_scan_route_by_floor_and_shape(n, b, k, floor):
    """Which K1 kernel takes a scan: the small scan wherever ``small_plan``
    takes the shapes, floor or none; else the scan from a floor when the
    call has theta0 and the gated core when it has none."""
    route = K.scan_route(n, b, k, 132, floor)
    if K.small_plan(n, b, k, 132) is not None:
        assert route == "small"
    else:
        assert route == ("floor" if floor else "core")
    if (n, k) == (8192, 28):
        assert route == "small"
    if n == 1 << 20:
        assert route != "small"


@pytest.mark.parametrize("b,k", [(1, 1), (256, 28), (256, 112), (300, 211),
                                 (1024, 1280)])
def test_floor_scratch_holds_the_lists_and_gather(b, k):
    """The scan from a floor's scratch: lists of cap a (part, query) and
    their lengths, and the merge's gather of every part's k a query, 4
    bytes each."""
    plan = K.floor_plan(1 << 20, b, k, 132)
    assert plan.cap == k + 640
    assert K.floor_scratch_bytes(plan, b, k) == 4 * (
        2 * plan.parts * b * plan.cap + plan.parts * b
        + 2 * b * plan.parts * k)


# The scan from a floor takes every k: below FLOOR_SORT_K, at it and past
# it (the radix select's histograms join), the on-chip edge of the gated
# core (258) and the k the tests and the bench take.
FLOOR_KS = [1, 16, 28, 108, 112, K.FLOOR_SORT_K, K.FLOOR_SORT_K + 1, 258,
            300, 1280, 4096]


@pytest.mark.parametrize("k", FLOOR_KS)
def test_floor_smem_within_the_card(k):
    """The scan from a floor's block (csrc/fused_topk_floor.cu): a ring of
    FLOOR_RING stages of the row box and 256 queries' box (48 KB on every
    leg: f32x3 takes its query halves in stages of their own), the radix
    select's histograms only past FLOOR_SORT_K (below it a cut is a warp
    sort, no shared memory), and the static bound, within the card's
    shared memory; and the same at every k to 1280."""
    assert K.stage_bytes(K.FLOOR_GROUP) == K.stage_bytes(K.FLOOR_GROUP,
                                                         True) == 48 * 1024
    hist = K.FLOOR_HIST if k > K.FLOOR_SORT_K else 0
    assert K.floor_smem(k) == (1024 + K.FLOOR_RING * 48 * 1024 + hist
                               + K.FLOOR_STATIC_SMEM) <= K.SMEM_LIMIT
    assert max(K.floor_smem(j) for j in range(1, 1281)) == \
        K.floor_smem(K.FLOOR_SORT_K + 1) <= K.SMEM_LIMIT


def test_floor_constants_are_the_kernels():
    """The plan's account of the scan from a floor names the kernel's own
    constants (the card checks the whole against vrod_topk_floor_smem):
    the ring's depth (K1's default ring, at most 4), the cut cadence, the
    largest k cut by warp sorts alone, and eight warps' histograms of 256
    counters."""
    import re
    from pathlib import Path
    csrc = Path(_build.__file__).resolve().parent.parent / "csrc"
    floor = (csrc / "fused_topk_floor.cu").read_text()
    topk = (csrc / "topk.cuh").read_text()

    def const(text, name):
        return re.search(rf"constexpr int {name} = ([^;]+);", text).group(1)

    assert const(floor, "kFloorRing") == "kRing < 4 ? kRing : 4"
    assert min(K.RING, 4) == K.FLOOR_RING
    assert int(const(floor, "kFloorCutTiles")) == K.FLOOR_CUT_TILES
    assert int(const(topk, "kSortLongK")) == K.FLOOR_SORT_K
    assert const(floor, "kFloorHist") == "kConsumers / 32 * 256 * 4"
    assert K.FLOOR_HIST == 8 * 256 * 4


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


def _view(dtype, n, dim, offset):
    """(n, dim) rows ``offset`` bytes past the 64-byte aligned base of a
    flat tensor (a contiguous view, as a slice of a larger store is)."""
    size = torch.empty((), dtype=dtype).element_size()
    flat = torch.zeros(n * dim + offset // size, dtype=dtype)
    return flat[offset // size:].view(n, dim)


@pytest.mark.parametrize("dtype,dim,packed,precision,offset,granule", [
    (torch.int8, 100, False, "fast", 0, 4),       # glove-100 int8: 100 B
    (torch.bfloat16, 100, False, "fast", 0, 8),   # 200 B
    (torch.int8, 30, False, "fast", 0, 2),
    (torch.int8, 15, True, "fast", 0, 1),         # packed int4 dim 30
    (torch.int8, 50, True, "fast", 0, 2),         # packed int4 dim 100
    (torch.float32, 25, False, "fast", 0, 4),
    (torch.float32, 25, False, "high", 0, 4),     # f32x3: the split query
    (torch.float32, 26, False, "exact", 0, 8),    # f32x3, 104 B rows
    (torch.int8, 768, False, "fast", 8, 8),       # 8-byte-offset view
    (torch.int8, 768, False, "fast", 4, 4),       # 4-byte-offset view
    (torch.int8, 768, False, "fast", 0, 16),      # whole 16-byte rows: TMA
    (torch.bfloat16, 96, False, "fast", 0, 16),
    (torch.float32, 96, False, "high", 0, 16),
])
def test_copy_granule_by_shape(dtype, dim, packed, precision, offset,
                               granule):
    """The launch's granule, as the wrapper passes it (the query as the
    kernel reads it: f32x3's (B, 2D) split, packed int4's full-width int8
    query): the widest of 16, 8, 4, 2, 1 bytes dividing the row bytes and
    both bases; 16 is TMA."""
    n, b = 256, 40
    x = _view(dtype, n, dim, offset)
    qdim = 2 * dim if packed else dim
    q = torch.zeros((b, qdim), dtype=torch.int8 if dtype == torch.int8
                    else torch.float32)
    call = K._Call(x, torch.ones(n), torch.ones(n, dtype=torch.bool), q,
                   "cosine", None, None, packed, precision)
    assert call.granule == granule
    assert K.copy_granule(call.x, call.q, call.row_bytes) == granule
    assert K.use_tma(call.x, call.q, call.row_bytes) is (granule == 16)
    if granule != 16:   # the copying build encodes no tensor map
        assert call.maps(64) == (None, None, None)


@pytest.mark.parametrize("defines", [("VROD_K1_RING=3",),
                                     ("VROD_PROBE_NO_GATE",),
                                     ("VROD_PROBE_NO_GATE",
                                      "VROD_PROBE_NO_MMA"),
                                     ("VROD_PROBE_PRESPLIT",),
                                     ("VROD_PROBE_CVT_SPLIT",),
                                     ("VROD_PROBE_LOCKSTEP",),
                                     ("VROD_PROBE_PINGPONG",),
                                     ("VROD_PROBE_RADIX_CUT",)])
def test_build_variants_beside_the_default(defines):
    default = _build.library_path()
    variant = _build.library_path(defines)
    assert variant != default and variant.parent == default.parent
    assert variant == _build.library_path(tuple(defines))
    assert _build.library_path(()) == default


@pytest.mark.parametrize("sources", [("fused_topk.cu",),
                                     ("fused_topk.cu", "sampled_submax.cu"),
                                     ("fused_topk_floor.cu",)])
def test_build_of_some_sources_beside_the_whole(sources):
    """A measurement build of some sources alone (tools/kernel_probe.py
    --f32x3) lies beside the whole library of the same defines, names the
    same sources in any order, and compiles exactly those files."""
    defines = ("VROD_PROBE_PRESPLIT",)
    whole = _build.library_path(defines)
    some = _build.library_path(defines, sources)
    assert some != whole and some.parent == whole.parent
    assert some == _build.library_path(defines, tuple(reversed(sources)))
    assert [p.name for p in _build._sources(sources)] == sorted(sources)
    assert len(_build._sources()) > len(sources)


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
    plan = F.theta_plan(n, b, k, blk, s_blocks, sms)
    groups, parts, *_, sample_tiles, blk_tiles = plan
    assert tuple(plan[:5]) == K.topk_plan(n, b, k, sms)
    assert groups * parts <= max(sms, groups)
    assert sample_tiles * K.TILE_ROWS == s_blocks * blk <= n
    assert blk_tiles * K.TILE_ROWS == blk
    # Every sample tile lies in one part's run, each run consecutive
    # tiles, and in one sample block.
    runs = [F.sample_run(p, parts, sample_tiles) for p in range(parts)]
    seen = [t for r in runs for t in r]
    assert seen == list(range(sample_tiles))
    assert all(r.step == 1 for r in runs)
    assert {t // blk_tiles for t in seen} == set(range(s_blocks))


@pytest.mark.parametrize("blk,s_blocks,n", [(100, 2, 4096), (0, 2, 4096),
                                            (512, 0, 4096), (512, 9, 4096)])
def test_theta_plan_refuses_bad_samples(blk, s_blocks, n):
    from vrod_tpu_torch.ops import cuda_floor as F
    with pytest.raises(ValueError):
        F.theta_plan(n, 8, 8, blk, s_blocks, 132)


@pytest.mark.parametrize("k,stage,on_chip", [
    (1, 32, True), (8, 32, True), (9, 32, True), (10, 32, True),
    (28, 32, True), (33, 32, True), (34, 32, True), (62, 32, True),
    (63, 32, True), (108, 32, True), (112, 32, True), (128, 32, True),
    (150, 32, True), (194, 32, True), (195, 16, True), (220, 16, True),
    (226, 16, True), (227, 16, False), (1280, 16, False)])
def test_carry_plan_keeps_the_carry_in_shared_memory_when_it_fits(
        k, stage, on_chip):
    """X2's carry (64 queries x k x 8 bytes) sits in shared memory beside a
    4-stage ring and two stages a query, at the largest stage (32, else 16)
    that leaves it room in a block's 227 KB: stages of 32 to k 194, of 16
    to k 226; past that in global memory with stages of 16."""
    assert cuda_extract.NARROW == 64
    assert cuda_extract.carry_plan(k) == (stage, on_chip)
    need = 1024 + 4 * (128 * 128 + 64 * 128) + 2 * 64 * stage * 8 \
        + 64 * k * 8 + 832
    assert need == cuda_extract.carry_smem(k, stage)
    assert (need <= cuda_extract.SMEM_BYTES) == on_chip
    assert cuda_extract.carry_smem(k, stage, on_chip) \
        <= cuda_extract.SMEM_BYTES
    if on_chip and stage == 16:
        assert cuda_extract.carry_smem(k, 32) > cuda_extract.SMEM_BYTES


@pytest.mark.parametrize("k", range(1, 129))
def test_new_plans_keep_carry_and_lists_on_chip_to_k_128(k):
    """For every k the smoke and the experiments take (1..128), X2's carry
    and the store's lists stay in shared memory, and each plan's need (the
    ring, the stages or the score tile, the carry or the lists, the static
    part) stays within a block's 227 KB; the store's lists take k + 32 at
    least, so a cut always leaves room for the next 32 scores."""
    stage, on_chip = cuda_extract.carry_plan(k)
    assert on_chip and 1 <= stage <= 32
    assert cuda_extract.carry_smem(k, stage) <= cuda_extract.SMEM_BYTES
    cap, son_chip = cuda_extract.store_plan(k)
    assert son_chip and cap >= k + cuda_extract.STORE_SLACK
    assert cuda_extract.store_smem(cap) <= cuda_extract.SMEM_BYTES
    assert cuda_extract.store_smem(cap + 1) > cuda_extract.SMEM_BYTES
    gcap, gon_chip = cuda_extract.gate_plan(k)
    assert gon_chip and gcap >= k + cuda_extract.STORE_SLACK
    assert cuda_extract.gate_smem(gcap) <= cuda_extract.SMEM_BYTES
    assert cuda_extract.gate_smem(gcap + 1) > cuda_extract.SMEM_BYTES
    for kernel in ("carry", "store", "gate", "unroll2", "unroll4",
                   "pingpong"):
        plan = cuda_extract.extract_plan(kernel, 1 << 20, 256, k, 132)
        assert plan.on_chip


@pytest.mark.parametrize("k,carry_on_chip,store_on_chip", [
    (1, True, True), (28, True, True), (112, True, True),
    (128, True, True), (144, True, True), (145, True, False),
    (1280, False, False)])
def test_new_plans_group_width_by_k(k, carry_on_chip, store_on_chip):
    """The query group each plan takes by k: 64 for every kernel but the
    floor at every k (n64 measured faster than n128 on the H100), X2's
    carry on chip to k 226, the store's 176-entry lists to k 144 and the
    gated kernels' 242-entry lists to k 210, then in global memory at the
    same group; the floor keeps K1's 256."""
    gate_on_chip = k <= 210
    for kernel, on_chip in (("carry", carry_on_chip),
                            ("store", store_on_chip),
                            ("gate", gate_on_chip),
                            ("unroll2", gate_on_chip),
                            ("unroll4", gate_on_chip),
                            ("pingpong", gate_on_chip)):
        plan = cuda_extract.extract_plan(kernel, 1 << 20, 256, k, 132)
        assert (plan.width, plan.groups) == (64, 4)
        assert plan.on_chip == on_chip
    assert cuda_extract.store_plan(k)[0] == (
        176 if store_on_chip else k + K.GLOBAL_SLACK)
    assert cuda_extract.gate_plan(k)[0] == (
        242 if gate_on_chip else k + K.GLOBAL_SLACK)
    assert cuda_extract.extract_plan("floor", 1 << 20, 256, k, 132).width \
        == 256


@pytest.mark.parametrize("b", [1, 255, 256, 300])
@pytest.mark.parametrize("k", [1, 28, 112])
@pytest.mark.parametrize("kernel", ["carry", "store", "gate", "unroll2",
                                    "unroll4", "pingpong"])
@pytest.mark.parametrize("count", [False, True])
def test_new_plans_launch_arguments(kernel, b, k, count):
    """The launch of every kernel but the floor for batches of 1, 255, 256
    and 300 on 132 SMs: groups of 64 cover every query once, the grid
    (groups x parts) is about one block per SM (X2 with ``count``: one part
    a group), and the scratch the wrapper allocates holds every (part,
    query) list the kernel hands over (stride k where the lists stayed on
    chip), the merge's gather and the per-block counts."""
    n, sms = 1 << 20, 132
    count = count and kernel == "carry"
    plan = cuda_extract.extract_plan(kernel, n, b, k, sms, count=count)
    assert plan.width == 64
    assert (plan.groups - 1) * plan.width < b <= plan.groups * plan.width
    if count:
        assert plan.parts == 1
    else:
        assert plan.parts == max(1, min(n // 128, sms // plan.groups))
        assert plan.groups * plan.parts <= max(sms, plan.groups)
    if kernel == "carry":
        assert plan.cap == k and 1 <= plan.stage <= 32
    else:
        assert plan.cap >= k + cuda_extract.STORE_SLACK and plan.stage == 0
        assert plan.on_chip    # k <= 112: the lists on chip
    size = cuda_extract.scratch_sizes(kernel, plan, b, k, n // 2048, count)
    stride = k if kernel == "carry" or plan.on_chip else plan.cap
    assert size["cand_v"] == size["cand_i"] == plan.parts * b * stride
    assert size["cand_n"] == plan.parts * b
    assert size["merge"] == b * plan.parts * k
    assert size["cnt"] == (n // 2048 * b if count else 1)


@pytest.mark.parametrize("kernel", list(cuda_extract.KERNELS))
@pytest.mark.parametrize("n,b,k", [(1 << 20, 256, 28), (1 << 20, 264, 112),
                                   (4096, 8, 16)])
@pytest.mark.parametrize("count", [False, True])
def test_extract_plan_is_k1_grid_with_each_kernels_lists(kernel, n, b, k,
                                                         count):
    """The floor runs a persistent grid of 256-query groups with no lists.
    Every other kernel takes groups of 64 in as many parts as keep about
    one block per SM: the store's lists of its plan's capacity, the gated
    kernels' (gate, unroll2/4, pingpong) of theirs, the carry's k; X2 with
    ``count`` runs one part per query group (rows in global order)."""
    plan = cuda_extract.extract_plan(kernel, n, b, k, 132,
                                     count=count and kernel == "carry")
    g1 = -(-b // 256)
    p1 = max(1, min(-(-n // 128), 132 // g1))
    if kernel == "floor":
        assert plan.groups == g1 and plan.width == 256
    else:
        assert plan.groups == -(-b // plan.width) and plan.width == 64
        p1 = max(1, min(-(-n // 128), 132 // plan.groups))
    want_cap = {"floor": 0, "store": cuda_extract.store_plan(k)[0],
                "carry": k}.get(kernel, cuda_extract.gate_plan(k)[0])
    assert plan.cap == want_cap
    assert plan.parts == (1 if count and kernel == "carry" else p1)
    if kernel == "carry":
        assert (plan.stage, plan.on_chip) == cuda_extract.carry_plan(k)
    elif kernel == "store":
        assert (plan.cap, plan.on_chip) == cuda_extract.store_plan(k)
    elif kernel == "floor":
        assert (plan.on_chip, plan.stage) == (False, 0)
    else:
        assert (plan.cap, plan.on_chip) == cuda_extract.gate_plan(k)
        assert plan.stage == 0
    with pytest.raises(ValueError, match="kernel"):
        cuda_extract.extract_plan("unroll8", n, b, k, 132)


@pytest.mark.parametrize("k,cap,on_chip", [
    (1, 242, True), (28, 242, True), (108, 242, True), (112, 242, True),
    (128, 242, True), (150, 242, True), (209, 242, True), (210, 242, True),
    (211, 851, False), (230, 870, False), (256, 896, False),
    (1280, 1920, False)])
def test_gate_plan_keeps_lists_in_shared_memory_while_they_fit(k, cap,
                                                               on_chip):
    """The gated kernels (X1's gate, X3, X4) keep lists of 242 entries a
    query in shared memory beside the 4-stage ring, with no score tile:
    1024 + 4 x 24 KB + 64 x 242 x 8 + 8,768 static bytes, within a block's
    227 KB, while that leaves k + 32 places (to k 210); past that, lists
    of K1's capacity there (k + 5 tiles of 128) in global memory."""
    assert cuda_extract.gate_plan(k) == (cap, on_chip)
    assert cuda_extract.gate_smem(0) == 1024 + 4 * (128 * 128 + 64 * 128) \
        + 8768
    assert cuda_extract.gate_smem(242) == cuda_extract.gate_smem(0) \
        + 64 * 242 * 8 <= cuda_extract.SMEM_BYTES
    assert cuda_extract.gate_smem(243) > cuda_extract.SMEM_BYTES
    assert cuda_extract.gate_smem(cap, on_chip) <= cuda_extract.SMEM_BYTES
    if not on_chip:
        assert cap == k + K.GLOBAL_SLACK == k + 5 * 128
        assert cuda_extract.gate_smem(cap, False) == cuda_extract.gate_smem(0)


@pytest.mark.parametrize("kernel", ["gate", "unroll2", "unroll4",
                                    "pingpong", "store", "carry"])
@pytest.mark.parametrize("k", [28, 108, 112, 210, 211])
def test_scratch_stride_follows_where_the_lists_live(kernel, k):
    """The (part, query) lists handed to the merge: at stride k where a
    kernel kept its lists (or X2 its carry) in shared memory and copied
    them out cut to k, at stride cap where they lived in global memory in
    place; the merge gathers every part's k a query either way."""
    b, n = 256, 1 << 20
    plan = cuda_extract.extract_plan(kernel, n, b, k, 132)
    size = cuda_extract.scratch_sizes(kernel, plan, b, k, n // 2048)
    on_chip = plan.on_chip
    if kernel in ("gate", "unroll2", "unroll4", "pingpong"):
        assert on_chip == (k <= 210)
    stride = k if on_chip or kernel == "carry" else plan.cap
    assert size["cand_v"] == size["cand_i"] == plan.parts * b * stride
    assert size["merge"] == b * plan.parts * k
    assert size["cand_n"] == plan.parts * b == 33 * 256


@pytest.mark.parametrize("b", [1, 2, 8, 16, 64, 65, 100, 128, 129, 192,
                               200, 256, 300, 320, 384, 512, 1024])
@pytest.mark.parametrize("sms", [132, 7])
def test_topk_plan_width_and_parts(b, sms):
    """K1's long scan for the batch sweep's sizes and between: query groups
    of 64 cover every query once, as many parts as leave about one block
    per SM (at least one), and the shared memory ``topk_layout`` gives."""
    n = 1 << 20
    plan = K.topk_plan(n, b, 28, sms)
    groups = -(-b // 64)
    assert plan.groups == groups
    assert (plan.groups - 1) * 64 < b <= plan.groups * 64
    assert plan.parts == max(1, sms // groups)
    assert (plan.ring, plan.cap, plan.on_chip) == tuple(K.topk_layout(28))


@pytest.mark.parametrize("ring,edge", [(8, 258), (6, 258), (4, 258),
                                       (3, 258)])
def test_topk_lists_on_chip_to_the_edge(ring, edge):
    """K1's lists stay in shared memory beside a ring of the most stages up
    to ``ring`` (down to 3) that leaves them k + 32 places
    (``topk_layout``), with as many places as fit; past the edge that a
    ring of 3 sets (290 places, to k 258) they hold k + 640 in global
    memory beside a ring of ``ring``. The block's shared memory (the ring
    of 24 KB stages: a k-block of 128 bytes of the row tile and 64
    queries; the lists; the static part) stays within the card's 227 KB at
    every k, on chip or not."""
    for k in (1, 16, 28, 60, 112, 136, 210, 211, 258, 259, 1280):
        lay = K.topk_layout(k, ring)
        assert 3 <= lay.ring <= ring
        assert lay.on_chip == (k <= edge)
        assert K.topk_smem(lay) <= K.SMEM_LIMIT
        if not lay.on_chip:
            assert (lay.ring, lay.cap) == (ring, k + K.GLOBAL_SLACK)
            continue
        assert lay.cap >= k + K.LIST_SLACK
        assert K.topk_smem(lay._replace(cap=lay.cap + 1)) > K.SMEM_LIMIT
        if lay.ring < ring:   # the next deeper ring leaves too few places
            deeper = K.Layout(lay.ring + 1, k + K.LIST_SLACK, True)
            assert K.topk_smem(deeper) > K.SMEM_LIMIT
        plan = K.topk_plan(1 << 20, 256, k, 132, ring)
        assert (plan.ring, plan.cap, plan.on_chip) == tuple(lay)


@pytest.mark.parametrize("k,want", [
    (1, (4, 242, True)), (28, (4, 242, True)), (112, (4, 242, True)),
    (136, (4, 242, True)), (210, (4, 242, True)), (211, (3, 290, True)),
    (258, (3, 290, True)), (259, (4, 899, False)),
    (1280, (4, 1920, False))])
def test_topk_layout_at_the_default_ring(k, want):
    """At the library's default ring of 4 stages: lists of 242 places on
    chip to k 210, of 290 beside 3 stages to k 258, then k + 640 in global
    memory."""
    assert tuple(K.topk_layout(k)) == want
    assert K.RING == 4


@pytest.mark.parametrize("b,k", [(1, 1), (256, 28), (256, 112), (300, 211),
                                 (1024, 1280)])
def test_topk_scratch_holds_the_handed_over_lists(b, k):
    """The long scan's one scratch buffer: the (part, query) lists the
    kernel hands to the merge (stride k where the lists were on chip, cap
    where they lived in global memory), their lengths and the merge's
    gather of every part's k a query, 4 bytes each."""
    plan = K.topk_plan(1 << 20, b, k, 132)
    stride = k if plan.on_chip else plan.cap
    assert plan.on_chip == K.topk_layout(k).on_chip == (k <= 258)
    assert K.scratch_bytes(plan, b, k) == 4 * (
        2 * plan.parts * b * stride + plan.parts * b
        + 2 * b * plan.parts * k)


def test_floor_and_extraction_kernels_count_every_f32x3_leg():
    """X6/X8 take every leg of K1, f32x3 included, and X1-X3 every leg the
    experiments take at each precision (int8, bf16, f32 and f32x3 under
    cosine, dot and l2), X4 cosine only; every other leg's stage is the
    row box and one 128-byte query box (the f32x3 plans: below)."""
    from vrod_tpu_torch.ops import cuda_floor as F
    assert F.LEGS == K.LEGS
    assert [n for n in F.launches if "f32x3" in n] == [
        f"fused_theta[f32x3-{m}]" for m in ("cosine", "dot", "l2")]
    for kern in cuda_extract.KERNELS:
        metrics = ("cosine",) if kern.startswith("unroll") \
            else ("cosine", "dot", "l2")
        assert [n for n in cuda_extract.launches
                if n.startswith(f"extract_{kern}[f32x3")] == [
            f"extract_{kern}[f32x3-{m}]" for m in metrics]
    assert K.stage_bytes(cuda_extract.NARROW) \
        == 128 * 128 + cuda_extract.NARROW * 128


# -- the f32x3 legs' stages (score.cuh's Walk) -------------------------------


@pytest.mark.parametrize("width,split,want", [
    (16, False, 18432), (16, True, 20480), (64, False, 24576),
    (64, True, 32768), (128, False, 32768), (128, True, 49152),
    (256, False, 49152), (256, True, 49152)])
def test_stage_bytes_by_width_and_leg(width, split, want):
    """A ring stage is the 16 KB row box and the box of the group's
    queries; on the f32x3 legs groups of up to 128 queries take the big
    and the small parts of their queries in one stage (one walk of the row
    k-blocks), while groups of 256 take them a stage each (the stage of
    both would be 80 KB)."""
    assert K.stage_bytes(width, split) == want
    assert want % 1024 == 0


@pytest.mark.parametrize("k,want", [
    (1, (4, 178, True)), (24, (4, 178, True)), (108, (4, 178, True)),
    (146, (4, 178, True)), (147, (3, 242, True)), (210, (3, 242, True)),
    (211, (4, 851, False)), (1280, (4, 1920, False))])
def test_topk_layout_at_the_default_ring_f32x3(k, want):
    """The f32x3 legs' gated core (K1 without a floor, X6/X8): 32 KB
    stages (the row box and 64 queries' big and small parts), 4 of them
    beside lists of 178 places on chip to k 146, 3 beside lists of 242 to
    k 210, then k + 640 in global memory beside 4; at a ring of 3 the
    lists hold 242 from k 1. K1's plan and fused_theta's take that
    layout."""
    from vrod_tpu_torch.ops import cuda_floor as F
    assert tuple(K.topk_layout(k, split=True)) == want
    three = K.topk_layout(k, 3, True)
    assert (three.ring, three.on_chip) == (3, want[2])
    assert three.cap == (242 if want[2] else want[1])
    four = K.Layout(4, 178, True)
    assert K.topk_smem(four, True) <= K.SMEM_LIMIT \
        < K.topk_smem(four._replace(cap=179), True)
    plan = K.topk_plan(1 << 20, 256, k, 132, split=True)
    assert (plan.ring, plan.cap, plan.on_chip) == want
    if 128 * 16 >= 2 * k:
        assert tuple(F.theta_plan(1 << 20, 256, k, 8192, 16, 132,
                                  split=True)[:5]) == plan


@pytest.mark.parametrize("split", [False, True])
def test_topk_smem_within_the_card_at_every_k(split):
    """At every k from 1 to 1280 the long scan's layout (on chip or not)
    fits a block's 232,448 bytes, lists on chip hold k + 32 places at
    least and one place more would not fit, and a ring one stage deeper
    (to RING) would leave the lists too few places."""
    for k in range(1, 1281):
        lay = K.topk_layout(k, split=split)
        assert K.topk_smem(lay, split) <= K.SMEM_LIMIT == 232448, k
        if not lay.on_chip:
            continue
        assert lay.cap >= k + K.LIST_SLACK
        assert K.topk_smem(lay._replace(cap=lay.cap + 1), split) \
            > K.SMEM_LIMIT
        assert lay.ring <= K.RING
        if lay.ring < K.RING:
            deeper = K.Layout(lay.ring + 1, k + K.LIST_SLACK, True)
            assert K.topk_smem(deeper, split) > K.SMEM_LIMIT


@pytest.mark.parametrize("k,carry,store,gate", [
    (1, (32, True), (112, True), (178, True)),
    (80, (32, True), (112, True), (178, True)),
    (81, (32, True), (81 + 640, False), (178, True)),
    (108, (32, True), (108 + 640, False), (178, True)),
    (130, (32, True), (130 + 640, False), (178, True)),
    (131, (16, True), (131 + 640, False), (178, True)),
    (146, (16, True), (146 + 640, False), (178, True)),
    (147, (16, True), (147 + 640, False), (147 + 640, False)),
    (162, (16, True), (162 + 640, False), (162 + 640, False)),
    (163, (16, False), (163 + 640, False), (163 + 640, False))])
def test_extract_plans_f32x3(k, carry, store, gate):
    """The extraction kernels' f32x3 plans, beside 4 stages of 32 KB: X2's
    carry on chip with stages of 32 places to k 130 and of 16 to k 162;
    the store's lists of 112 places (beside its score tile) to k 80; the
    gated kernels' lists of 178 to k 146; past each edge global memory.
    ``extract_plan`` takes them where the call is split."""
    assert K.stage_bytes(cuda_extract.NARROW, True) == 32768
    assert cuda_extract.carry_plan(k, True) == carry
    assert cuda_extract.store_plan(k, True) == store
    assert cuda_extract.gate_plan(k, True) == gate
    for kernel, (_, on_chip) in (("carry", carry), ("store", store),
                                 ("gate", gate), ("pingpong", gate)):
        plan = cuda_extract.extract_plan(kernel, 1 << 20, 256, k, 132,
                                         split=True)
        assert plan.on_chip == on_chip, kernel


@pytest.mark.parametrize("split", [False, True])
def test_extract_smem_within_the_card_at_every_k(split):
    """At every k from 1 to 1280 each extraction plan's shared memory
    fits a block's 232,448 bytes, and lists on chip take k + 32 places."""
    for k in range(1, 1281):
        stage, on_chip = cuda_extract.carry_plan(k, split)
        assert cuda_extract.carry_smem(k, stage, on_chip, split) \
            <= cuda_extract.SMEM_BYTES
        for plan, smem in ((cuda_extract.store_plan, cuda_extract.store_smem),
                           (cuda_extract.gate_plan, cuda_extract.gate_smem)):
            cap, on_chip = plan(k, split)
            assert smem(cap, on_chip, split) <= cuda_extract.SMEM_BYTES
            assert cap >= k + cuda_extract.STORE_SLACK


@pytest.mark.parametrize("split", [False, True])
def test_small_scan_and_submax_rings_fit(split):
    """K1's small scan (4 stages of 16 queries and their lists) and K3's
    rings (whole stages within 192 KB, 6 or 4 of them at f32x3) fit a
    block, and the freed ring holds the small scan's merge and K3's
    maxima."""
    assert K.small_smem(K.SMALL_MAX_K, split) <= K.SMEM_LIMIT
    assert K.MAX_CLUSTER * K.SMALL_MAX_K * 8 * 8 \
        <= K.SMALL_RING * K.stage_bytes(K.SMALL_GROUP, split)
    for width in K.SUBMAX_GROUPS:
        smem = K.submax_smem(width, split)
        stages = (smem - 1024) // K.stage_bytes(width, split)
        assert smem <= 227 * 1024 and width * 128 * 4 <= smem - 1024
        assert stages == {(64, False): 8, (128, False): 6, (64, True): 6,
                          (128, True): 4}[width, split]


@pytest.mark.parametrize("n,b,blk", [(131072, 256, 8192),
                                     (131072, 256, 16384),
                                     (32768, 256, 16384), (65536, 40, 2048)])
def test_submax_plan_f32x3_takes_groups_of_64(n, b, blk):
    """K3 on the f32x3 legs takes query groups of 64 at every shape (its
    n128 build's stages of both query halves leave the consumers too few
    registers), with the segments of the other legs' 64-wide plan."""
    width, groups, spb = K.submax_plan(n, b, blk, 132, split=True)
    assert width == 64 and groups == -(-b // 64)
    saved = K.SUBMAX_GROUPS
    try:
        K.SUBMAX_GROUPS = (64, 64)
        assert K.submax_plan(n, b, blk, 132) == (width, groups, spb)
    finally:
        K.SUBMAX_GROUPS = saved
