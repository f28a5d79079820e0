"""The launch path of K1 and K3 on the CPU (ops/cuda_topk.py): K3's cluster
plan, K1's small-scan plan and where it takes over from the long scan, the
tensor-map cache's key, and the mask the kernels now read from ``valid`` and
``row_bias`` themselves, held to the mask the plain versions build and to
``vrod_tpu``'s search after every write, delete and growth. Also the split
query of the f32x3 leg (float32 rows at "high"/"exact") as the floor and
extraction wrappers hand it to their kernels."""

import numpy as np
import pytest
import torch

from vrod_tpu_torch.ops import cuda_topk as K

SMS = (132, 114, 7, 1)


@pytest.mark.parametrize("n,blk", [(32768, 16384), (16384, 16384),
                                   (65536, 1024), (8192, 4096), (256, 256),
                                   (131072, 16384), (1_048_576, 8192),
                                   (131072, 2048)])
@pytest.mark.parametrize("b", [1, 64, 200, 256, 512])
@pytest.mark.parametrize("sms", SMS)
def test_submax_clusters_score_every_tile_once(n, blk, b, sms):
    """Each (row block, query group) pair is one cluster of spb blocks:
    spb a portable cluster size that divides the block's tiles and the
    group's queries (each block reduces an equal share of them), the
    segments of a pair score each of its tiles once, the grid stays within
    one block per SM where the pairs allow, the wider group only where its
    grid is as large, and the block fits its shared memory."""
    width, groups, spb = K.submax_plan(n, b, blk, sms)
    pairs = (n // blk) * groups
    assert width in K.SUBMAX_GROUPS
    assert groups * width >= b > (groups - 1) * width
    assert 1 <= spb <= K.MAX_CLUSTER and spb & (spb - 1) == 0
    assert (blk // K.TILE_ROWS) % spb == 0 and width % spb == 0
    assert pairs * spb <= max(sms, pairs)
    if spb < K.MAX_CLUSTER and (blk // K.TILE_ROWS) % (2 * spb) == 0:
        assert pairs * 2 * spb > sms    # the largest that fits
    hits = np.zeros(n // K.TILE_ROWS, dtype=np.int64)
    for j in range(n // blk):
        for sg in range(spb):
            tiles = K.submax_tiles(j, sg, blk, spb)
            assert all(j * blk <= t * K.TILE_ROWS < (j + 1) * blk
                       for t in tiles)
            hits[list(tiles)] += 1
    assert (hits == 1).all()
    for w in K.SUBMAX_GROUPS:
        # The ring and, after the scan, the block's maxima in it.
        assert K.submax_smem(w) <= 227 * 1024
        assert w * 128 * 4 <= K.submax_smem(w) - 1024


def test_submax_width_follows_the_grid():
    """The headline's int8 sample (2 blocks of 16,384 at b256) takes groups
    of 64 (8 clusters of 8 blocks; 128 would give 32 blocks); (iii)'s bf16
    sample (8 blocks) takes 128 at the same 128 blocks."""
    assert K.submax_plan(32768, 256, 16384, 132) == (64, 4, 8)
    assert K.submax_plan(131072, 256, 16384, 132) == (128, 2, 8)


@pytest.mark.parametrize("n", [1, 127, 128, 129, 1000, 8192, 16384, 32768,
                               65536, 67456, 67457, 131072, 1_048_576])
@pytest.mark.parametrize("b", [1, 40, 256, 300, 512])
@pytest.mark.parametrize("sms", SMS)
def test_small_plan_takes_short_scans_and_covers_every_tile(n, b, sms):
    """The small scan takes exactly the scans that would give each of sms
    // ceil(b / SMALL_SPAN) blocks fewer than SMALL_TILES tiles (k up to
    SMALL_MAX_K); every query group is one cluster whose parts walk every
    row tile once, in ascending order, SMALL_TILES or more each where there
    are that many; its lists (SMALL_CAP, cut only when full) and ring fit a
    block's shared memory."""
    tiles = -(-n // K.TILE_ROWS)
    spread = max(1, sms // -(-b // K.SMALL_SPAN))
    plan = K.small_plan(n, b, 28, sms)
    assert (plan is not None) == (tiles < spread * K.SMALL_TILES)
    if plan is None:
        return
    groups, parts, cap = plan
    assert groups * K.SMALL_GROUP >= b > (groups - 1) * K.SMALL_GROUP
    assert 1 <= parts <= K.MAX_CLUSTER
    # A list of SMALL_CAP takes a warp's worth past any k it serves, and
    # a cut of it is the warp bitonic sort (at most 256 entries).
    assert cap == K.SMALL_CAP <= 256
    assert cap >= K.SMALL_MAX_K + K.LIST_SLACK
    hits = np.zeros(tiles, dtype=np.int64)
    for p in range(parts):
        walk = list(K.part_tiles(p, parts, n))
        assert walk == sorted(walk)
        assert len(walk) >= min(K.SMALL_TILES, tiles // parts)
        hits[walk] += 1
    assert (hits == 1).all()
    assert K.small_smem(28) <= K.SMEM_LIMIT


@pytest.mark.parametrize("b,last", [(256, 67456), (1, 67456),
                                    (300, 33664), (512, 33664),
                                    (1024, 16768)])
def test_small_plan_switch_point_and_k(b, last):
    """At 132 SMs the small scan takes scans up to 132 // ceil(b / 256) x
    SMALL_TILES - 1 tiles (b1 to b256: 527 tiles, 67,456 rows; b512: 263
    tiles; b1024: 131) and k up to SMALL_MAX_K, whose lists still fit; the
    K2 shapes (8,192 rows) take it at every batch."""
    assert K.small_plan(last, b, 28, 132) is not None
    assert K.small_plan(last + 1, b, 28, 132) is None
    assert K.small_plan(8192, b, 28, 132) == (-(-b // 16), 8, K.SMALL_CAP)
    assert K.small_plan(8192, 256, K.SMALL_MAX_K, 132) is not None
    assert K.small_plan(8192, 256, K.SMALL_MAX_K + 1, 132) is None
    assert K.small_smem(K.SMALL_MAX_K) <= K.SMEM_LIMIT
    # The merge gathers parts x k candidates a warp into the freed ring.
    assert K.MAX_CLUSTER * K.SMALL_MAX_K * 8 * 8 <= \
        K.SMALL_RING * K.stage_bytes(K.SMALL_GROUP)


def test_tensor_map_cache_keys_on_everything_encoded():
    calls = []

    def encode(*key):
        calls.append(key)
        return object(), 1000 + len(calls)

    maps = K.TensorMaps(encode, size=4)
    base = (0x7000_0000, 768, 1_048_576, 768, 128)
    a = maps.get(*base)
    assert maps.get(*base) == a and len(calls) == 1
    # A changed pointer, inner extent, rows, stride or box: a new entry.
    for i, v in enumerate((0x7000_0400, 96, 8192, 1536, 64)):
        key = base[:i] + (v,) + base[i + 1:]
        assert maps.get(*key) != a
        assert calls[-1] == key
    assert len(calls) == 6 and len(maps) == 4   # the least recent went
    assert maps.get(*base) != a and len(calls) == 7


def test_call_maps_follow_the_query_layout():
    """The maps a launch takes: rows in 128-row boxes, queries in boxes of
    the block's group, and a second query map for the packed and split
    queries (the high half at row_bytes)."""
    seen = []

    def encode(*key):
        seen.append(key)
        return None, len(seen)

    old = K.tensor_maps
    K.tensor_maps = K.TensorMaps(encode)
    try:
        x = torch.zeros((256, 48), dtype=torch.int8)    # packed int4 d 96
        q = torch.zeros((40, 96), dtype=torch.int8)
        call = K._Call(x, torch.ones(256), torch.ones(256, dtype=torch.bool),
                       q, "cosine", None, None, True)
        x_map, q_map, q_hi = call.maps(64)
        assert seen == [(x.data_ptr(), 48, 256, 48, 128),
                        (q.data_ptr(), 48, 40, 96, 64),
                        (q.data_ptr() + 48, 48, 40, 96, 64)]
        assert (x_map, q_map, q_hi) == (1, 2, 3)
        xf = torch.zeros((256, 96), dtype=torch.float32)
        call = K._Call(xf, torch.ones(256), torch.ones(256, dtype=torch.bool),
                       torch.zeros((40, 96)), "dot", None, None, False)
        assert call.maps(K.GROUP_QUERIES)[2] is None
        assert seen[-1][1:] == (384, 40, 384, 64)
        x30 = torch.zeros((256, 30), dtype=torch.int8)   # no TMA
        call = K._Call(x30, torch.ones(256),
                       torch.ones(256, dtype=torch.bool),
                       torch.zeros((4, 30), dtype=torch.int8), "dot", None,
                       None, False)
        assert call.maps(64) == (None, None, None)
    finally:
        K.tensor_maps = old


@pytest.mark.parametrize("bias", [False, True])
def test_kernel_mask_inputs_are_the_plain_mask(bias):
    """What the kernels read (valid, row_bias: csrc/score.cuh RowMask) is
    the plain versions' mask: -inf on a dead slot, else the bias, else 0;
    and nothing builds the mask unless a plain version asks for it."""
    rng = np.random.default_rng(3)
    n = 300
    valid = torch.from_numpy(rng.random(n) < 0.7)
    rb = torch.from_numpy(-rng.random(n).astype(np.float32)) if bias \
        else None
    x = torch.from_numpy(rng.integers(-127, 128, (n, 32), dtype=np.int8))
    q = torch.from_numpy(rng.integers(-127, 128, (5, 32), dtype=np.int8))
    qs = torch.ones(5) if bias else None
    call = K._Call(x, torch.ones(n), valid, q, "l2" if bias else "cosine",
                   rb, qs, False)
    assert call._mask is None
    want = torch.where(valid, rb if bias else torch.zeros(n),
                       float("-inf"))
    assert torch.equal(call.mask, want)
    ptrs = call.pointers()
    assert ptrs[1:3] == (call.aux.data_ptr(), valid.data_ptr())
    assert ptrs[3] == (rb.data_ptr() if bias else None)
    assert ptrs[5] == (qs.data_ptr() if bias else None)


@pytest.mark.parametrize("precision", ["fast", "high", "exact"])
@pytest.mark.parametrize("metric", ["cosine", "dot", "l2"])
def test_split_query_of_the_float32_legs(precision, metric):
    """float32 rows at "high"/"exact" go to every kernel as leg f32x3 with
    the query split into its TF32 big then small parts, (B, 2D), read
    through two maps of the block's group (the second at row_bytes, both
    at the split row's stride): K1's and X6/X8's ``_Call`` and X1-X4's
    ``_XCall`` alike, and the experiments' plain scores are K1's. At
    "fast" the leg is f32 with the query rounded to TF32. The CPU runs
    the plain versions and counts no launch."""
    from vrod_tpu_torch.ops import cuda_extract as X
    from vrod_tpu_torch.ops import cuda_floor as F
    rng = np.random.default_rng(5)
    n, d, b = 2048, 96, 40
    x = torch.from_numpy(rng.standard_normal((n, d), dtype=np.float32))
    q = torch.from_numpy(rng.standard_normal((b, d), dtype=np.float32))
    aux = torch.from_numpy(rng.uniform(0.5, 2.0, n).astype(np.float32))
    valid = torch.from_numpy(rng.random(n) < 0.9)
    split = precision != "fast"
    kind = "f32x3" if split else "f32"
    call = K._Call(x, aux, valid, q, metric, None, None, False, precision)
    xcall = X._XCall(x, aux[None], call.mask[None], q,
                     torch.zeros(1, dtype=torch.int32), k=8, metric=metric,
                     block_rows=1024, precision_name=precision)
    assert call.leg == xcall.leg == f"{kind}-{metric}"
    assert call.elem == xcall.elem == {"f32": 3, "f32x3": 4}[kind]
    want_q = torch.cat(K.split_tf32(q), dim=1) if split else K.tf32_round(q)
    assert torch.equal(call.q, want_q) and torch.equal(xcall.q, want_q)
    assert torch.equal(xcall.scores(0, n), call.scores(0, n))
    seen = []

    def encode(*key):
        seen.append(key)
        return None, len(seen)

    old = K.tensor_maps
    K.tensor_maps = K.TensorMaps(encode)
    try:
        maps = call.maps(K.GROUP_QUERIES)
    finally:
        K.tensor_maps = old
    rb, qrow = 4 * d, call.q.shape[1] * 4
    assert seen[:2] == [(x.data_ptr(), rb, n, rb, 128),
                        (call.q.data_ptr(), rb, b, qrow, 64)]
    if split:
        assert seen[2] == (call.q.data_ptr() + rb, rb, b, qrow, 64)
    else:
        assert maps[2] is None and len(seen) == 2
    F.reset_launches()
    X.reset_launches()
    F.fused_theta(x, aux, valid, q, k=8, metric=metric, block_rows=1024,
                  s_blocks=1, precision=precision)
    X.kexp_call("gate", x, aux[None], call.mask[None], q,
                torch.zeros(1, dtype=torch.int32), k=8, metric=metric,
                block_rows=1024, precision_name=precision)
    assert not any(F.launches.values()) and not any(X.launches.values())
