"""The port's extraction experiments: the counterparts of the JAX package's
A/B experiments kexp (X1), kexp2 (X2), kexp3 (X3) and kexp5 (X4), each a
variant of K1 that its harness runs as ``make_call(...)(x, aux2d, mask2d,
q, offset)``. The engine does not call them, as ``vrod_tpu/engine.py``
does not; ``tools/kexp_extract.py`` is their A/B entry point.

One function per experiment, with the JAX function's arguments: x (N, D)
int8 (int8 query), bfloat16 or float32 rows; aux2d and mask2d (1, N)
float32; q (B, D); offset (1,) int32. Each scans whole blocks of
``block_rows`` rows only (rows after the last whole block are never read),
scores ``epi(g) + mask`` with the experiments' epilogue for every row
dtype (cosine ``g * aux``, l2 ``2g - aux``, dot ``g``; for int8 rows g is
the exact int32 dot, not K1's scaled one), and returns the exact top-k by
(value desc, slot asc) as (values (B, k) f32, slots (B, k) i32), slots
``col + offset[0]``, (-inf, -1) on empty ranks:

- ``kexp_call(variant)`` (X1): ``floor`` returns (B, k) filled with each
  query's max score over the whole blocks and ids -1 (the scan's floor, not
  a top-k); ``base``/``maxref`` run the store mode (every score of a tile
  stored in shared memory, then only those above the query's running k-th
  appended to its list, which is cut when full); ``gate``, ``nostore``,
  ``argmax`` and ``subdot`` run the gate mode (every score held in its
  register against its query's running k-th, the passing ones appended to
  its list, cut when full; on the TPU they differ in Mosaic's stores and
  argmax, on the H100 they share one build);
- ``kexp2_call(tiles, count)`` (X2): the running top-k carried sorted per
  query in shared memory and merged in place, a tile's passing scores at a
  time; also returns ``cnt`` (1,) int32, kexp2's
  while-iteration count under ``KEXP_COUNT=1`` when ``count``, else 0;
- ``kexp3_call`` (X3): the gate mode with the gate of one tile under the
  tensor cores' work on the next;
- ``kexp5_call(variant)`` (X4, cosine only): ``nostore`` is the gate mode
  (the X1 gate build), ``unroll2``/``unroll4`` the same with one
  warp-uniform branch per 2 or 4 query pairs.

The query is read as the experiments cast it (``q.astype(x.dtype)``): int8
rows need an int8 query (a float one raises); bfloat16 rows round it to
bfloat16 (to nearest even); float32 rows score as K1 scores them: in TF32
at ``precision_name="fast"`` (both operands rounded to nearest,
``cuda_topk.tf32_round``) and at "high" and "exact" (the experiments'
HIGH and HIGHEST) in three TF32 products, leg ``f32x3``
(``cuda_topk.split_tf32``: the query goes to the card as its big then its
small TF32 parts, (B, 2D)), on the card and in the plain versions alike.
Packed int4 rows are not accepted: the experiments unpack no nibbles.

Rows of any width are taken, as the experiments take them. Each wrapper
validates its inputs and dispatches on the device of the tensors: a CPU
tensor goes to its ``*_plain`` twin, a CUDA tensor launches the
hand-written CUDA kernel of its mode (``csrc/extract_<mode>.cu``, see
``csrc/extract.cuh``) or raises. Each mode has two builds, picked by shape
as K1's are (``cuda_topk.copy_granule``): rows of whole 16-byte units at
16-byte aligned bases (rows and the query as the kernel reads it) load by
TMA; any other rows (int8 dim 30 or 100, bfloat16 dim 100, float32 dim 25,
an unaligned view) take the same kernel with the producer warpgroup
copying each stage by the granule the shape allows
(``csrc/extract_<mode>_copy.cu``). Rows are never padded into a
TMA shape. No wrapper falls back, and no mode maps to K1's build at run
time. ``launches`` counts kernel launches per kernel and leg (e.g.
``extract_carry[bf16-l2]``, ``extract_unroll4[int8-cosine]``), and
``copy_launches``, with the same keys, those of them that took the copying
build; only a CUDA launch adds to them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import _build
from . import cuda_topk as K
from . import distances as D

NEG_INF = float("-inf")
# The row kinds (f32x3: float32 rows at "high" and "exact") and metrics.
X_DTYPES = ("int8", "bf16", "f32", "f32x3")
X_METRICS = ("cosine", "dot", "l2")
PRECISIONS = ("fast", "high", "exact")
# score.cuh's Epi codes of the experiments' epilogues.
_X_EPI = {"cosine": 0, "l2": 2, "dot": 3}

# The kernels: name -> (mode, branch unroll E), the mode's build being
# csrc/extract_<mode>.cu; and each variant name's kernel. The mapping is
# fixed here: every name of a kernel shares its build.
KERNELS = {"floor": ("floor", 1), "store": ("store", 1),
           "gate": ("gate", 1), "unroll2": ("unroll", 2),
           "unroll4": ("unroll", 4), "pingpong": ("pingpong", 1),
           "carry": ("carry", 1)}
KEXP_VARIANTS = {"floor": "floor", "base": "store", "maxref": "store",
                 "gate": "gate", "nostore": "gate", "argmax": "gate",
                 "subdot": "gate"}
KEXP5_VARIANTS = {"nostore": "gate", "unroll2": "unroll2",
                  "unroll4": "unroll4"}


def kernel_legs(kernel: str) -> tuple[str, ...]:
    """The legs a kernel takes (X4's unrolled builds: cosine only)."""
    metrics = ("cosine",) if kernel.startswith("unroll") else X_METRICS
    return tuple(f"{d}-{m}" for d in X_DTYPES for m in metrics)


launches = {f"extract_{kern}[{leg}]": 0 for kern in KERNELS
            for leg in kernel_legs(kern)}
copy_launches = dict(launches)


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0
        copy_launches[name] = 0


# -- Launch plans ------------------------------------------------------------

SMEM_BYTES = 232448         # a block's shared memory on the H100 (227 KB)
RING = 4                    # stages of every kernel's ring (topk.cuh: kRing)
# The query group of every kernel but the floor (wgmma n64; extract.cuh:
# kNarrow): n64 measured faster than n128 for the store, the carry and the
# gate at every k of the smoke (PERF.md; each warp merges, extracts or cuts
# for 8 queries a tile, not 16), though each block reads its rows for
# fewer queries. The carry's stage sizes, largest first (places a query,
# each of two buffers).
NARROW = 64
CARRY_STAGES = (32, 16)
# X1's floor: queries per block (wgmma n256, score.cuh's kGroup).
FLOOR_GROUP = 256
STORE_PITCH = 132           # floats a query row of the store's score tile
# A store or gate list holds k + 32 at least: after a cut, one more chunk
# of 32.
STORE_SLACK = 32
# Static shared memory of each kernel (extract.cuh's __shared__ arrays):
# the ring's 8 barriers; X2's gates and two buffers' stage counts; the
# store's and the gated kernels' gates, list lengths and 8 warps' 256-bin
# select counters. The card tests hold carry_smem/store_smem/gate_smem,
# these included, to the library's vrod_extract_{carry,store,gate}_smem.
CARRY_STATIC_BYTES = 8 * 8 + 3 * NARROW * 4
STORE_STATIC_BYTES = 8 * 8 + 2 * NARROW * 4 + 8 * 256 * 4
GATE_STATIC_BYTES = STORE_STATIC_BYTES


class XPlan(NamedTuple):
    """A kernel's launch plan (``extract_plan``)."""
    groups: int     # query groups of `width`
    parts: int      # row parts: block (part, group) walks tiles part, +parts
    cap: int        # a (part, query) list's capacity; X2: k, its carry
    on_chip: bool   # the lists or X2's carry in shared memory
    width: int      # queries a block: NARROW, or K1's group (the floor)
    stage: int      # X2: places of a query's stage (0 for the others)


def carry_smem(k: int, stage: int, on_chip: bool = True,
               split: bool = False) -> int:
    """X2's shared memory a block (csrc/extract.cuh: narrow_smem, plus the
    static part): the ring (``cuda_topk.stage_bytes``; ``split``: the
    f32x3 legs', whose stages hold both query halves),
    two stages of ``stage`` places a query, and the carry (NARROW x k
    values and slots) when on chip."""
    return (1024 + RING * K.stage_bytes(NARROW, split)
            + 2 * NARROW * stage * 8
            + (NARROW * k * 8 if on_chip else 0) + CARRY_STATIC_BYTES)


def carry_plan(k: int, split: bool = False) -> tuple[int, bool]:
    """X2's (stage, on_chip) for top-k: the largest stage at which the
    carry fits in shared memory beside a 4-stage ring (32 to k 194, 16 to
    k 226; at f32x3 32 to k 130, 16 to k 162); past that the carry in
    global memory (L2) with the least stage."""
    for stage in CARRY_STAGES:
        if carry_smem(k, stage, True, split) <= SMEM_BYTES:
            return stage, True
    return CARRY_STAGES[-1], False


def store_smem(cap: int, on_chip: bool = True, split: bool = False) -> int:
    """The store's shared memory a block (as ``carry_smem``): the ring,
    the score tile (NARROW x STORE_PITCH floats) and the lists (NARROW x
    cap values and slots) when on chip."""
    return (1024 + RING * K.stage_bytes(NARROW, split)
            + NARROW * STORE_PITCH * 4
            + (NARROW * cap * 8 if on_chip else 0) + STORE_STATIC_BYTES)


def store_plan(k: int, split: bool = False) -> tuple[int, bool]:
    """The store's (cap, on_chip) for top-k: lists of as many entries as
    fit in shared memory beside the ring and the score tile (176; at f32x3
    112), where that is k + 32 at least (to k 144; at f32x3 80); else the
    lists in global memory with K1's capacity there (k +
    ``cuda_topk.GLOBAL_SLACK``)."""
    room = (SMEM_BYTES - store_smem(0, True, split)) // (NARROW * 8)
    if room >= k + STORE_SLACK:
        return room, True
    return k + K.GLOBAL_SLACK, False


def gate_smem(cap: int, on_chip: bool = True, split: bool = False) -> int:
    """The gated kernels' shared memory a block (X1's gate, X3, X4; as
    ``carry_smem``): the ring and the lists (NARROW x cap values and
    slots) when on chip; no score tile."""
    return (1024 + RING * K.stage_bytes(NARROW, split)
            + (NARROW * cap * 8 if on_chip else 0) + GATE_STATIC_BYTES)


def gate_plan(k: int, split: bool = False) -> tuple[int, bool]:
    """The gated kernels' (cap, on_chip) for top-k: lists of as many
    entries as fit in shared memory beside the ring (242; at f32x3 178),
    where that is k + 32 at least (to k 210; at f32x3 146); else the lists
    in global memory with K1's capacity there (k +
    ``cuda_topk.GLOBAL_SLACK``)."""
    room = (SMEM_BYTES - gate_smem(0, True, split)) // (NARROW * 8)
    if room >= k + STORE_SLACK:
        return room, True
    return k + K.GLOBAL_SLACK, False


def extract_plan(kernel: str, n: int, b: int, k: int, sms: int,
                 count: bool = False, split: bool = False) -> XPlan:
    """A kernel's grid for n rows (whole blocks), b queries, top-k on
    ``sms`` SMs. The floor runs groups of FLOOR_GROUP queries in about one
    block per SM, one max a part and query (cap 0). The others
    take groups of NARROW in as many parts as leave about one block per
    SM, with the lists of ``store_plan`` or of ``gate_plan`` (gate,
    unroll2/4, pingpong), or X2's carry (``carry_plan``), sized by the
    leg's stages (``split``: the f32x3 legs'). With ``count``
    X2 runs one part per query group, so that it walks the rows in global
    order."""
    if kernel not in KERNELS:
        raise ValueError(f"kernel {kernel!r}: expected one of "
                         f"{tuple(KERNELS)}")
    mode = KERNELS[kernel][0]
    if mode == "floor":
        groups = -(-b // FLOOR_GROUP)
        parts = max(1, min(-(-n // K.TILE_ROWS), sms // groups))
        return XPlan(groups, parts, 0, False, FLOOR_GROUP, 0)
    stage = 0
    if mode == "store":
        cap, on_chip = store_plan(k, split)
    elif mode == "carry":
        cap = k
        stage, on_chip = carry_plan(k, split)
    else:
        cap, on_chip = gate_plan(k, split)
    groups = -(-b // NARROW)
    parts = 1 if count and mode == "carry" else \
        max(1, min(-(-n // K.TILE_ROWS), sms // groups))
    return XPlan(groups, parts, cap, on_chip, NARROW, stage)


def scratch_sizes(kernel: str, plan: XPlan, b: int, k: int, nblocks: int,
                  count: bool = False) -> dict[str, int]:
    """The elements of each scratch tensor of a launch: the (part, query)
    lists handed to the merge (``cand``: stride k where the lists or X2's
    carry stayed on chip, else the plan's capacity; the floor: one max a
    part and query), their lengths, X2's per-block counts and the merge's
    gather (``merge``: every part's k a query)."""
    mode = KERNELS[kernel][0]
    stride = k if mode == "carry" or plan.on_chip else plan.cap
    lists = plan.parts * b * stride
    return {"cand_v": plan.parts * b if mode == "floor" else lists,
            "cand_i": max(lists, 1), "cand_n": plan.parts * b,
            "cnt": nblocks * b if count else 1,
            "merge": b * plan.parts * k}


# -- Validation and the plain scores ---------------------------------------


class _XCall:
    """A validated experiment call: the leg, the whole blocks, and the
    inputs as the kernels and the plain versions take them."""

    def __init__(self, x, aux2d, mask2d, q, offset, *, k, metric, block_rows,
                 precision_name, packed=False, cosine_only=False):
        if packed:
            raise TypeError("packed int4 rows are not accepted: the "
                            "experiments score their rows as stored and "
                            "unpack no nibbles")
        if metric not in X_METRICS:
            raise ValueError(f"metric {metric!r}: expected one of "
                             f"{X_METRICS}")
        if cosine_only and metric != "cosine":
            raise ValueError(f"kexp5's only epilogue is cosine (g * aux + "
                             f"mask), not {metric!r}")
        if precision_name not in PRECISIONS:
            raise ValueError(f"precision_name {precision_name!r}: expected "
                             f"one of {PRECISIONS}")
        if x.dim() != 2 or x.dtype not in (torch.int8, torch.bfloat16,
                                           torch.float32):
            raise TypeError(f"x must be (N, D) int8, bfloat16 or float32, "
                            f"got {tuple(x.shape)} {x.dtype}")
        if q.dim() != 2 or q.shape[1] != x.shape[1]:
            raise ValueError(f"q must be (B, {x.shape[1]}), got "
                             f"{tuple(q.shape)}")
        self.quant = x.dtype == torch.int8
        if self.quant and q.dtype != torch.int8:
            raise TypeError(f"int8 rows require an int8 query (the "
                            f"experiments cast q to the row dtype, which "
                            f"would truncate a float one), got {q.dtype}")
        if not self.quant and not q.is_floating_point():
            raise TypeError(f"{x.dtype} rows take a float query, got "
                            f"{q.dtype}")
        self.n, self.b = x.shape[0], q.shape[0]
        for name, t in (("aux2d", aux2d), ("mask2d", mask2d)):
            if t.numel() != self.n or t.dtype != torch.float32:
                raise ValueError(f"{name} must be (1, {self.n}) float32, got "
                                 f"{tuple(t.shape)} {t.dtype}")
        if not torch.is_tensor(offset) or offset.numel() != 1 \
                or offset.dtype != torch.int32:
            raise ValueError("offset must be a (1,) int32 tensor")
        if block_rows <= 0 or block_rows % K.TILE_ROWS:
            raise ValueError(f"block_rows ({block_rows}) must be a positive "
                             f"multiple of {K.TILE_ROWS}")
        if k < 1:
            raise ValueError("k must be >= 1")
        ts = (x, aux2d, mask2d, q, offset)
        devs = {t.device for t in ts}
        if len(devs) != 1:
            raise ValueError(f"inputs on several devices: {devs}")
        if not all(t.is_contiguous() for t in ts):
            raise ValueError("inputs must be contiguous")
        self.device = x.device
        if self.device.type not in ("cpu", "cuda"):
            raise ValueError(f"unsupported device {self.device}")
        self.k, self.metric, self.block_rows = k, metric, block_rows
        self.nblocks = self.n // block_rows
        self.n_scan = self.nblocks * block_rows
        self.x, self.offset = x, offset
        self.aux, self.mask = aux2d.reshape(self.n), mask2d.reshape(self.n)
        # float32 rows at "high"/"exact": three TF32 products (f32x3).
        kind = K._row_kind(x, False, precision_name)
        self.split = kind == "f32x3"
        self.elem = K._ELEM[kind]
        self.leg = f"{kind}-{metric}"
        self.epi = _X_EPI[metric]
        if self.quant:
            self.q = q
        elif x.dtype == torch.bfloat16:
            self.q = q.to(torch.bfloat16).contiguous()
        elif self.split:
            self.q = torch.cat(K.split_tf32(q), dim=1).contiguous()
        else:
            self.q = K.tf32_round(q)
        # The build on the card: TMA (granule 16), or the copying producer
        # by its granule (f32x3: the query as the kernel reads it, the
        # split (B, 2D) copy).
        self.granule = K.copy_granule(x, self.q, self.row_bytes)
        self.tma = self.granule == 16

    @property
    def row_bytes(self) -> int:
        return self.x.shape[1] * self.x.element_size()

    def scores(self, lo, hi):
        """Plain scores (B, hi - lo) of rows [lo, hi): the inputs rounded as
        the kernels round them, then the epilogue and the mask, each op
        rounded once."""
        x = self.x[lo:hi]
        if self.split:
            g = K.split_dots(self.q, x)
        else:
            if x.dtype == torch.float32:
                x = K.tf32_round(x)
            g = D._matmul_f32(self.q, x)  # int8: exact; bf16: exact products
        aux = self.aux[lo:hi][None, :]
        if self.metric == "cosine":
            s = g * aux
        elif self.metric == "l2":
            s = 2.0 * g - aux
        else:
            s = g
        return s + self.mask[lo:hi][None, :]

    def chunk(self, count=False) -> int:
        """Rows per plain step: whole blocks, one at a time for a count."""
        if count:
            return self.block_rows
        per = K._PLAIN_SCORE_ELEMS // max(self.b, 1)
        return max(self.block_rows, per // self.block_rows * self.block_rows)


def _empty(call):
    b, k, dev = call.b, call.k, call.device
    return (torch.full((b, k), NEG_INF, dtype=torch.float32, device=dev),
            torch.full((b, k), -1, dtype=torch.int32, device=dev))


def _floor_plain(call):
    m = torch.full((call.b,), NEG_INF, dtype=torch.float32,
                   device=call.device)
    for lo in range(0, call.n_scan, call.chunk()):
        s = call.scores(lo, min(call.n_scan, lo + call.chunk()))
        m = torch.maximum(m, s.amax(dim=1))
    return m[:, None].expand(call.b, call.k).contiguous(), _empty(call)[1]


def _topk_plain(call, tiles=1, count=False):
    """The exact top-k by (value desc, slot asc) of the whole blocks, and
    with ``count`` kexp2's count in closed form: the sum over blocks j and
    query tiles of B / tiles queries of the most rows of block j, over the
    tile's queries, in the exact top-k of rows [0, (j + 1) block_rows)
    (-inf never counts)."""
    vals, idx = _empty(call)
    off = int(call.offset.reshape(-1)[0])
    cnt = torch.zeros((), dtype=torch.int64, device=call.device)
    step = call.chunk(count)
    for lo in range(0, call.n_scan, step):
        hi = min(call.n_scan, lo + step)
        ids = torch.arange(lo, hi, dtype=torch.int32, device=call.device) \
            + off
        vals, idx = D.merge_topk(vals, idx, call.scores(lo, hi),
                                 ids.expand(call.b, -1), call.k)
        if count:
            mine = (vals > NEG_INF) & (idx >= lo + off) & (idx < hi + off)
            cnt += mine.sum(dim=1).reshape(tiles, -1).amax(dim=1).sum()
    idx = torch.where(torch.isneginf(vals), -1, idx)
    return vals, idx, cnt.to(torch.int32).reshape(1)


def entry(lib, mode, tma, what=""):
    """The library's function ``vrod_extract_<mode><what>`` of the TMA
    build, or where not ``tma`` the copying build's
    (``vrod_extract_<mode>_copy<what>``, csrc/extract_<mode>_copy.cu)."""
    return getattr(lib, f"vrod_extract_{mode}{'' if tma else '_copy'}{what}")


def _launch(kernel, call, *, count=False):
    """One kernel's launches on the card; (values, slots, per-block counts
    (n_scan / block_rows, B) or None)."""
    out_v, out_i = _empty(call)
    if call.n_scan == 0:
        return out_v, out_i, None
    b, k, dev = call.b, call.k, call.device
    mode, unroll = KERNELS[kernel]
    plan = extract_plan(kernel, call.n_scan, b, k, K._sms(dev), count,
                        call.split)
    size = scratch_sizes(kernel, plan, b, k, call.nblocks, count)
    lib = _build.load()
    f32, i32 = torch.float32, torch.int32
    with torch.cuda.device(dev):
        cand_v = torch.empty(size["cand_v"], dtype=f32, device=dev)
        cand_i = torch.empty(size["cand_i"], dtype=i32, device=dev)
        cand_n = torch.empty(size["cand_n"], dtype=i32, device=dev)
        cnt = torch.empty(size["cnt"], dtype=i32, device=dev)
        merge_v = torch.empty(size["merge"], dtype=f32, device=dev)
        merge_i = torch.empty(size["merge"], dtype=i32, device=dev)
        rc = entry(lib, mode, call.tma)(
            call.elem, call.epi, unroll, call.x.data_ptr(),
            call.aux.data_ptr(), call.mask.data_ptr(), call.q.data_ptr(),
            call.offset.data_ptr(), call.n_scan, call.row_bytes, b, k,
            plan.groups, plan.parts, plan.cap, call.block_rows, int(count),
            int(plan.on_chip), plan.stage, call.granule,
            cand_v.data_ptr(), cand_i.data_ptr(), cand_n.data_ptr(),
            cnt.data_ptr(), merge_v.data_ptr(), merge_i.data_ptr(),
            out_v.data_ptr(), out_i.data_ptr(), K._stream(dev))
    K._ok(rc, f"extract_{mode} launch")
    name = f"extract_{kernel}[{call.leg}]"
    launches[name] += 1
    if not call.tma:
        copy_launches[name] += 1
    return out_v, out_i, cnt.reshape(call.nblocks, b) if count else None


def _run(kernel, call):
    if call.device.type == "cpu":
        return _floor_plain(call) if kernel == "floor" \
            else _topk_plain(call)[:2]
    return _launch(kernel, call)[:2]


def _variant(table, name, variant):
    if variant not in table:
        raise ValueError(f"{name} variant {variant!r}: expected one of "
                         f"{tuple(table)}")
    return table[variant]


# -- X1: kexp ---------------------------------------------------------------


def kexp_plain(variant, x, aux2d, mask2d, q, offset, *, k, metric,
               block_rows, precision_name, packed=False):
    """Plain PyTorch X1: ``floor`` each query's max over the whole blocks
    in every rank with ids -1, any other variant the exact top-k."""
    kernel = _variant(KEXP_VARIANTS, "kexp", variant)
    call = _XCall(x, aux2d, mask2d, q, offset, k=k, metric=metric,
                  block_rows=block_rows, precision_name=precision_name,
                  packed=packed)
    return _floor_plain(call) if kernel == "floor" \
        else _topk_plain(call)[:2]


def kexp_call(variant, x, aux2d, mask2d, q, offset, *, k, metric,
              block_rows, precision_name, packed=False):
    """X1, the contract of ``kexp.make_call(variant, k=, metric=,
    block_rows=, precision_name=)(x, aux2d, mask2d, q, offset)``."""
    kernel = _variant(KEXP_VARIANTS, "kexp", variant)
    call = _XCall(x, aux2d, mask2d, q, offset, k=k, metric=metric,
                  block_rows=block_rows, precision_name=precision_name,
                  packed=packed)
    return _run(kernel, call)


# -- X2: kexp2 --------------------------------------------------------------


def _tiles(call, tiles):
    if tiles < 1 or call.b % tiles:
        raise ValueError(f"tiles ({tiles}) must divide the batch "
                         f"({call.b})")


def kexp2_plain(x, aux2d, mask2d, q, offset, *, k, metric, block_rows,
                precision_name, tiles=1, count=False, packed=False):
    """Plain PyTorch X2: (values, slots, cnt), cnt (1,) int32 in closed
    form (``_topk_plain``) with ``count``, else 0."""
    call = _XCall(x, aux2d, mask2d, q, offset, k=k, metric=metric,
                  block_rows=block_rows, precision_name=precision_name,
                  packed=packed)
    _tiles(call, tiles)
    return _topk_plain(call, tiles, count)


def kexp2_call(x, aux2d, mask2d, q, offset, *, k, metric, block_rows,
               precision_name, tiles=1, count=False, packed=False):
    """X2, the contract of ``kexp2.make_call(k=, metric=, block_rows=,
    precision_name=, tiles=)(x, aux2d, mask2d, q, offset)``: (values,
    slots, cnt). ``count=True`` is the counterpart of ``KEXP_COUNT=1``:
    cnt is then the while-iteration count of kexp2's per-tile loops (the
    kernel runs one part per query group and counts its carry after each
    block); else cnt is 0. Timed runs use ``count=False``."""
    call = _XCall(x, aux2d, mask2d, q, offset, k=k, metric=metric,
                  block_rows=block_rows, precision_name=precision_name,
                  packed=packed)
    _tiles(call, tiles)
    if call.device.type == "cpu":
        return _topk_plain(call, tiles, count)
    vals, idx, per_block = _launch("carry", call, count=count)
    cnt = torch.zeros(1, dtype=torch.int32, device=call.device)
    if per_block is not None:
        cnt = per_block.reshape(call.nblocks, tiles, -1).amax(dim=2).sum() \
            .to(torch.int32).reshape(1)
    return vals, idx, cnt


# -- X3: kexp3 --------------------------------------------------------------


def kexp3_plain(x, aux2d, mask2d, q, offset, *, k, metric, block_rows,
                precision_name, packed=False):
    """Plain PyTorch X3: the exact top-k of the whole blocks."""
    return kexp_plain("gate", x, aux2d, mask2d, q, offset, k=k,
                      metric=metric, block_rows=block_rows,
                      precision_name=precision_name, packed=packed)


def kexp3_call(x, aux2d, mask2d, q, offset, *, k, metric, block_rows,
               precision_name, packed=False):
    """X3, the contract of ``kexp3.make_call(k=, metric=, block_rows=,
    precision_name=)(x, aux2d, mask2d, q, offset)``."""
    call = _XCall(x, aux2d, mask2d, q, offset, k=k, metric=metric,
                  block_rows=block_rows, precision_name=precision_name,
                  packed=packed)
    return _run("pingpong", call)


# -- X4: kexp5 --------------------------------------------------------------


def kexp5_plain(variant, x, aux2d, mask2d, q, offset, *, k, block_rows,
                precision_name, metric="cosine", packed=False):
    """Plain PyTorch X4: the exact top-k of the whole blocks (cosine)."""
    _variant(KEXP5_VARIANTS, "kexp5", variant)
    call = _XCall(x, aux2d, mask2d, q, offset, k=k, metric=metric,
                  block_rows=block_rows, precision_name=precision_name,
                  packed=packed, cosine_only=True)
    return _topk_plain(call)[:2]


def kexp5_call(variant, x, aux2d, mask2d, q, offset, *, k, block_rows,
               precision_name, metric="cosine", packed=False):
    """X4, the contract of ``kexp5.make_call(variant, k=, block_rows=,
    precision_name=)(x, aux2d, mask2d, q, offset)``; kexp5's epilogue is
    cosine only, so any other ``metric`` raises."""
    kernel = _variant(KEXP5_VARIANTS, "kexp5", variant)
    call = _XCall(x, aux2d, mask2d, q, offset, k=k, metric=metric,
                  block_rows=block_rows, precision_name=precision_name,
                  packed=packed, cosine_only=True)
    return _run(kernel, call)


# -- One call per kernel ------------------------------------------------------

# The experiment call (function, variant) that runs each kernel.
KERNEL_CALLS = {"floor": ("kexp", "floor"), "store": ("kexp", "base"),
                "gate": ("kexp", "gate"), "carry": ("kexp2", None),
                "pingpong": ("kexp3", None), "unroll2": ("kexp5", "unroll2"),
                "unroll4": ("kexp5", "unroll4")}


def run_kernel(kernel, x, aux2d, mask2d, q, offset, *, k, metric,
               block_rows, precision_name="fast", plain=False):
    """(values, slots) of the experiment call that runs ``kernel`` (X2 with
    tiles 1 and no count), or of its plain twin with ``plain``."""
    fn, variant = KERNEL_CALLS[kernel]
    f = globals()[f"{fn}_plain" if plain else f"{fn}_call"]
    kw = dict(k=k, metric=metric, block_rows=block_rows,
              precision_name=precision_name)
    args = (x, aux2d, mask2d, q, offset)
    if variant is not None:
        args = (variant,) + args
    return f(*args, **kw)[:2]

