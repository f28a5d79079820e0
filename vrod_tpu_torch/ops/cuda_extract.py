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
  a top-k); ``base``/``maxref`` run the store mode (no register gate, every
  finite score appended, lists cut every tile); ``gate``, ``nostore``,
  ``argmax`` and ``subdot`` run K1's gate, topk.cuh's own ``consume_all``
  and ``gate_tile`` (on the TPU they differ in Mosaic's stores and argmax;
  on the H100 every score stays in its register, so they share one build);
- ``kexp2_call(tiles, count)`` (X2): the running top-k carried sorted per
  query and inserted in place; also returns ``cnt`` (1,) int32, kexp2's
  while-iteration count under ``KEXP_COUNT=1`` when ``count``, else 0;
- ``kexp3_call`` (X3): K1's ``consume_all`` with the consumer
  warpgroups in ping-pong;
- ``kexp5_call(variant)`` (X4, cosine only): ``nostore`` is K1's gate (the
  X1 gate build), ``unroll2``/``unroll4`` K1's ``gate_tile`` with one
  divergent branch per 2 or 4 query pairs.

The query is read as the experiments cast it (``q.astype(x.dtype)``): int8
rows need an int8 query (a float one raises); bfloat16 rows round it to
bfloat16 (to nearest even); float32 rows score in TF32 on the card (both
operands rounded to nearest, ``cuda_topk.tf32_round``), which is
``precision_name="fast"``; "high" and "exact" on float32 rows raise on the
card (it has no exact scorer) and score in full float32 in the plain
versions. Packed int4 rows are not accepted: the experiments unpack no
nibbles.

Each wrapper validates its inputs and dispatches on the device of the
tensors: a CPU tensor goes to its ``*_plain`` twin, a CUDA tensor launches
the hand-written CUDA kernel of its mode (``csrc/extract_<mode>.cu``, see
``csrc/extract.cuh``) or raises. No wrapper falls back, and no mode maps
to K1's own build at run time: the gated modes compile K1's device code
into their own builds, with the experiments' epilogues. ``launches`` counts kernel launches per kernel and leg
(e.g. ``extract_carry[bf16-l2]``, ``extract_unroll4[int8-cosine]``); only
a CUDA launch adds to it.
"""

from __future__ import annotations

import torch

from . import _build
from . import cuda_topk as K
from . import distances as D

NEG_INF = float("-inf")
X_DTYPES = ("int8", "bf16", "f32")
X_METRICS = ("cosine", "dot", "l2")
PRECISIONS = ("fast", "high", "exact")
_X_ELEM = {torch.int8: ("int8", 0), torch.bfloat16: ("bf16", 2),
           torch.float32: ("f32", 3)}
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


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


# -- Launch plans ------------------------------------------------------------

SMEM_BYTES = 232448         # a block's shared memory on the H100 (227 KB)
STAGE_BYTES = 48 * 1024     # one ring stage (score.cuh: kStageBytes)
K1_RING = 4                 # the ring of every mode but X2 (topk.cuh)
# Static shared memory of X2's kernel (barriers, gates, locks, the warps'
# 12 KB of insert queues) and slack.
CARRY_STATIC_BYTES = 16384


def carry_plan(k: int) -> tuple[int, bool]:
    """X2's (ring stages, carry in shared memory) for top-k: the deepest
    ring of 4 or 3 stages beside which 256 queries x k x 8 bytes of carry
    fit in a block's shared memory (k <= 9 with 4 stages, <= 33 with 3),
    else the carry in global memory (L2) beside 4 stages."""
    for ring in (K1_RING, 3):
        need = 1024 + ring * STAGE_BYTES + K.GROUP_QUERIES * k * 8 \
            + CARRY_STATIC_BYTES
        if need <= SMEM_BYTES:
            return ring, True
    return K1_RING, False


def extract_plan(kernel: str, n: int, b: int, k: int, sms: int,
                 count: bool = False) -> tuple[int, int, int, int, bool]:
    """A kernel's grid for n rows (whole blocks), b queries, top-k on ``sms``
    SMs: (groups, parts, cap, ring, carry_smem). The grid is K1's
    (``topk_plan``). cap is a (part, query) list's capacity: K1's for the
    gated modes (k and 5 tiles: cuts every 4 tiles), k + 1 tile for the
    store mode (cut every tile), k for X2's carry, 0 for the floor (one max
    per part and query). With ``count`` X2 runs one part per query group,
    so that it walks the rows in global order."""
    if kernel not in KERNELS:
        raise ValueError(f"kernel {kernel!r}: expected one of "
                         f"{tuple(KERNELS)}")
    mode = KERNELS[kernel][0]
    groups, parts, cap = K.topk_plan(n, b, k, sms)
    ring, smem = K1_RING, False
    if mode == "floor":
        cap = 0
    elif mode == "store":
        cap = k + K.TILE_ROWS
    elif mode == "carry":
        cap = k
        ring, smem = carry_plan(k)
        if count:
            parts = 1
    return groups, parts, cap, ring, smem


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
        if x.dim() != 2 or x.dtype not in _X_ELEM:
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
        kind, self.elem = _X_ELEM[x.dtype]
        self.leg = f"{kind}-{metric}"
        self.epi = _X_EPI[metric]
        # float32 rows in full float32 (plain only) or TF32 (the card).
        self.exact = x.dtype == torch.float32 and precision_name != "fast"
        if self.quant:
            self.q = q
        elif x.dtype == torch.bfloat16:
            self.q = q.to(torch.bfloat16).contiguous()
        else:
            self.q = q.float().contiguous() if self.exact else K.tf32_round(q)
        if self.device.type == "cuda":
            if self.exact:
                raise ValueError(
                    f"precision_name {precision_name!r} on float32 rows: the "
                    "card scores float32 rows in TF32 ('fast') and has no "
                    "exact scorer for them")
            if not K.use_tma(x, self.q, self.row_bytes):
                raise ValueError(
                    "the extraction kernels load by TMA: rows of a multiple "
                    f"of 16 bytes (got {self.row_bytes}) at 16-byte aligned "
                    "addresses")

    @property
    def row_bytes(self) -> int:
        return self.x.shape[1] * self.x.element_size()

    def scores(self, lo, hi):
        """Plain scores (B, hi - lo) of rows [lo, hi): the inputs rounded as
        the kernels round them, then the epilogue and the mask, each op
        rounded once."""
        x = self.x[lo:hi]
        if x.dtype == torch.float32 and not self.exact:
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


def _launch(kernel, call, *, count=False):
    """One kernel's launches on the card; (values, slots, per-block counts
    (n_scan / block_rows, B) or None)."""
    out_v, out_i = _empty(call)
    if call.n_scan == 0:
        return out_v, out_i, None
    b, k, dev = call.b, call.k, call.device
    mode, unroll = KERNELS[kernel]
    groups, parts, cap, ring, smem = extract_plan(
        kernel, call.n_scan, b, k, K._sms(dev), count)
    lib = _build.load()
    f32, i32 = torch.float32, torch.int32
    with torch.cuda.device(dev):
        lists = parts * b * cap
        cand_v = torch.empty(parts * b if mode == "floor" else lists,
                             dtype=f32, device=dev)
        cand_i = torch.empty(max(lists, 1), dtype=i32, device=dev)
        cand_n = torch.empty(parts * b, dtype=i32, device=dev)
        cnt = torch.empty(call.nblocks * b if count else 1, dtype=i32,
                          device=dev)
        merge_v = torch.empty(b * parts * k, dtype=f32, device=dev)
        merge_i = torch.empty(b * parts * k, dtype=i32, device=dev)
        rc = getattr(lib, f"vrod_extract_{mode}")(
            call.elem, call.epi, unroll, call.x.data_ptr(),
            call.aux.data_ptr(), call.mask.data_ptr(), call.q.data_ptr(),
            call.offset.data_ptr(), call.n_scan, call.row_bytes, b, k,
            groups, parts, cap, call.block_rows, ring, int(count), int(smem),
            cand_v.data_ptr(), cand_i.data_ptr(), cand_n.data_ptr(),
            cnt.data_ptr(), merge_v.data_ptr(), merge_i.data_ptr(),
            out_v.data_ptr(), out_i.data_ptr(), K._stream(dev))
    K._ok(rc, f"extract_{mode} launch")
    launches[f"extract_{kernel}[{call.leg}]"] += 1
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

