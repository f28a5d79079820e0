"""The port's search kernels: the counterpart of ``vrod_tpu.ops.pallas_topk``.

Two kernels carry SEARCHSIMILAR, for every leg of the TPU kernels: int8
and packed int4 rows (int8-quantized query), bfloat16 and float32 rows
(float query), each with metric cosine, dot or l2. Each kernel has a
wrapper that validates its inputs and dispatches on the device of the
tensors it is given: a CPU tensor goes to the plain PyTorch version beside
it, a CUDA tensor launches the hand-written CUDA kernel (or raises). No
wrapper falls back from the kernel to the plain version.

- ``fused_topk`` (K1, ``csrc/fused_topk.cu``) replaces the Pallas kernel
  ``pallas_topk.fused_topk`` -> ``_fused_call_db``/``_kernel_db`` (and the
  auto-pipelined ``_fused_call``/``_kernel``, the TPU's K2: any dim).
  Bound on the H100 by bytes: one search streams every stored row, 805 MB
  of int8 at 1M x 768, with the dots (on the tensor cores) close behind. A
  persistent grid streams each row tile through a TMA ring into wgmma and
  tests every score in its register against max(theta0, the query's
  running k-th); see the sources for the exact select and merge that
  replace the TPU's sequential carry. ``scan_route`` picks one of three
  kernels from the call's shapes and whether it has a floor: with theta0
  (the engine's main path) ``floor_plan``'s query groups of 256, each row
  tile crossing L2 once, with lists in scratch cut every FLOOR_CUT_TILES
  tiles (``csrc/fused_topk_floor.cu``); without, ``topk_plan``'s groups of
  64 with the k-ths in registers and lists in shared memory, cut only
  when full (``csrc/fused_topk.cu``); scans too short for either grid
  (``small_plan``: the K2 shapes) take one cluster launch over query
  groups of 16 with the candidate lists and the merge on the chip.
- ``sampled_submax`` (K3, ``csrc/sampled_submax.cu``) replaces
  ``pallas_topk.sampled_submax`` -> ``_submax_kernel``. It scores a prefix
  sample with K1's scoring core (bit-identical scores, which the floor's
  soundness needs) and emits 128 strided group maxima per row block. The
  sample is small (25 MB at the int8 headline), so parallelism bounds it:
  ``submax_plan`` gives each (row block, query group of 64 or 128) a
  cluster of segments that reduce their maxima through distributed shared
  memory, in one launch.

The kernels read the rows' mask from ``valid`` and ``row_bias``
themselves, the tensor maps of a launch come from a cache keyed by all
they encode (``TensorMaps``), and each kernel's shared-memory attribute is
set once, so a call's host work is its checks, the plan and one launch
(two for K1's long scans: the merge).

Scores, in both (``csrc/score.cuh``), with mask 0 on live slots and -inf on
dead ones and every float op rounded once:
- int8/int4 rows: g, the exact int32 dot of the int8 query and the row
  (int4: two half-dim dots over the low and high nibbles); cosine and dot
  ``float(g) * aux + mask``; l2 ``(float(g) * aux) * (2 * q_scale) +
  mask`` with ``-|x_hat|^2`` (``row_bias``) as the live mask value.
- bfloat16 rows: the query rounds to bfloat16; g sums the exact products in
  float32. float32 rows at ``precision="fast"``: both operands round to
  TF32 (10 mantissa bits, to nearest, ties away from zero:
  ``cvt.rna.tf32.f32``) and g sums their exact products in float32. At
  "high" and "exact" (the TPU kernel's HIGHEST; leg ``f32x3``) each
  operand v splits into big = tf32(v) and small = tf32(v - big), and g sums
  the exact products big.big + small.big + big.small in float32 (three
  TF32 products: ``split_tf32``). Then cosine ``g * aux + mask``, l2 ``(2g -
  aux) + mask``, dot ``g + mask``. Float sums run in another order on the
  tensor cores than in the plain version, so these legs agree with it to
  a bound (``score_error_bound``), not bit for bit; the engine's exact
  float32 rescore restores exactness.

Rows TMA cannot load (row bytes not a multiple of 16, or unaligned
bases: int8 dim 30 or 100, bfloat16 dim 100, float32 dim 25) take the same
kernels with the producer warpgroup copying each stage by the widest
granule the shape allows (``copy_granule``: cp.async of 8 or 4 bytes,
plain loads of 2 or 1), a runtime argument of the launch.

``launches`` counts kernel launches per kernel and leg (e.g.
``fused_topk[int8-l2]``); only a CUDA launch adds to it. ``copy_launches``,
with the same keys, counts those of them that copied. ``small_scans`` and
``floor_scans`` count, per leg, the K1 launches that took the small-scan
kernel and the floor's kernel.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import math
import threading
from collections import OrderedDict
from typing import NamedTuple

import torch

from . import _build
from . import distances as D

NEG_INF = float("-inf")
# Rows per block of the plain versions: bounds their (B, rows) score
# matrix at 256 MB.
_PLAIN_SCORE_ELEMS = 1 << 26

# Row dtypes of the legs (int4 rows are packed int8 bytes; f32x3 is float32
# rows at the precisions "high" and "exact") and score.cuh's Elem / Epi
# codes.
LEG_DTYPES = ("int8", "int4", "bf16", "f32", "f32x3")
LEG_METRICS = ("cosine", "dot", "l2")
LEGS = tuple(f"{d}-{m}" for d in LEG_DTYPES for m in LEG_METRICS)
_ELEM = {"int8": 0, "int4": 1, "bf16": 2, "f32": 3, "f32x3": 4}
_EPI_SCALE, _EPI_SCALE_QS, _EPI_L2, _EPI_DOT = range(4)

# The kernels' geometry (csrc/score.cuh, topk.cuh): rows per tile, the
# gated core's queries per block (the wgmma N side: K1 without a floor,
# X8), the ring's default depth (the
# library says its own: vrod_k1_ring) and the least slack of a list past k
# (a list of k + 32 places takes one more warp's worth after a cut).
# Lists in global memory (past the k where they fit on chip) hold k +
# GLOBAL_SLACK. A scan takes the small-scan kernel where it would give
# each of sms // ceil(b / SMALL_SPAN) blocks fewer than SMALL_TILES row
# tiles.
TILE_ROWS = 128
GROUP_QUERIES = 64
RING = 4
LIST_SLACK = 32
GLOBAL_SLACK = 5 * TILE_ROWS
SMALL_TILES = 4
SMALL_SPAN = 256
# K3: queries per block (wgmma n64 or n128) and its ring (192 KB of
# stages of the 16 KB row box and the query box, ``stage_bytes``). K1's
# small scans: queries per block (wgmma n16), their ring, the largest k
# whose merge (parts x k candidates a warp) fits the ring it reuses, and
# their lists' capacity (cut by the warp bitonic sort). Clusters: at most MAX_CLUSTER
# blocks (portable).
SUBMAX_GROUPS = (128, 64)
SUBMAX_RING_BYTES = 192 * 1024
SMALL_GROUP = 16
MAX_CLUSTER = 8
SMALL_RING = 4
SMALL_MAX_K = 64
SMALL_CAP = 256
# Shared memory a block may use; the small-scan kernel's static part
# (gates, lengths, the selects' histograms, barriers); and a bound on the
# long scan's (the same and X9's G and aux range: at most this in every
# build, which the card checks against vrod_topk_smem).
SMEM_LIMIT = 232448
SMALL_STATIC_SMEM = 2 * SMALL_GROUP * 4 + 8 * 256 * 4 + 2 * SMALL_RING * 8
TOPK_STATIC_SMEM = 9 * 1024
# K1's long scan from a floor (csrc/fused_topk_floor.cu): queries per block
# (wgmma n256) and the tiles between two cuts of its lists, which hold k +
# FLOOR_CUT_TILES + 1 tiles of candidates in scratch; its ring of
# FLOOR_RING stages of the row box and the 256 queries' box; the largest k
# whose cuts are warp sorts alone (topk.cuh: kSortLongK; past it the radix
# select's histograms, FLOOR_HIST bytes, join the dynamic shared memory);
# and a bound on its static shared memory (gates, lengths, the l2 legs'
# query scales or X9's G, barriers), which the card checks against
# vrod_topk_floor_smem.
FLOOR_GROUP = 256
FLOOR_CUT_TILES = 4
FLOOR_RING = 4
FLOOR_SORT_K = 192
FLOOR_HIST = 8 * 256 * 4
FLOOR_STATIC_SMEM = 5 * 1024

launches = {f"{kern}[{leg}]": 0 for kern in ("fused_topk", "sampled_submax")
            for leg in LEGS}
copy_launches = dict(launches)
small_scans = dict.fromkeys(LEGS, 0)
floor_scans = dict.fromkeys(LEGS, 0)


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0
        copy_launches[name] = 0
    for leg in LEGS:
        small_scans[leg] = 0
        floor_scans[leg] = 0


def _row_kind(x: torch.Tensor, packed: bool, precision: str) -> str:
    if x.dtype == torch.float32 and precision != "fast":
        return "f32x3"
    return "int4" if packed else {torch.int8: "int8", torch.bfloat16: "bf16",
                                  torch.float32: "f32"}[x.dtype]


def leg_name(x: torch.Tensor, metric: str, packed: bool = False,
             precision: str = "fast") -> str:
    """The leg of rows x under ``metric`` at ``precision``, e.g.
    ``int4-l2`` or ``f32x3-dot``."""
    return f"{_row_kind(x, packed, precision)}-{metric}"


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 as ``cvt.rna.tf32.f32`` does: keep 10
    mantissa bits, to nearest, ties away from zero (a new tensor)."""
    bits = t.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(big, small) TF32 parts of float32 ``t``, as the f32x3 leg splits
    its operands: big = tf32(t), small = tf32(t - big) (t - big is exact).
    """
    big = tf32_round(t)
    return big, tf32_round(t.float() - big)


def split_dots(q2: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The f32x3 leg's dots (B, N) of the split query q2 (B, 2D: its TF32
    big parts, then its small parts) and float32 rows x (N, D): the exact
    products big.big + big.small + small.big summed in float32, in that
    order."""
    d = x.shape[1]
    xb, xs = split_tf32(x)
    qb, qs = q2[:, :d], q2[:, d:]
    return (D._matmul_f32(qb, xb) + D._matmul_f32(qb, xs)) \
        + D._matmul_f32(qs, xb)


class _Call:
    """A validated kernel call: the leg, and the inputs as both the kernel
    and the plain version take them."""

    def __init__(self, x, aux, valid, q, metric, row_bias, q_scale, packed,
                 precision="fast"):
        if metric not in LEG_METRICS:
            raise ValueError(f"metric {metric!r}: expected one of "
                             f"{LEG_METRICS}")
        if x.dim() != 2 or x.dtype not in (torch.int8, torch.bfloat16,
                                           torch.float32):
            raise TypeError(f"x must be (N, D) int8, bfloat16 or float32, "
                            f"got {tuple(x.shape)} {x.dtype}")
        if packed and x.dtype != torch.int8:
            raise TypeError("packed int4 rows are int8 bytes")
        if precision not in D.PRECISIONS:
            raise ValueError(f"precision {precision!r}: expected one of "
                             f"{tuple(D.PRECISIONS)}")
        self.quant = x.dtype == torch.int8
        if q.dim() != 2:
            raise ValueError(f"q must be (B, D), got {tuple(q.shape)}")
        if self.quant and q.dtype != torch.int8:
            # A float query truncated to int8 would score garbage with valid
            # shapes: callers quantize it (distances.prepare_queries) first.
            raise TypeError(
                f"{'int4' if packed else 'int8'} rows require an "
                f"int8-quantized (B, D) query, got {tuple(q.shape)} "
                f"{q.dtype}")
        self.n, row_d = x.shape
        self.b = q.shape[0]
        dim = 2 * row_d if packed else row_d
        if q.shape[1] != dim:
            raise ValueError(f"query dim {q.shape[1]} != row dim {dim}")
        if aux.shape != (self.n,) or aux.dtype != torch.float32:
            raise ValueError(f"aux must be ({self.n},) float32")
        if valid.shape != (self.n,) or valid.dtype != torch.bool:
            raise ValueError(f"valid must be ({self.n},) bool")
        quant_l2 = self.quant and metric == "l2"
        if quant_l2 and (row_bias is None or q_scale is None):
            raise ValueError(
                "int8/int4 + l2 needs row_bias = -|x_hat|^2 (N,) and "
                "q_scale (B,) or (B, 1): the engine keeps both")
        if row_bias is not None and row_bias.numel() != self.n:
            raise ValueError(f"row_bias must be ({self.n},)")
        if q_scale is not None and q_scale.numel() != self.b:
            raise ValueError(f"q_scale must be ({self.b},) or ({self.b}, 1)")
        ts = [x, aux, valid, q] + [t for t in (row_bias, q_scale)
                                   if t is not None]
        devs = {t.device for t in ts}
        if len(devs) != 1:
            raise ValueError(f"inputs on several devices: {devs}")
        if not all(t.is_contiguous() for t in (x, aux, valid, q)):
            raise ValueError("inputs must be contiguous")
        self.device = x.device
        if self.device.type not in ("cpu", "cuda"):
            raise ValueError(f"unsupported device {self.device}")
        self.leg = leg_name(x, metric, packed, precision)
        self.elem = _ELEM[_row_kind(x, packed, precision)]
        self.packed = packed
        self.split = self.leg.startswith("f32x3")
        self.x, self.aux, self.valid = x, aux, valid
        # The query as the kernel reads it: bfloat16 rows take it rounded
        # to bfloat16 (the Pallas kernel's q.astype(x.dtype)), float32 rows
        # rounded to TF32 (the tensor cores would truncate it), or at
        # "high"/"exact" its TF32 big parts then its small parts, (B, 2D).
        if self.quant:
            self.q = q
        elif self.split:
            self.q = torch.cat(split_tf32(q), dim=1).contiguous()
        elif x.dtype == torch.float32:
            self.q = tf32_round(q)
        else:
            self.q = q.to(x.dtype).contiguous()
        # The kernels read the mask from valid and the bias themselves
        # (csrc/score.cuh: RowMask); the plain versions build it (mask).
        self.bias = row_bias.float().reshape(self.n).contiguous() \
            if row_bias is not None else None
        self.q_scale = q_scale.float().reshape(self.b).contiguous() \
            if quant_l2 else None
        self._mask = None
        if self.quant:
            self.epi = _EPI_SCALE_QS if quant_l2 else _EPI_SCALE
        else:
            self.epi = {"cosine": _EPI_SCALE, "l2": _EPI_L2,
                        "dot": _EPI_DOT}[metric]

    @property
    def mask(self) -> torch.Tensor:
        """The additive mask (N,): -inf on dead slots, else row_bias (0
        everywhere but int8/int4 + l2's -|x_hat|^2); built on first use."""
        if self._mask is None:
            mask = torch.zeros_like(self.aux) if self.bias is None \
                else self.bias.clone()
            self._mask = mask.masked_fill_(~self.valid, NEG_INF)
        return self._mask

    @property
    def qs2(self):
        """2 * q_scale (B,) for int8/int4 + l2, else None."""
        return None if self.q_scale is None else 2.0 * self.q_scale

    def scores(self, lo, hi):
        """Plain scores (B, hi - lo) of rows [lo, hi): the kernels' inputs
        rounded as they round them, then each epilogue op rounded once."""
        x, aux = self.x[lo:hi], self.aux[lo:hi][None, :]
        if self.packed:
            g = D._matmul_f32(self.q, D.unpack_int4_rows(x))
        elif self.split:
            g = split_dots(self.q, x)
        elif x.dtype == torch.float32:
            g = D._matmul_f32(tf32_round(self.q), tf32_round(x))
        else:
            # int8: integer products and partial sums stay below 2^24, so
            # the float32 product is the exact integer dot in any order.
            # bfloat16: products of two bfloat16 values are exact in
            # float32; only the order of the sums differs from the kernel.
            g = D._matmul_f32(self.q, x)
        if self.epi == _EPI_SCALE:
            s = g * aux
        elif self.epi == _EPI_SCALE_QS:
            s = (g * aux) * (2.0 * self.q_scale)[:, None]
        elif self.epi == _EPI_L2:
            s = 2.0 * g - aux
        else:
            s = g
        return s + self.mask[lo:hi][None, :]

    def pointers(self):
        """K1's and K3's input pointers: rows, aux, valid, bias, query and
        q_scale (None where absent)."""
        return (self.x.data_ptr(), self.aux.data_ptr(),
                self.valid.data_ptr(), _ptr(self.bias), self.q.data_ptr(),
                _ptr(self.q_scale))

    @functools.cached_property
    def granule(self) -> int:
        """The launch's load: 16 (TMA) or the copy's granule."""
        return copy_granule(self.x, self.q, self.row_bytes)

    def maps(self, group: int):
        """The encoded tensor maps (x, q, q_hi) of a launch whose blocks
        take ``group`` queries; (None, None, None) without TMA."""
        if self.granule != 16:
            return None, None, None
        rb, n, b = self.row_bytes, self.n, self.b
        qstride = self.q.shape[1] * self.q.element_size()
        x_map = tensor_maps.get(self.x.data_ptr(), rb, n, rb, TILE_ROWS)
        q_map = tensor_maps.get(self.q.data_ptr(), rb, b, qstride, group)
        q_hi = tensor_maps.get(self.q.data_ptr() + rb, rb, b, qstride,
                               group) if qstride != rb else None
        return x_map, q_map, q_hi

    @property
    def row_bytes(self) -> int:
        return self.x.shape[1] * self.x.element_size()


def score_error_bound(x, aux, valid, q, *, metric, precision="fast"):
    """Per-query (B, 1) bound on |kernel score - plain score| for one leg.

    0 for int8/int4 rows: exact dots, then the same rounded epilogue ops.
    bfloat16/float32 rows: the kernel and the plain version round their
    inputs alike and sum the same exact products in another order (f32x3:
    three per element, two of them below 2^-10 of the first: the partial
    sums keep their size, and a walk of 3d roundings is sqrt(3) times
    longer, inside the 4x allowance below). Each
    float32 addition errs by at most 2^-24 of a partial sum no larger than
    |q| |x|, and on rows of mixed signs those errors add like a random
    walk, to about sqrt(d) * 2^-24 * |q| |x|. The bound allows 4x that plus
    2^-22 of the largest score for the epilogue's roundings: 2^-22 *
    (sqrt(d) + 1) * |q| * max live |x| (times the row's aux for cosine; 2x
    plus max aux for l2). It is a statistical bound, not a worst case: it
    is held to rows of mixed signs, where the kernel's errors stay a small
    fraction of it, and a scorer that truncates its inputs (TF32 as
    cvt.rz would, or bfloat16) exceeds it (chip_smoke.py and the CPU tests
    run that control)."""
    b = q.shape[0]
    if x.dtype == torch.int8:
        return torch.zeros((b, 1), dtype=torch.float32, device=x.device)
    call = _Call(x, aux, valid, q, metric, None, None, False, precision)
    round_ = tf32_round if x.dtype == torch.float32 else torch.Tensor.float
    qn = torch.linalg.norm(round_(call.q[:, :q.shape[1]]), dim=1,
                           keepdim=True)
    worst = torch.zeros((), device=x.device)
    aux_max = torch.zeros((), device=x.device)
    step = max(1, _PLAIN_SCORE_ELEMS // x.shape[1])
    for lo in range(0, call.n, step):
        live = valid[lo:lo + step]
        if not live.any():
            continue
        xn = torch.linalg.norm(round_(x[lo:lo + step]), dim=1)
        if metric == "cosine":
            xn = xn * aux[lo:lo + step]
        worst = torch.maximum(worst, xn[live].max())
        aux_max = torch.maximum(aux_max, aux[lo:lo + step][live].max())
    scale = 2.0 if metric == "l2" else 1.0
    top = scale * qn * worst + (aux_max if metric == "l2" else 0.0)
    return (2.0 ** -22 * ((math.sqrt(x.shape[1]) + 1) * top)).float()


def topk_disagreement(v, i, want_v, want_i, bound):
    """How a K1 result (v, i) breaks the comparison rule against another
    result (want_v, want_i) of the same leg, as text; None if it holds.
    The rule: -inf ranks alike; values within ``bound`` (B, 1) rank by rank
    (``score_error_bound``); slots equal, except, where the bound is not 0,
    inside near-ties: ranks whose wanted value lies within 2 * bound of a
    neighbouring rank's, and the last rank (its rival lies past k)."""
    v, i, want_v, want_i, bound = (
        torch.as_tensor(t).detach().cpu()
        for t in (v, i, want_v, want_i, bound))
    bound = bound.float().reshape(-1, 1)
    if not torch.equal(torch.isneginf(v), torch.isneginf(want_v)):
        return "-inf ranks differ"
    fin = torch.isfinite(want_v)
    err = torch.where(fin, v, 0.0) - torch.where(fin, want_v, 0.0)
    over = err.abs() - bound
    if (over > 0).any():
        return f"values differ by {float(over.max())} beyond the bound"
    near = torch.zeros_like(fin)
    pair = (want_v[:, 1:] - want_v[:, :-1]).abs() <= 2 * bound
    near[:, 1:] |= pair
    near[:, :-1] |= pair
    near[:, -1] = True
    bad = (i != want_i) & ~(near & (bound > 0))
    if bad.any():
        return (f"slots differ outside near-ties at "
                f"{bad.nonzero()[:4].tolist()}")
    return None


def _theta(theta0, b, device):
    if theta0 is None:
        return torch.full((b,), NEG_INF, dtype=torch.float32, device=device)
    t0 = torch.as_tensor(theta0, dtype=torch.float32, device=device)
    return t0.reshape(b).contiguous()


def _ptr(t):
    return None if t is None else t.data_ptr()


class TensorMaps:
    """Encoded TMA tensor maps, each kept under everything its encoding
    holds: the base pointer, the inner extent (bytes), the outer extent
    (rows), the row stride (bytes) and the box's rows (the element type,
    bytes, and the 128-byte swizzled box width are the kernels' own). A
    changed pointer, shape, stride or box is a new entry; the least
    recently used of more than ``size`` go. ``encode(ptr, inner, outer,
    stride, box)`` returns an object holding the 128 encoded bytes and its
    host address (``_encode_map``); the cache hands out the address."""

    def __init__(self, encode, size: int = 256):
        self._encode, self._size = encode, size
        self._maps: OrderedDict = OrderedDict()
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return len(self._maps)

    def get(self, ptr: int, inner: int, outer: int, stride: int,
            box: int) -> int:
        key = (ptr, inner, outer, stride, box)
        with self._lock:
            held = self._maps.get(key)
            if held is not None:
                self._maps.move_to_end(key)
                return held[1]
        held = self._encode(*key)
        with self._lock:
            self._maps[key] = held
            while len(self._maps) > self._size:
                self._maps.popitem(last=False)
        return held[1]


def _encode_map(ptr, inner, outer, stride, box):
    buf = ctypes.create_string_buffer(128)
    addr = ctypes.addressof(buf)
    _ok(_build.load().vrod_encode_map(addr, ptr, inner, outer, stride, box),
        "tensor map encode")
    return buf, addr


tensor_maps = TensorMaps(_encode_map)


def _ok(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")


def _stream(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


class TopkPlan(NamedTuple):
    """K1's long-scan grid (``topk_plan``)."""
    groups: int     # query groups of GROUP_QUERIES
    parts: int      # row parts: block (part, group) walks tiles part, +parts
    cap: int        # a (part, query) list's capacity
    on_chip: bool   # the lists in shared memory (else global scratch)
    ring: int       # stages of the ring


class Layout(NamedTuple):
    """A long-scan block's shared memory (csrc/topk.cuh: Layout)."""
    ring: int
    cap: int
    on_chip: bool


def stage_bytes(width: int, split: bool = False) -> int:
    """One ring stage of a block of ``width`` queries (csrc/score.cuh:
    stage_bytes): the 16 KB row box and the queries' box of width x 128
    bytes; on the f32x3 legs (``split``) at widths to 128 two such boxes,
    the queries' big parts and their small parts (score.cuh's Walk: one
    walk of the row k-blocks; at 256 the two halves take a stage each)."""
    boxes = 2 if split and width <= 128 else 1
    return TILE_ROWS * 128 + boxes * width * 128


def topk_smem(layout: Layout, split: bool = False) -> int:
    """Shared memory of a long-scan block (at most; csrc/fused_topk.cu):
    the ring's stages (``stage_bytes``: 24 KB, at f32x3 32 KB), the lists
    (64 x cap values and slots) when on chip, and TOPK_STATIC_SMEM."""
    ring, cap, on_chip = layout
    return (1024 + ring * stage_bytes(GROUP_QUERIES, split)
            + (GROUP_QUERIES * cap * 8 if on_chip else 0) + TOPK_STATIC_SMEM)


def topk_layout(k: int, ring: int = RING, split: bool = False) -> Layout:
    """K1's shared memory for top-k: the deepest ring of ``ring`` stages
    down to 3 that leaves lists of k + LIST_SLACK places or more on chip,
    with as many places as fit (at 4 stages 242, to k 210; at 3, 290, to
    k 258; on the f32x3 legs, ``split``, whose stages are 32 KB, 178
    beside 4, to k 146, and 242 beside 3, to k 210); past that, lists of
    k + GLOBAL_SLACK in global memory beside a ring of ``ring``."""
    for r in range(ring, 2, -1):
        cap = (SMEM_LIMIT - topk_smem(Layout(r, 0, False), split)) \
            // (GROUP_QUERIES * 8)
        if cap >= k + LIST_SLACK:
            return Layout(r, cap, True)
    return Layout(ring, k + GLOBAL_SLACK, False)


def topk_plan(n: int, b: int, k: int, sms: int, ring: int = RING,
              split: bool = False) -> TopkPlan:
    """K1's persistent grid for n rows, b queries, top-k on ``sms`` SMs.
    Block (part p, group g) scores query group g (queries [64 g, 64 g +
    64)) against row tiles p, p + parts, ... (128 rows each;
    ``part_tiles``), about one block per SM. The shared memory:
    ``topk_layout`` (``split``: the f32x3 legs')."""
    groups = _cdiv(b, GROUP_QUERIES)
    parts = max(1, min(_cdiv(n, TILE_ROWS), sms // groups))
    lay = topk_layout(k, ring, split)
    return TopkPlan(groups, parts, lay.cap, lay.on_chip, lay.ring)


def scratch_bytes(plan: TopkPlan, b: int, k: int) -> int:
    """Bytes of a long scan's one scratch buffer (csrc/fused_topk.cu:
    Scratch): the part lists of values and slots (stride k where the lists
    were on chip, else cap), their lengths, and the merge's gather of values
    and slots."""
    stride = k if plan.on_chip else plan.cap
    return 4 * (2 * plan.parts * b * stride + plan.parts * b
                + 2 * b * plan.parts * k)


class FloorPlan(NamedTuple):
    """K1's grid from a floor (``floor_plan``)."""
    groups: int     # query groups of FLOOR_GROUP
    parts: int      # row parts: block (part, group) walks tiles part, +parts
    cap: int        # a (part, query) list's capacity, in scratch


def floor_plan(n: int, b: int, k: int, sms: int) -> FloorPlan:
    """K1's persistent grid from a floor for n rows, b queries, top-k on
    ``sms`` SMs. Block (part p, group g) scores query group g (queries
    [256 g, 256 g + 256)) against row tiles p, p + parts, ... (128 rows
    each; ``part_tiles``), about one block per SM; cap is the capacity of a
    (part, query) candidate list: k plus the slack of the tiles between two
    cuts and one more."""
    groups = _cdiv(b, FLOOR_GROUP)
    parts = max(1, min(_cdiv(n, TILE_ROWS), sms // groups))
    return FloorPlan(groups, parts, k + (FLOOR_CUT_TILES + 1) * TILE_ROWS)


def floor_smem(k: int) -> int:
    """Shared memory of a scan from a floor's block at top-k (at most;
    csrc/fused_topk_floor.cu): the ring of FLOOR_RING 48 KB stages
    (``stage_bytes(FLOOR_GROUP)``), the radix select's histograms past
    k FLOOR_SORT_K, and FLOOR_STATIC_SMEM."""
    return (1024 + FLOOR_RING * stage_bytes(FLOOR_GROUP)
            + (FLOOR_HIST if k > FLOOR_SORT_K else 0) + FLOOR_STATIC_SMEM)


def floor_scratch_bytes(plan: FloorPlan, b: int, k: int) -> int:
    """Bytes of a scan from a floor's one scratch buffer: ``scratch_bytes``
    with the lists at stride cap."""
    return 4 * (2 * plan.parts * b * plan.cap + plan.parts * b
                + 2 * b * plan.parts * k)


def scan_route(n: int, b: int, k: int, sms: int, floor: bool) -> str:
    """The kernel that takes a K1 scan: ``"small"`` where ``small_plan``
    takes it, else ``"floor"`` when the call has a theta0 (few scores pass:
    the n256 scan, whose row tiles cross L2 once, is the faster) and
    ``"core"`` when it has none (the lists fill: the n64 gated core, whose
    cuts wait for full lists on chip, is). PERF.md has the A/B."""
    if small_plan(n, b, k, sms) is not None:
        return "small"
    return "floor" if floor else "core"


def small_plan(n: int, b: int, k: int, sms: int):
    """K1's small-scan grid, or None where the long scan takes the call:
    (groups, parts, cap). It takes a scan that would give each of sms //
    ceil(b / SMALL_SPAN) blocks fewer than SMALL_TILES row tiles (at b256
    on 132 SMs: up to 527 tiles, 67,456 rows), at k up to SMALL_MAX_K: an
    explicit condition of the shapes, so the K2 shapes (8,192 rows) take it
    at every batch to 1024. Query group g (queries [16 g, 16 g + 16)) is
    one cluster of ``parts`` blocks; block p walks row tiles p, p + parts,
    ... (``part_tiles``), at least SMALL_TILES of them where there are that
    many, with its lists of SMALL_CAP in shared memory."""
    tiles = _cdiv(n, TILE_ROWS)
    spread = max(1, sms // _cdiv(b, SMALL_SPAN))
    if k > SMALL_MAX_K or tiles >= spread * SMALL_TILES:
        return None
    parts = max(1, min(MAX_CLUSTER, tiles // SMALL_TILES))
    return _cdiv(b, SMALL_GROUP), parts, SMALL_CAP


def small_smem(k: int, split: bool = False) -> int:
    """Shared memory of a small-scan block at top-k: the dynamic part (the
    ring of ``stage_bytes`` stages and the 16 queries' lists of SMALL_CAP)
    and the static part; the same at every k to SMALL_MAX_K."""
    del k
    return 1024 + SMALL_RING * stage_bytes(SMALL_GROUP, split) \
        + SMALL_GROUP * SMALL_CAP * 8 + SMALL_STATIC_SMEM


def part_tiles(part: int, parts: int, n: int) -> range:
    """The row tiles that K1's blocks of one part walk, in order."""
    return range(part, _cdiv(n, TILE_ROWS), parts)


def submax_plan(n: int, b: int, block_rows: int, sms: int,
                split: bool = False) -> tuple[int, int, int]:
    """K3's grid for an n-row sample in blocks of ``block_rows`` (a
    multiple of 128) on ``sms`` SMs: (width, groups, spb). Queries go in
    groups of ``width``; each (row block, query group) pair is one cluster
    of spb blocks, each a segment of block_rows / 128 / spb whole tiles
    (``submax_tiles``), spb a power of two up to MAX_CLUSTER dividing the
    block's tiles, the largest that keeps the grid (pairs x spb) within one
    block per SM. The width is 128 where that grid has as many blocks as
    64's (each block then reads its rows for twice the queries), else 64;
    on the f32x3 legs (``split``) always 64: at 128 the stages of both
    query halves leave the consumers too few registers (ptxas spills;
    PERF.md: on an H100 0.82-0.89 ms against 0.50-0.55 on a 131,072 x
    768 sample)."""
    def grid(width):
        groups = _cdiv(b, width)
        pairs = (n // block_rows) * groups
        spb = 1
        while (spb * 2 <= MAX_CLUSTER and pairs * spb * 2 <= sms
               and (block_rows // TILE_ROWS) % (spb * 2) == 0):
            spb *= 2
        return width, groups, spb, pairs * spb

    wide, narrow = (grid(w) for w in SUBMAX_GROUPS)
    if split:
        return narrow[:3]
    return (wide if wide[3] >= narrow[3] else narrow)[:3]


def submax_smem(width: int, split: bool = False) -> int:
    """Dynamic shared memory of a K3 block taking ``width`` queries: its
    ring of whole stages (``stage_bytes``) within SUBMAX_RING_BYTES,
    aligned to 1 KB."""
    stage = stage_bytes(width, split)
    return 1024 + SUBMAX_RING_BYTES // stage * stage


def submax_tiles(block: int, segment: int, block_rows: int, spb: int
                 ) -> range:
    """The row tiles that segment ``segment`` of row block ``block`` scores
    (every query group alike)."""
    seg = block_rows // TILE_ROWS // spb
    t0 = block * block_rows // TILE_ROWS + segment * seg
    return range(t0, t0 + seg)


def copy_granule(x: torch.Tensor, q: torch.Tensor, row_bytes: int) -> int:
    """How the kernels load rows ``x`` and the query ``q`` as they read
    it: the largest of 16, 8, 4, 2 and 1 bytes that divides the row bytes
    and both bases. 16 is TMA's shape (whole 16-byte units per row at
    16-byte aligned bases); any other takes the same kernels with the
    producer warpgroup copying each stage by that granule (8 and 4:
    cp.async, 2 and 1: plain loads). The query's stride and the column of
    its second half (packed int4's high nibbles' query, f32x3's small
    parts) are multiples of the row bytes, so they allow what the row
    bytes allow."""
    for g in (16, 8, 4, 2):
        if row_bytes % g == 0 and x.data_ptr() % g == 0 \
                and q.data_ptr() % g == 0:
            return g
    return 1


def use_tma(x: torch.Tensor, q: torch.Tensor, row_bytes: int) -> bool:
    """Whether the kernels load rows and queries by TMA
    (``copy_granule`` 16)."""
    return copy_granule(x, q, row_bytes) == 16


_SMS: dict = {}


def _sms(device) -> int:
    """The device's SM count, asked once per device."""
    index = torch.device(device).index
    if index not in _SMS:
        _SMS[index] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _SMS[index]


def _on(device):
    """The device guard of a launch, where ``device`` is not already the
    current one (the kernels launch on the current device)."""
    if device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


# -- K1 ------------------------------------------------------------------


def _topk_plain(call, k, index_offset, theta0):
    b, dev = call.b, call.device
    t0 = _theta(theta0, b, dev)[:, None]
    vals = torch.full((b, k), NEG_INF, dtype=torch.float32, device=dev)
    idx = torch.full((b, k), -1, dtype=torch.int32, device=dev)
    step = max(1, _PLAIN_SCORE_ELEMS // max(b, 1))
    for lo in range(0, call.n, step):
        hi = min(call.n, lo + step)
        s = call.scores(lo, hi)
        s = torch.where(s > t0, s, NEG_INF)
        blk = torch.arange(lo, hi, dtype=torch.int32, device=dev) \
            + int(index_offset)
        vals, idx = D.merge_topk(vals, idx, s, blk.expand(b, -1), k)
    return vals, torch.where(torch.isneginf(vals), -1, idx)


def fused_topk_plain(x, aux, valid, q, *, k, metric, index_offset=0,
                     theta0=None, row_bias=None, q_scale=None, packed=False,
                     precision="fast"):
    """Plain PyTorch K1: the top-k of the slots whose score beats theta0,
    ordered by (value desc, slot asc), as (values (B, k) f32, slots (B, k)
    i32) with (-inf, -1) on empty ranks."""
    call = _Call(x, aux, valid, q, metric, row_bias, q_scale, packed,
                 precision)
    return _topk_plain(call, k, index_offset, theta0)


def fused_topk(x, aux, valid, q, *, k, metric, index_offset=0,
               theta0=None, row_bias=None, q_scale=None, packed=False,
               precision="fast"):
    """Exact top-k of query q (B, D) against rows x (N, D), or (N, D/2)
    packed int4 bytes with ``packed``: the contract of
    ``pallas_topk.fused_topk``.

    ``theta0`` (B,) or (B, 1): a SOUND floor (<= the true k-th score);
    candidates at or below it are skipped, which keeps results exact.
    ``index_offset`` shifts the returned slots. int8/int4 + l2 needs
    ``row_bias`` (N,) = -|x_hat|^2 and ``q_scale``, the query's int8
    quantization scale. ``precision`` matters for float32 rows only:
    "fast" scores in TF32, "high" and "exact" in three TF32 products (the
    Pallas kernel's HIGHEST)."""
    call = _Call(x, aux, valid, q, metric, row_bias, q_scale, packed,
                 precision)
    if k < 1:
        raise ValueError("k must be >= 1")
    if index_offset < 0 or index_offset + call.n >= 2 ** 31:
        raise ValueError(f"index_offset {index_offset} out of range")
    if call.device.type == "cpu":
        return _topk_plain(call, k, index_offset, theta0)
    return _topk_cuda(_build.load(), call, k, index_offset, theta0)


_RINGS: dict = {}


def lib_ring(lib) -> int:
    """The ring depth kernel library ``lib`` was built with."""
    if id(lib) not in _RINGS:
        _RINGS[id(lib)] = int(lib.vrod_k1_ring())
    return _RINGS[id(lib)]


def card_plan(lib, call, k) -> TopkPlan:
    """``topk_plan`` of a launch of ``call`` from ``lib`` on its card, at
    the library's ring depth and the call's leg's stages."""
    return topk_plan(call.n, call.b, k, _sms(call.device), lib_ring(lib),
                     call.split)


def _topk_cuda(lib, call, k, index_offset, theta0):
    """K1's launch on the card from kernel library ``lib`` (the default
    build; ``tools/`` passes variants built with other defines): the
    kernel ``scan_route`` picks, and the long scans' merge. Each writes
    every rank of the outputs."""
    n, b, dev = call.n, call.b, call.device
    if n == 0:
        return (torch.full((b, k), NEG_INF, dtype=torch.float32, device=dev),
                torch.full((b, k), -1, dtype=torch.int32, device=dev))
    out_v = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, k), dtype=torch.int32, device=dev)
    t0 = None if theta0 is None else _theta(theta0, b, dev)
    head = (call.elem, call.epi, call.granule, *call.pointers(), _ptr(t0),
            n, call.row_bytes, b, k, int(index_offset))
    sms = _sms(dev)
    route = scan_route(n, b, k, sms, t0 is not None)
    with _on(dev):
        if route == "small":
            rc = lib.vrod_fused_topk_small(
                *head, *small_plan(n, b, k, sms), out_v.data_ptr(),
                out_i.data_ptr(), *call.maps(SMALL_GROUP), _stream(dev))
        elif route == "floor":
            plan = floor_plan(n, b, k, sms)
            scratch = torch.empty(floor_scratch_bytes(plan, b, k),
                                  dtype=torch.uint8, device=dev)
            rc = lib.vrod_fused_topk_floor(
                *head, *plan, scratch.data_ptr(), out_v.data_ptr(),
                out_i.data_ptr(), *call.maps(FLOOR_GROUP), _stream(dev))
        else:
            plan = card_plan(lib, call, k)
            scratch = torch.empty(scratch_bytes(plan, b, k),
                                  dtype=torch.uint8, device=dev)
            rc = lib.vrod_fused_topk(
                *head, plan.groups, plan.parts, plan.cap, int(plan.on_chip),
                plan.ring, scratch.data_ptr(),
                out_v.data_ptr(), out_i.data_ptr(),
                *call.maps(GROUP_QUERIES), _stream(dev))
    _ok(rc, "fused_topk launch")
    launches[f"fused_topk[{call.leg}]"] += 1
    if call.granule != 16:
        copy_launches[f"fused_topk[{call.leg}]"] += 1
    if route == "small":
        small_scans[call.leg] += 1
    elif route == "floor":
        floor_scans[call.leg] += 1
    return out_v, out_i


# -- K3 ------------------------------------------------------------------


def _check_blocks(n, block_rows):
    if block_rows % 128 or n % block_rows or n == 0:
        raise ValueError(
            f"sampled_submax needs rows ({n}) a positive multiple of "
            f"block_rows ({block_rows}), itself a multiple of 128")


def _submax_plain(call, block_rows):
    s = call.scores(0, call.n)
    nb = call.n // block_rows
    return s.reshape(call.b, nb, block_rows // 128, 128).amax(dim=2) \
        .reshape(call.b, nb * 128)


def sampled_submax_plain(x, aux, valid, q, *, metric, block_rows,
                         row_bias=None, q_scale=None, packed=False,
                         precision="fast"):
    """Plain PyTorch K3: (B, 128 * N / block_rows) f32, lane t of block j
    the max score over rows j*block_rows + t + 128*i."""
    call = _Call(x, aux, valid, q, metric, row_bias, q_scale, packed,
                 precision)
    _check_blocks(call.n, block_rows)
    return _submax_plain(call, block_rows)


def sampled_submax(x, aux, valid, q, *, metric, block_rows, row_bias=None,
                   q_scale=None, packed=False, precision="fast"):
    """Group-maxima score pre-pass behind the engine's sampled floor; the
    contract of ``pallas_topk.sampled_submax`` (``row_bias``/``q_scale``/
    ``packed``/``precision`` as for ``fused_topk``), scored as K1 scores."""
    call = _Call(x, aux, valid, q, metric, row_bias, q_scale, packed,
                 precision)
    n, b = call.n, call.b
    _check_blocks(n, block_rows)
    if call.device.type == "cpu":
        return _submax_plain(call, block_rows)
    return _submax_cuda(_build.load(), call, block_rows)


def _submax_cuda(lib, call, block_rows):
    """K3's launch on the card from kernel library ``lib`` (the default
    build; ``tools/`` passes variants built with other defines)."""
    n, b, dev = call.n, call.b, call.device
    out = torch.empty((b, 128 * (n // block_rows)), dtype=torch.float32,
                      device=dev)
    width, groups, spb = submax_plan(n, b, block_rows, _sms(dev),
                                     call.split)
    maps = call.maps(width)
    with _on(dev):
        rc = lib.vrod_sampled_submax(
            call.elem, call.epi, call.granule, *call.pointers(), n,
            call.row_bytes, b, block_rows, width,
            spb, groups, out.data_ptr(), *maps, _stream(dev))
    _ok(rc, "sampled_submax launch")
    launches[f"sampled_submax[{call.leg}]"] += 1
    if call.granule != 16:
        copy_launches[f"sampled_submax[{call.leg}]"] += 1
    return out
