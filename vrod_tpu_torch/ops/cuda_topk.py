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
  auto-pipelined ``_fused_call``/``_kernel``, which the CUDA kernel covers:
  it takes any dim). Bound on the H100 by bytes: one search streams every
  stored row, 805 MB of int8 at 1M x 768, with the dots (on the tensor
  cores) close behind. A persistent grid (``topk_plan``) streams each row
  tile once per group of 256 queries through a TMA ring into wgmma, gates
  every score in its register against max(theta0, the query's running
  k-th), and writes only the candidates that pass; see the source for the
  exact select and merge that replace the TPU's sequential carry.
- ``sampled_submax`` (K3, ``csrc/sampled_submax.cu``) replaces
  ``pallas_topk.sampled_submax`` -> ``_submax_kernel``. It scores a prefix
  sample with K1's scoring core (bit-identical scores, which the floor's
  soundness needs) and emits 128 strided group maxima per row block. The
  sample is small (25 MB at the int8 headline), so parallelism bounds it:
  ``submax_plan`` splits each row block into segments so the grid fills
  the card.

Scores, in both (``csrc/score.cuh``), with mask 0 on live slots and -inf on
dead ones and every float op rounded once:
- int8/int4 rows: g, the exact int32 dot of the int8 query and the row
  (int4: two half-dim dots over the low and high nibbles); cosine and dot
  ``float(g) * aux + mask``; l2 ``(float(g) * aux) * (2 * q_scale) +
  mask`` with ``-|x_hat|^2`` (``row_bias``) as the live mask value.
- bfloat16 rows: the query rounds to bfloat16; g sums the exact products in
  float32. float32 rows: both operands round to TF32 (10 mantissa bits, to
  nearest, ties away from zero: ``cvt.rna.tf32.f32``) and g sums their
  exact products in float32. Then cosine ``g * aux + mask``, l2 ``(2g -
  aux) + mask``, dot ``g + mask``. Float sums run in another order on the
  tensor cores than in the plain version, so these legs agree with it to
  a bound (``score_error_bound``), not bit for bit; the engine's exact
  float32 rescore restores exactness.

``launches`` counts kernel launches per kernel and leg (e.g.
``fused_topk[int8-l2]``); only a CUDA launch adds to it.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from . import distances as D

NEG_INF = float("-inf")
# Rows per block of the plain versions: bounds their (B, rows) score
# matrix at 256 MB.
_PLAIN_SCORE_ELEMS = 1 << 26

# Row dtypes of the legs (int4 rows are packed int8 bytes) and score.cuh's
# Elem / Epi codes.
LEG_DTYPES = ("int8", "int4", "bf16", "f32")
LEG_METRICS = ("cosine", "dot", "l2")
LEGS = tuple(f"{d}-{m}" for d in LEG_DTYPES for m in LEG_METRICS)
_ELEM = {"int8": 0, "int4": 1, "bf16": 2, "f32": 3}
_EPI_SCALE, _EPI_SCALE_QS, _EPI_L2, _EPI_DOT = range(4)

# The kernels' geometry (csrc/score.cuh): rows per tile, queries per block
# (the wgmma N side). K1 cuts its candidate lists every CUT_TILES tiles,
# so a list holds one tile more than that (the kernel derives the interval
# from the capacity).
TILE_ROWS = 128
GROUP_QUERIES = 256
CUT_TILES = 4

launches = {f"{kern}[{leg}]": 0 for kern in ("fused_topk", "sampled_submax")
            for leg in LEGS}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _row_kind(x: torch.Tensor, packed: bool) -> str:
    return "int4" if packed else {torch.int8: "int8", torch.bfloat16: "bf16",
                                  torch.float32: "f32"}[x.dtype]


def leg_name(x: torch.Tensor, metric: str, packed: bool = False) -> str:
    """The leg of rows x under ``metric``, e.g. ``int4-l2``."""
    return f"{_row_kind(x, packed)}-{metric}"


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 as ``cvt.rna.tf32.f32`` does: keep 10
    mantissa bits, to nearest, ties away from zero (a new tensor)."""
    bits = t.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


class _Call:
    """A validated kernel call: the leg, and the inputs as both the kernel
    and the plain version take them."""

    def __init__(self, x, aux, valid, q, metric, row_bias, q_scale, packed):
        if metric not in LEG_METRICS:
            raise ValueError(f"metric {metric!r}: expected one of "
                             f"{LEG_METRICS}")
        if x.dim() != 2 or x.dtype not in (torch.int8, torch.bfloat16,
                                           torch.float32):
            raise TypeError(f"x must be (N, D) int8, bfloat16 or float32, "
                            f"got {tuple(x.shape)} {x.dtype}")
        if packed and x.dtype != torch.int8:
            raise TypeError("packed int4 rows are int8 bytes")
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
        self.leg = leg_name(x, metric, packed)
        self.elem = _ELEM[_row_kind(x, packed)]
        self.packed = packed
        self.x, self.aux = x, aux
        # The query as the kernel reads it: bfloat16 rows take it rounded
        # to bfloat16 (the Pallas kernel's q.astype(x.dtype)), float32 rows
        # rounded to TF32 (the tensor cores would truncate it).
        if self.quant:
            self.q = q
        elif x.dtype == torch.float32:
            self.q = tf32_round(q)
        else:
            self.q = q.to(x.dtype).contiguous()
        # The additive mask stream: -inf on dead slots, else row_bias (0
        # everywhere but int8/int4 + l2's -|x_hat|^2).
        mask = torch.zeros_like(aux) if row_bias is None \
            else row_bias.float().reshape(self.n).clone()
        self.mask = mask.masked_fill_(~valid, NEG_INF)
        self.qs2 = (2.0 * q_scale.float()).reshape(self.b).contiguous() \
            if quant_l2 else None
        if self.quant:
            self.epi = _EPI_SCALE_QS if quant_l2 else _EPI_SCALE
        else:
            self.epi = {"cosine": _EPI_SCALE, "l2": _EPI_L2,
                        "dot": _EPI_DOT}[metric]

    def scores(self, lo, hi):
        """Plain scores (B, hi - lo) of rows [lo, hi): the kernels' inputs
        rounded as they round them, then each epilogue op rounded once."""
        x, aux = self.x[lo:hi], self.aux[lo:hi][None, :]
        if self.packed:
            g = D._matmul_f32(self.q, D.unpack_int4_rows(x))
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
            s = (g * aux) * self.qs2[:, None]
        elif self.epi == _EPI_L2:
            s = 2.0 * g - aux
        else:
            s = g
        return s + self.mask[lo:hi][None, :]

    def launch_args(self):
        qs2 = self.qs2.data_ptr() if self.qs2 is not None else None
        return (self.elem, self.epi,
                int(use_tma(self.x, self.q, self.row_bytes)),
                self.x.data_ptr(),
                self.aux.data_ptr(), self.mask.data_ptr(), self.q.data_ptr(),
                qs2)

    @property
    def row_bytes(self) -> int:
        return self.x.shape[1] * self.x.element_size()


def score_error_bound(x, aux, valid, q, *, metric):
    """Per-query (B, 1) bound on |kernel score - plain score| for one leg.

    0 for int8/int4 rows: exact dots, then the same rounded epilogue ops.
    bfloat16/float32 rows: the kernel and the plain version round their
    inputs alike and sum the same exact products in another order. Each
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
    call = _Call(x, aux, valid, q, metric, None, None, False)
    round_ = tf32_round if x.dtype == torch.float32 else torch.Tensor.float
    qn = torch.linalg.norm(round_(call.q), dim=1, keepdim=True)
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


def _ok(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")


def _stream(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def topk_plan(n: int, b: int, k: int, sms: int) -> tuple[int, int, int]:
    """K1's persistent grid for n rows, b queries, top-k on ``sms`` SMs:
    (groups, parts, cap). Block (part p, group g) scores query group g
    (queries [256 g, 256 g + 256)) against row tiles p, p + parts, ... (128
    rows each; ``part_tiles``), about one block per SM; cap is the capacity
    of a (part, query) candidate list: k plus the slack of the tiles between
    two cuts and one more."""
    groups = _cdiv(b, GROUP_QUERIES)
    parts = max(1, min(_cdiv(n, TILE_ROWS), sms // groups))
    return groups, parts, k + (CUT_TILES + 1) * TILE_ROWS


def part_tiles(part: int, parts: int, n: int) -> range:
    """The row tiles that K1's blocks of one part walk, in order."""
    return range(part, _cdiv(n, TILE_ROWS), parts)


def submax_plan(n: int, b: int, block_rows: int, sms: int
                ) -> tuple[int, int]:
    """K3's grid for an n-row sample in blocks of ``block_rows`` (a
    multiple of 128) on ``sms`` SMs: (groups, spb). Each row block splits
    into spb segments of whole 128-row tiles, spb a power of two dividing
    block_rows / 128, the largest that keeps the grid (blocks x spb x
    groups) within about one block per SM."""
    groups = _cdiv(b, GROUP_QUERIES)
    target = max(1, sms // ((n // block_rows) * groups))
    spb = 1
    while spb * 2 <= target and (block_rows // TILE_ROWS) % (spb * 2) == 0:
        spb *= 2
    return groups, spb


def use_tma(x: torch.Tensor, q: torch.Tensor, row_bytes: int) -> bool:
    """Whether the kernels load rows and queries by TMA: whole 16-byte
    units per row and 16-byte aligned bases. Other shapes (int8 dim 30,
    packed int4 dim 30) take the same kernels with the producer warp
    copying each stage."""
    return row_bytes % 16 == 0 and x.data_ptr() % 16 == 0 \
        and q.data_ptr() % 16 == 0


def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


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
                     theta0=None, row_bias=None, q_scale=None, packed=False):
    """Plain PyTorch K1: the top-k of the slots whose score beats theta0,
    ordered by (value desc, slot asc), as (values (B, k) f32, slots (B, k)
    i32) with (-inf, -1) on empty ranks."""
    call = _Call(x, aux, valid, q, metric, row_bias, q_scale, packed)
    return _topk_plain(call, k, index_offset, theta0)


def fused_topk(x, aux, valid, q, *, k, metric, index_offset=0,
               theta0=None, row_bias=None, q_scale=None, packed=False):
    """Exact top-k of query q (B, D) against rows x (N, D), or (N, D/2)
    packed int4 bytes with ``packed``: the contract of
    ``pallas_topk.fused_topk``.

    ``theta0`` (B,) or (B, 1): a SOUND floor (<= the true k-th score);
    candidates at or below it are skipped, which keeps results exact.
    ``index_offset`` shifts the returned slots. int8/int4 + l2 needs
    ``row_bias`` (N,) = -|x_hat|^2 and ``q_scale``, the query's int8
    quantization scale."""
    call = _Call(x, aux, valid, q, metric, row_bias, q_scale, packed)
    if k < 1:
        raise ValueError("k must be >= 1")
    if index_offset < 0 or index_offset + call.n >= 2 ** 31:
        raise ValueError(f"index_offset {index_offset} out of range")
    if call.device.type == "cpu":
        return _topk_plain(call, k, index_offset, theta0)
    return _topk_cuda(_build.load(), call, k, index_offset, theta0)


def _topk_cuda(lib, call, k, index_offset, theta0):
    """K1's launch on the card from kernel library ``lib`` (the default
    build; ``tools/`` passes variants built with other defines)."""
    n, b, dev = call.n, call.b, call.device
    out_v = torch.full((b, k), NEG_INF, dtype=torch.float32, device=dev)
    out_i = torch.full((b, k), -1, dtype=torch.int32, device=dev)
    if n == 0:
        return out_v, out_i
    t0 = _theta(theta0, b, dev)
    groups, parts, cap = topk_plan(n, b, k, _sms(dev))
    with torch.cuda.device(dev):
        cand_v = torch.empty(parts * b * cap, dtype=torch.float32,
                             device=dev)
        cand_i = torch.empty(parts * b * cap, dtype=torch.int32, device=dev)
        cand_n = torch.empty(parts * b, dtype=torch.int32, device=dev)
        merge_v = torch.empty(b * parts * k, dtype=torch.float32, device=dev)
        merge_i = torch.empty(b * parts * k, dtype=torch.int32, device=dev)
        rc = lib.vrod_fused_topk(
            *call.launch_args(), t0.data_ptr(), n, call.row_bytes, b, k,
            int(index_offset), groups, parts, cap,
            cand_v.data_ptr(), cand_i.data_ptr(), cand_n.data_ptr(),
            merge_v.data_ptr(), merge_i.data_ptr(), out_v.data_ptr(),
            out_i.data_ptr(), _stream(dev))
    _ok(rc, "fused_topk launch")
    launches[f"fused_topk[{call.leg}]"] += 1
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
                         row_bias=None, q_scale=None, packed=False):
    """Plain PyTorch K3: (B, 128 * N / block_rows) f32, lane t of block j
    the max score over rows j*block_rows + t + 128*i."""
    call = _Call(x, aux, valid, q, metric, row_bias, q_scale, packed)
    _check_blocks(call.n, block_rows)
    return _submax_plain(call, block_rows)


def sampled_submax(x, aux, valid, q, *, metric, block_rows, row_bias=None,
                   q_scale=None, packed=False):
    """Group-maxima score pre-pass behind the engine's sampled floor; the
    contract of ``pallas_topk.sampled_submax`` (``row_bias``/``q_scale``/
    ``packed`` as for ``fused_topk``), scored as K1 scores."""
    call = _Call(x, aux, valid, q, metric, row_bias, q_scale, packed)
    n, b = call.n, call.b
    _check_blocks(n, block_rows)
    if call.device.type == "cpu":
        return _submax_plain(call, block_rows)
    dev = call.device
    width = 128 * (n // block_rows)
    out = torch.empty((b, width), dtype=torch.float32, device=dev)
    lib = _build.load()
    groups, spb = submax_plan(n, b, block_rows, _sms(dev))
    with torch.cuda.device(dev):
        part = torch.empty(spb * b * width if spb > 1 else 1,
                           dtype=torch.float32, device=dev)
        rc = lib.vrod_sampled_submax(
            *call.launch_args(), n, call.row_bytes, b, block_rows, spb,
            groups, part.data_ptr(), out.data_ptr(), _stream(dev))
    _ok(rc, "sampled_submax launch")
    launches[f"sampled_submax[{call.leg}]"] += 1
    return out
