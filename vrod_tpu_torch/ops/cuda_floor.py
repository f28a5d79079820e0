"""The port's floor and gate kernels: the counterparts of the JAX package's
A/B experiments kexp17 and kexp20 (X6, X8: the sampled floor fused into
the scan) and kexp22 (X9: the scan's gate bounded from the int32
accumulator). Each wrapper validates its inputs as ``cuda_topk.fused_topk``
does and dispatches on the device of the tensors it is given: a CPU tensor
goes to the plain PyTorch version beside it, a CUDA tensor launches the
hand-written CUDA kernel (or raises). No wrapper falls back from the kernel
to the plain version.

- ``fused_theta`` (X6/X8, ``csrc/fused_theta.cu``) replaces the Pallas
  kernels ``kexp20.fused_theta_gated`` and ``kexp17.fused_theta``: one
  cooperative launch scores the prefix sample ``s_blocks * block_rows``
  into K3's strided 128-group maxima, bisects them for a floor below their
  k-th largest (``distances.bisect_floor``), and runs K1's gated scan from
  ``floor - margin`` (X6's margin; X8 is margin 0, which the shared scoring
  core makes sound), then K1's merge. ``skip_sample_dots`` lets a sample
  tile whose block maxima beat no gate pass without its dots. Stock, the
  engine runs K3, the count threshold and K1 for the same result. Its
  grid and shared memory are K1's (``cuda_topk.topk_plan``: query groups
  of 64, lists on chip where they fit). It takes every leg of K1: float32
  rows at ``precision`` "high" or "exact" (the experiments'
  ``precision_name``) score in three TF32 products (leg ``f32x3``,
  ``csrc/fused_theta_f32x3.cu``), the sample and the scan alike;
  ``bisect_iters`` is the experiments' bisection count.
- ``fused_intgate`` (X9, ``csrc/fused_topk.cu`` with the int gate) replaces
  the Pallas kernel ``kexp22.fused_intgate``: K1 for int8 rows under cosine
  or dot that holds each int32 dot against an integer bound derived from
  its query's gate before the float epilogue (``int_gate``).

Bound on the H100: both do K1's work (bytes of every row), X6/X8 plus the
sample's. Both return exactly K1's result for their floor: the floor is
sound and the bound only skips scores that cannot pass.

``launches`` counts kernel launches per kernel and leg (e.g.
``fused_theta[bf16-cosine]``); only a CUDA launch adds to it.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from . import _build
from . import cuda_topk as K
from . import distances as D

# Bisection steps of the in-kernel floor: what kexp17/kexp20's harnesses
# pass as bisect_iters, the wrappers' default.
BISECT_ITERS = 14
INTGATE_LEGS = ("int8-cosine", "int8-dot")
# The int gate's integer range: every dot |g| <= 127 * 127 * dim stays
# below 2^30 up to this dim.
INTGATE_MAX_DIM = 65536
INT32_MIN, INT32_MAX = -(2 ** 31), 2 ** 31 - 1
_COOP_TOO_LARGE = 720  # cudaErrorCooperativeLaunchTooLarge

# fused_theta's legs: K1's, f32x3 (float32 at "high"/"exact") included.
LEGS = K.LEGS
launches = {f"fused_theta[{leg}]": 0 for leg in LEGS}
launches.update({f"fused_intgate[{leg}]": 0 for leg in INTGATE_LEGS})


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _ok(rc: int, what: str) -> None:
    if rc == _COOP_TOO_LARGE:
        raise RuntimeError(f"{what}: the grid cannot be co-resident on the "
                           "card (cooperative launch too large)")
    K._ok(rc, what)


# -- X6/X8 -----------------------------------------------------------------


class ThetaPlan(NamedTuple):
    """fused_theta's grid (``theta_plan``): K1's and the sample's."""
    groups: int
    parts: int
    cap: int
    on_chip: bool
    ring: int
    sample_tiles: int   # the sample: rows [0, 128 * sample_tiles)
    blk_tiles: int      # tiles of a sample block


def theta_plan(n: int, b: int, k: int, block_rows: int, s_blocks: int,
               sms: int, ring: int = K.RING,
               split: bool = False) -> ThetaPlan:
    """fused_theta's grid for n rows, b queries, top-k and a sample of
    ``s_blocks`` blocks of ``block_rows`` rows on ``sms`` SMs. The grid is
    K1's persistent one (``topk_plan`` at ``ring``, ``split`` on the f32x3
    legs), which must be co-resident for the kernel's
    barriers; the sample is rows [0, 128 * sample_tiles), block j its tiles
    [j * blk_tiles, (j + 1) * blk_tiles), and part p scores the p-th of
    ``parts`` equal runs of its tiles (``sample_run``)."""
    if block_rows % K.TILE_ROWS or block_rows <= 0 or s_blocks < 1:
        raise ValueError(f"block_rows ({block_rows}) must be a positive "
                         f"multiple of 128 and s_blocks ({s_blocks}) >= 1")
    if s_blocks * block_rows > n:
        raise ValueError(f"the sample ({s_blocks} x {block_rows} rows) is "
                         f"longer than the rows ({n})")
    if s_blocks * K.TILE_ROWS < 2 * k:
        raise ValueError(f"the floor needs >= 2k sub-maxima: {s_blocks} "
                         f"blocks give {s_blocks * K.TILE_ROWS} for k {k}")
    plan = K.topk_plan(n, b, k, sms, ring, split)
    return ThetaPlan(*plan, s_blocks * block_rows // K.TILE_ROWS,
                     block_rows // K.TILE_ROWS)


def sample_run(part: int, parts: int, sample_tiles: int) -> range:
    """The sample tiles that fused_theta's blocks of one part score."""
    return range(part * sample_tiles // parts,
                 (part + 1) * sample_tiles // parts)


def _margin(margin, b, device):
    if margin is None:
        return torch.zeros(b, dtype=torch.float32, device=device)
    m = torch.as_tensor(margin, dtype=torch.float32, device=device)
    return m.expand(b, 1).reshape(b).contiguous() if m.numel() == 1 \
        else m.reshape(b).contiguous()


def fused_theta_plain(x, aux, valid, q, *, k, metric, block_rows, s_blocks,
                      margin=None, skip_sample_dots=False, row_bias=None,
                      q_scale=None, packed=False, return_theta=False,
                      precision="fast", bisect_iters=BISECT_ITERS):
    """Plain PyTorch X6/X8: ``sampled_submax_plain`` over the first
    ``s_blocks * block_rows`` rows (the experiments' grouping), then
    ``bisect_floor`` in ``bisect_iters`` steps, then ``- margin``, then
    ``fused_topk_plain`` from that theta0, both scored at ``precision``;
    (values, slots) and with ``return_theta`` theta0 (B, 1).
    ``skip_sample_dots`` changes the kernel's work, never the result."""
    del skip_sample_dots
    call = K._Call(x, aux, valid, q, metric, row_bias, q_scale, packed,
                   precision)
    theta_plan(call.n, call.b, k, block_rows, s_blocks, 1)
    ns = s_blocks * block_rows
    sub = K.sampled_submax_plain(
        x[:ns], aux[:ns], valid[:ns], q, metric=metric,
        block_rows=block_rows, q_scale=q_scale, packed=packed,
        row_bias=None if row_bias is None else row_bias.reshape(-1)[:ns],
        precision=precision)
    theta0 = D.bisect_floor(sub, k, bisect_iters) \
        - _margin(margin, call.b, call.device)[:, None]
    vals, idx = K._topk_plain(call, k, 0, theta0)
    return (vals, idx, theta0) if return_theta else (vals, idx)


def fused_theta(x, aux, valid, q, *, k, metric, block_rows, s_blocks,
                margin=None, skip_sample_dots=False, row_bias=None,
                q_scale=None, packed=False, return_theta=False,
                precision="fast", bisect_iters=BISECT_ITERS):
    """Exact top-k of q (B, D) against rows x, with the floor taken in the
    same launch from a prefix sample of ``s_blocks`` blocks of
    ``block_rows`` rows: the contract of ``kexp20.fused_theta_gated``
    (``margin`` None) and ``kexp17.fused_theta`` (``margin`` (B,) or (B,
    1), subtracted from the floor), their ``precision_name`` and
    ``bisect_iters`` as ``precision`` and ``bisect_iters``. Arguments as
    for ``fused_topk``; with ``return_theta`` also theta0 (B, 1), the floor
    the scan started from."""
    call = K._Call(x, aux, valid, q, metric, row_bias, q_scale, packed,
                   precision)
    if k < 1:
        raise ValueError("k must be >= 1")
    kw = dict(k=k, metric=metric, block_rows=block_rows, s_blocks=s_blocks,
              margin=margin, row_bias=row_bias, q_scale=q_scale,
              packed=packed, return_theta=return_theta, precision=precision,
              bisect_iters=bisect_iters)
    if call.device.type == "cpu":
        return fused_theta_plain(x, aux, valid, q, **kw)
    n, b, dev = call.n, call.b, call.device
    lib = _build.load()
    plan = theta_plan(n, b, k, block_rows, s_blocks, K._sms(dev),
                      K.lib_ring(lib), call.split)
    parts = plan.parts
    out_v = torch.full((b, k), K.NEG_INF, dtype=torch.float32, device=dev)
    out_i = torch.full((b, k), -1, dtype=torch.int32, device=dev)
    m = _margin(margin, b, dev)
    stride = k if plan.on_chip else plan.cap
    with torch.cuda.device(dev):
        sub_keys = torch.empty(b * K.TILE_ROWS * s_blocks, dtype=torch.int32,
                               device=dev)
        bmax = torch.empty(b * s_blocks, dtype=torch.float32, device=dev)
        theta0 = torch.empty(b, dtype=torch.float32, device=dev)
        cand_v = torch.empty(parts * b * stride, dtype=torch.float32,
                             device=dev)
        cand_i = torch.empty(parts * b * stride, dtype=torch.int32,
                             device=dev)
        cand_n = torch.empty(parts * b, dtype=torch.int32, device=dev)
        merge_v = torch.empty(b * parts * k, dtype=torch.float32, device=dev)
        merge_i = torch.empty(b * parts * k, dtype=torch.int32, device=dev)
        rc = lib.vrod_fused_theta(
            call.elem, call.epi, call.granule, call.x.data_ptr(),
            call.aux.data_ptr(), call.mask.data_ptr(), call.q.data_ptr(),
            K._ptr(call.qs2), m.data_ptr(), n, call.row_bytes, b, k, 0,
            plan.groups, parts, plan.cap, int(plan.on_chip), plan.ring,
            plan.sample_tiles, plan.blk_tiles,
            int(bisect_iters), int(bool(skip_sample_dots)),
            sub_keys.data_ptr(),
            bmax.data_ptr(), theta0.data_ptr(), cand_v.data_ptr(),
            cand_i.data_ptr(), cand_n.data_ptr(), merge_v.data_ptr(),
            merge_i.data_ptr(), out_v.data_ptr(), out_i.data_ptr(),
            K._stream(dev))
    _ok(rc, "fused_theta launch")
    launches[f"fused_theta[{call.leg}]"] += 1
    if return_theta:
        return out_v, out_i, theta0[:, None]
    return out_v, out_i


# -- X9 --------------------------------------------------------------------


def _ub(g, amin, amax):
    """kexp22's bound of fl(fl(g) * aux) over aux in [amin, amax], float32
    (numpy scalars or arrays)."""
    g = np.asarray(g)
    return np.where(g >= 0, g.astype(np.float32) * np.float32(amax),
                    g.astype(np.float32) * np.float32(amin)).astype(
                        np.float32)


def int_gate(t, amin, amax) -> int:
    """G for gate ``t``: the largest int32 dot g whose bound ub(g) (``_ub``)
    is at or below t, so a score with dot g <= G cannot beat t; INT32_MIN
    when none is (every score takes the exact test), INT32_MAX when every
    |g| < 2^30 is. A range that breaks the bound's premises (aux < 0, not
    finite, empty) gives INT32_MIN. The host transcription of
    ``topk.cuh: int_gate``, op for op."""
    t, amin, amax = np.float32(t), np.float32(amin), np.float32(amax)
    if not (amin >= 0 and amin <= amax and amax < np.inf) or np.isnan(t) \
            or t == -np.inf:
        return INT32_MIN
    if t == np.inf:
        return INT32_MAX
    lim = 1 << 30
    a = float(amax if t >= 0 else amin)
    est = float(t) / a if a > 0 else (lim if t >= 0 else -lim)
    g = math.floor(min(max(est, -lim), lim))

    def ub(v):
        return _ub(v, amin, amax)[()]

    while g < lim and ub(g + 1) <= t:
        g += 1
    while g > -lim and ub(g) > t:
        g -= 1
    if g <= -lim:
        return INT32_MIN
    return INT32_MAX if g >= lim else int(g)


def _intgate_call(x, aux, valid, q, metric, k):
    if x.dtype != torch.int8 or metric not in ("cosine", "dot"):
        raise ValueError(
            f"fused_intgate takes int8 rows under cosine or dot (kexp22's "
            f"quantized epilogue), not {x.dtype} {metric}")
    call = K._Call(x, aux, valid, q, metric, None, None, False)
    if x.shape[1] > INTGATE_MAX_DIM:
        raise ValueError(f"fused_intgate: dim {x.shape[1]} > "
                         f"{INTGATE_MAX_DIM}")
    if k < 1:
        raise ValueError("k must be >= 1")
    return call


def tile_bounds(g, aux):
    """kexp22's bound of each query's best score in each 128-row tile, from
    the int32 dots ``g`` (B, R) (as exact floats) of R rows with scales
    ``aux`` (R,): gmax >= 0 ? fl(gmax * amax) : fl(gmax * amin) over the
    tile, (B, ceil(R / 128)) f32."""
    b, r = g.shape
    pad = -r % K.TILE_ROWS
    gmax = F.pad(g.float(), (0, pad), value=K.NEG_INF) \
        .reshape(b, -1, K.TILE_ROWS).amax(dim=2)
    a = aux.float()
    amax = F.pad(a, (0, pad), value=K.NEG_INF).reshape(-1, K.TILE_ROWS) \
        .amax(dim=1)
    amin = F.pad(a, (0, pad), value=float("inf")).reshape(-1, K.TILE_ROWS) \
        .amin(dim=1)
    return torch.where(gmax >= 0, gmax * amax, gmax * amin)


def fused_intgate_plain(x, aux, valid, q, *, k, metric, theta0=None):
    """Plain PyTorch X9: the int32 dots of each 128-row tile bound each
    query's best score in it (``tile_bounds``); a tile whose bound does not
    clear theta0 contributes nothing, and the others go to the exact
    epilogue and the gate. The bound changes the work, never the answer:
    ``fused_topk_plain``'s result."""
    call = _intgate_call(x, aux, valid, q, metric, k)
    b, dev, T = call.b, call.device, K.TILE_ROWS
    t0 = K._theta(theta0, b, dev)[:, None]
    vals = torch.full((b, k), K.NEG_INF, dtype=torch.float32, device=dev)
    idx = torch.full((b, k), -1, dtype=torch.int32, device=dev)
    step = max(T, K._PLAIN_SCORE_ELEMS // max(b, 1) // T * T)
    for lo in range(0, call.n, step):
        hi = min(call.n, lo + step)
        g = D._matmul_f32(call.q, x[lo:hi])  # exact int32 dots as floats
        s = g * aux[lo:hi][None, :] + call.mask[lo:hi][None, :]
        clear = (tile_bounds(g, aux[lo:hi]) > t0) \
            .repeat_interleave(T, dim=1)[:, :hi - lo]
        s = torch.where(clear & (s > t0), s, K.NEG_INF)
        blk = torch.arange(lo, hi, dtype=torch.int32, device=dev)
        vals, idx = D.merge_topk(vals, idx, s, blk.expand(b, -1), k)
    return vals, torch.where(torch.isneginf(vals), -1, idx)


def fused_intgate(x, aux, valid, q, *, k, metric, theta0=None):
    """K1 with the int32 gate bound: the contract of ``fused_topk`` for int8
    rows under cosine or dot (the contract of ``kexp22.fused_intgate``).
    On the card it takes K1's long-scan kernel that ``cuda_topk.scan_route``
    gives a call with or without theta0 (the floor's n256 scan or the
    gated core), built with the bound."""
    call = _intgate_call(x, aux, valid, q, metric, k)
    if call.device.type == "cpu":
        return fused_intgate_plain(x, aux, valid, q, k=k, metric=metric,
                                   theta0=theta0)
    n, b, dev = call.n, call.b, call.device
    out_v = torch.full((b, k), K.NEG_INF, dtype=torch.float32, device=dev)
    out_i = torch.full((b, k), -1, dtype=torch.int32, device=dev)
    if n == 0:
        return out_v, out_i
    t0 = K._theta(theta0, b, dev)
    lib = _build.load()
    head = (call.granule, call.x.data_ptr(), call.aux.data_ptr(),
            call.valid.data_ptr(), call.q.data_ptr(), t0.data_ptr(), n,
            call.row_bytes, b, k, 0)
    with torch.cuda.device(dev):
        if theta0 is not None:
            fplan = K.floor_plan(n, b, k, K._sms(dev))
            scratch = torch.empty(K.floor_scratch_bytes(fplan, b, k),
                                  dtype=torch.uint8, device=dev)
            rc = lib.vrod_fused_intgate_floor(
                *head, *fplan, scratch.data_ptr(), out_v.data_ptr(),
                out_i.data_ptr(), K._stream(dev))
        else:
            plan = K.card_plan(lib, call, k)
            scratch = torch.empty(K.scratch_bytes(plan, b, k),
                                  dtype=torch.uint8, device=dev)
            rc = lib.vrod_fused_intgate(
                *head, plan.groups, plan.parts, plan.cap, int(plan.on_chip),
                plan.ring, scratch.data_ptr(), out_v.data_ptr(),
                out_i.data_ptr(), K._stream(dev))
    _ok(rc, "fused_intgate launch")
    launches[f"fused_intgate[{call.leg}]"] += 1
    return out_v, out_i
