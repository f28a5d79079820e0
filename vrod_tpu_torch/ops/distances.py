"""Exact kNN search ops in plain PyTorch: the port of ``vrod_tpu.ops.distances``.

Every function keeps the name and signature of its JAX counterpart and works
on torch tensors (``row_norms2`` ports ``vrod_tpu.engine._row_norms2``).
This module is the CPU path of the port and the oracle its CUDA kernels
(``cuda_topk``) are held against on the GPU.

Score convention: higher is better for every metric.
  dot:    s = q . x
  cosine: s = (q_hat . x) * inv_norm_x          (queries pre-normalized)
  l2:     s = 2 q . x - |x|^2                    (|q|^2 - s = squared L2 dist)

Differences from the JAX module that matter for parity:
- Ties come out lowest index first: ``merge_topk`` and ``rescore`` sort with
  ``torch.sort(..., stable=True)``, because ``torch.topk`` promises no order
  among equal values (``lax.top_k`` takes the lowest index first).
- Float32 products never run as TF32: ``_matmul_f32`` refuses to run on a
  CUDA device where TF32 matmuls are switched on, and ``rescore`` is an
  elementwise multiply-and-sum in float32.
- ``threshold_from_submax`` has the "topk" (the default), "count" (the
  engine's default) and "minmax" methods; the JAX "approx" method
  (``lax.approx_max_k``) is exact off the TPU, and the engine runs "topk"
  for it.
"""

from __future__ import annotations

import numpy as np
import torch

NEG_INF = float("-inf")
_INT32_MIN = -(2 ** 31)

# Precision names of the JAX package. Integer rows score exactly at any of
# them; float rows score in float32 at "exact" and from the query cast to
# the row dtype otherwise (with float32 accumulation, as on the TPU).
PRECISIONS = {"exact": "highest", "high": "high", "fast": "default"}

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "int8": torch.int8}


def _reciprocal(c: float) -> float:
    """1 / c rounded to float32. XLA compiles a division by a constant
    under ``jit`` as a multiply by this value, which differs from a true
    division in the last ulp of some quotients (4.5% of random values at
    c = 127, 54.5% at 7); the JAX package quantizes inside ``jit``, so the
    port multiplies too."""
    return float(np.float32(1.0 / c))


def _div_scale(x, norms, scale):
    """``x / norms / scale`` as XLA computes it under ``jit``: it folds
    ``(a / b) / c`` into ``a / (b * c)``, so a normalized row or query is
    quantized by one division by the product (``norms`` None: ``x /
    scale``)."""
    return x / scale if norms is None else x / (norms * scale)


def _as_dtype(dtype):
    return _DTYPES[dtype] if isinstance(dtype, str) else dtype


def _matmul_f32(a, b):
    """a (M, D) @ b (N, D)^T in full float32."""
    if a.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "float32 scores need torch.backends.cuda.matmul.allow_tf32 = "
            "False (TF32 keeps ~3 decimal digits)")
    return a.float() @ b.float().T


def pack_int4(q4):
    """Pack int4 values (B, D) in [-8, 7] into int8 bytes (B, D/2): byte j
    holds dim j in its LOW nibble and dim j + D/2 in its HIGH nibble."""
    d = q4.shape[-1]
    if d % 2:
        raise ValueError(f"int4 packing needs an even dim, got {d}")
    d2 = d // 2
    lo = q4[..., :d2].to(torch.int8)
    hi = q4[..., d2:].to(torch.int8)
    return torch.bitwise_or(torch.bitwise_left_shift(hi, 4),
                            torch.bitwise_and(lo, 0x0F))


def unpack_int4(xp, dtype=torch.int8):
    """Unpack int8 bytes (..., D/2) into signed int4 (lo, hi) halves as
    ``dtype``; sign extension by int32 arithmetic shifts."""
    xi = xp.to(torch.int32)
    lo = torch.bitwise_left_shift(xi, 28) >> 28
    hi = xi >> 4
    return lo.to(dtype), hi.to(dtype)


def unpack_int4_rows(xp, dtype=torch.float32):
    """Unpack packed rows (..., D/2) to full (..., D) rows in dim order."""
    lo, hi = unpack_int4(xp, dtype)
    return torch.cat([lo, hi], dim=-1)


def block_scores(q, x_blk, aux_blk, valid_blk, *, metric: str, precision,
                 packed: bool = False):
    """Scores of query tile q (B, D) against one row block (BLK, D), -inf on
    dead slots. int8/int4 rows score as float32 integers (exact for an
    int8-quantized query) times the per-row dequant scale."""
    if packed:
        g = _matmul_f32(q, unpack_int4_rows(x_blk))
        rows = None
    elif x_blk.dtype == torch.int8:
        g = _matmul_f32(q, x_blk)
        rows = x_blk
    elif precision in ("exact", "highest") or x_blk.dtype == torch.float32:
        g = _matmul_f32(q, x_blk)
    else:  # bf16 rows: the query rounds to bf16, products sum in float32
        g = _matmul_f32(q.to(x_blk.dtype), x_blk)
    if packed or x_blk.dtype == torch.int8:
        if metric == "l2":
            r = unpack_int4_rows(x_blk) if rows is None else rows.float()
            n2 = (r * r).sum(dim=1) * (aux_blk * aux_blk)
            s = 2.0 * (g * aux_blk[None, :]) - n2[None, :]
        else:
            s = g * aux_blk[None, :]
    elif metric == "cosine":
        s = g * aux_blk[None, :]
    elif metric == "l2":
        s = 2.0 * g - aux_blk[None, :]
    else:
        s = g
    return torch.where(valid_blk[None, :], s, NEG_INF)


def merge_topk(carry_vals, carry_idx, new_vals, new_idx, k: int):
    """Merge (B, k) running top-k with (B, m) new candidates -> (B, k).
    The carry comes first, so equal values keep the lower index."""
    cand_v = torch.cat([carry_vals, new_vals], dim=1)
    cand_i = torch.cat([carry_idx, new_idx], dim=1)
    top_v, pos = torch.sort(cand_v, dim=1, descending=True, stable=True)
    return top_v[:, :k], torch.gather(cand_i, 1, pos[:, :k])


def blockwise_topk(x, aux, valid, q, *, k: int, metric: str,
                   precision, block_rows: int, nblocks: int,
                   index_offset=0, packed: bool = False):
    """Running top-k of q (B, D) against the first nblocks*block_rows rows.
    Returns (values (B, k) f32, indices (B, k) i32); empty ranks carry
    -inf / -1."""
    b = q.shape[0]
    dev = x.device
    vals = torch.full((b, k), NEG_INF, dtype=torch.float32, device=dev)
    idx = torch.full((b, k), -1, dtype=torch.int32, device=dev)
    for j in range(nblocks):
        lo, hi = j * block_rows, (j + 1) * block_rows
        s = block_scores(q, x[lo:hi], aux[lo:hi], valid[lo:hi],
                         metric=metric, precision=precision, packed=packed)
        blk_idx = torch.arange(lo, hi, dtype=torch.int32, device=dev) \
            + int(index_offset)
        vals, idx = merge_topk(vals, idx, s, blk_idx.expand(b, -1), k)
    idx = torch.where(torch.isneginf(vals), -1, idx)
    return vals, idx


def sampled_threshold(x, aux, valid, q, *, k: int, metric: str, precision,
                      sub_rows: int = 128, max_fraction: int = 8,
                      method: str = "topk"):
    """A SOUND per-query floor for the k-th best score from a prefix sample:
    the k-th largest per-``sub_rows`` sub-block maximum, minus the margin of
    ``threshold_from_submax``. Returns (B, 1) f32; -inf disables the floor."""
    n, b = x.shape[0], q.shape[0]
    n_sample = min(n, max(sub_rows * k * 2, n // max_fraction))
    n_sample = (n_sample // sub_rows) * sub_rows
    if n_sample // sub_rows < k:
        return torch.full((b, 1), NEG_INF, dtype=torch.float32,
                          device=x.device)
    s = block_scores(q, x[:n_sample], aux[:n_sample], valid[:n_sample],
                     metric=metric, precision=precision)
    sub = s.reshape(b, n_sample // sub_rows, sub_rows).amax(dim=2)
    return threshold_from_submax(sub, k, method=method)


def accumulation_margin(q, aux, valid, *, metric: str, dim: int,
                        safety: float = 20.0):
    """Per-query (B, 1) bound on float32 accumulation-order divergence for
    unnormalized metrics (Cauchy-Schwarz on |q| and the largest live row
    norm, which the aux lane stores as |x|^2 for dot and l2)."""
    m2 = torch.where(valid, aux, 0.0).max()
    mnorm = torch.sqrt(torch.clamp(m2, min=0.0))
    qn = torch.sqrt((q.float() ** 2).sum(dim=1, keepdim=True))
    per_dot = safety * dim * (2.0 ** -24) * qn * mnorm
    return per_dot * (2.0 if metric == "l2" else 1.0)


def kth_largest_count(sub, k: int):
    """EXACT per-row k-th largest of ``sub`` (B, nsub) f32 by counting.

    Floats map to order-isomorphic int32 keys (``b ^ ((b >> 31) &
    0x7fffffff)``; ``>>`` on int32 is arithmetic in torch), then the answer
    is lifted MSB-first: the k-th largest key is the largest v with
    count(keys >= v) >= k. One sign-bit count plus 31 probes, all int32.
    Returns (B, 1) f32."""
    bits = sub.float().contiguous().view(torch.int32)
    keys = bits ^ ((bits >> 31) & 0x7FFFFFFF)

    def count_ge(v):
        return (keys >= v).sum(dim=1, keepdim=True, dtype=torch.int32)

    b = sub.shape[0]
    zero = torch.zeros((b, 1), dtype=torch.int32, device=sub.device)
    ans = torch.where(count_ge(zero) >= k, zero, zero + _INT32_MIN)
    for i in range(31):
        cand = ans + (1 << (30 - i))
        ans = torch.where(count_ge(cand) >= k, cand, ans)
    kth = ans ^ ((ans >> 31) & 0x7FFFFFFF)
    return kth.view(torch.float32)


def bisect_floor(sub, k: int, iters: int = 14):
    """A SOUND floor below the k-th largest of ``sub`` (B, nsub) f32 by
    bisection, the in-kernel search of the JAX experiments (kexp17/kexp20):
    ``hi = max``, ``lo = min - 1``, then ``iters`` steps of ``mid = 0.5 *
    (lo + hi)``, keeping ``count(sub > lo) >= k``. Returns lo (B, 1) f32.
    Every op is one float32 rounding, in the order the CUDA kernel
    (``csrc/fused_theta.cu``) takes them, so the two agree bit for bit. A
    -inf sub-maximum (a dead 128-group) makes lo -inf for good, which
    closes the floor: sound, and reproduced as is."""
    sub = sub.float()
    hi = sub.amax(dim=1, keepdim=True)
    lo = sub.amin(dim=1, keepdim=True) - 1.0
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        ge = (sub > mid).sum(dim=1, keepdim=True, dtype=torch.int32) >= k
        lo, hi = torch.where(ge, mid, lo), torch.where(ge, hi, mid)
    return lo


def threshold_from_submax(sub, k: int, *, margin_abs: float = 1e-3,
                          extra=None, method: str = "topk"):
    """Turn (B, nsub) sub-block score maxima into a sound k-th-best floor:
    the k-th largest sub-max ("topk": by a sort; "count": by counting, the
    engine's default; "minmax": the min over k group maxima, a looser sound
    floor) minus ``|kth| * 1e-3 +
    margin_abs`` (and ``extra`` for unnormalized float metrics). -inf where
    nsub < k or the result is not finite."""
    b = sub.shape[0]
    if sub.shape[1] < k:
        return torch.full((b, 1), NEG_INF, dtype=torch.float32,
                          device=sub.device)
    if method == "count":
        kth = kth_largest_count(sub, k)
    elif method == "minmax":
        g = sub.shape[1] // k
        kth = sub[:, :g * k].float().reshape(b, k, g).amax(dim=2).amin(
            dim=1, keepdim=True)
    elif method == "topk":
        kth = torch.sort(sub.float(), dim=1, descending=True).values[
            :, k - 1:k]
    else:
        raise ValueError(
            f"threshold method {method!r}: expected count|minmax|topk")
    t0 = kth - (kth.abs() * 1e-3 + margin_abs)
    if extra is not None:
        t0 = t0 - extra
    return torch.where(torch.isfinite(t0), t0, NEG_INF).float()


def rescore(x, aux, valid, q, cand_idx, *, k: int, metric: str,
            packed: bool = False):
    """Exact float32 rescore of candidate rows (B, k') -> top-k.

    The scores are an elementwise multiply-and-sum in float32, never a TF32
    matmul. Ties keep the lower candidate position (stable sort)."""
    safe_idx = cand_idx.clamp(min=0).long()
    b, kp = safe_idx.shape
    rows = x[safe_idx.reshape(-1)].reshape(b, kp, x.shape[1])
    return rescore_rows(rows, aux[safe_idx], valid[safe_idx], q, cand_idx,
                        k=k, metric=metric, packed=packed)


def rescore_rows(rows, aux_c, ok, q, cand_idx, *, k: int, metric: str,
                 packed: bool = False, combine=None):
    """``rescore`` on the candidates' stored rows (B, k', D), their aux and
    their live bits (B, k'), as gathered from whichever shards hold them.
    ``combine`` (optional) maps the scores (B, k'), -inf where a candidate
    is dead or empty, before the top-k: a process-spanning engine takes
    the max over the ranks there, each having scored the rows it holds."""
    quant = rows.dtype == torch.int8
    rows = unpack_int4_rows(rows) if packed else rows.float()
    g = (rows * q.float()[:, None, :]).sum(dim=2)
    if quant:
        if metric == "l2":
            n2 = (rows ** 2).sum(dim=2) * (aux_c * aux_c)
            s = 2.0 * (g * aux_c) - n2
        else:
            s = g * aux_c
    elif metric == "cosine":
        s = g * aux_c
    elif metric == "l2":
        s = 2.0 * g - aux_c
    else:
        s = g
    s = torch.where((cand_idx >= 0) & ok, s, NEG_INF)
    if combine is not None:
        s = combine(s)
    top_v, pos = torch.sort(s, dim=1, descending=True, stable=True)
    top_v, pos = top_v[:, :k], pos[:, :k]
    top_i = torch.gather(cand_idx, 1, pos)
    top_i = torch.where(torch.isneginf(top_v), -1, top_i)
    return top_v, top_i


def row_norms2(rows, aux, packed: bool = False):
    """|x_hat|^2 of stored int8/int4 rows: ``sum(row^2) * (aux * aux)``,
    the port of ``vrod_tpu.engine._row_norms2``. sum(row^2) <= dim * 127^2
    < 2^24 is exact in float32, and the multiply order is ``rescore``'s, so
    the two agree bit for bit (int4 rows unpack first)."""
    rows = unpack_int4_rows(rows) if packed else rows.float()
    return (rows ** 2).sum(dim=1) * (aux * aux)


def finalize_scores(vals, q, *, metric: str):
    """Internal max-scores -> user-facing values (l2: |q|^2 - s, the squared
    distance; -inf ranks become +inf)."""
    if metric == "l2":
        qq = (q.float() ** 2).sum(dim=1, keepdim=True)
        return torch.where(torch.isneginf(vals), float("inf"), qq - vals)
    return vals


def prepare_rows(vecs, *, metric: str, dtype):
    """(stored_rows, aux) for new vectors on insert.

    int8: per-row symmetric quantization — cosine stores round(x/|x| / s)
    with s = max|x_i/|x||/127, dot and l2 round(x / s); aux = s. int4: the
    same at 4 bits (s = max|base|/7), packed by ``pack_int4``. float32 and
    bfloat16 store the rows cast; aux = 1/|x| (cosine) or |x|^2 (l2, dot)."""
    vecs32 = vecs.float()
    packed4 = isinstance(dtype, str) and dtype == "int4"
    if packed4 or _as_dtype(dtype) == torch.int8:
        norms = None
        if metric == "cosine":
            norms = torch.clamp(torch.linalg.norm(vecs32, dim=1, keepdim=True),
                                min=1e-30)
            base = vecs32 / norms
        else:
            base = vecs32
        qmax = 7.0 if packed4 else 127.0
        scale = base.abs().amax(dim=1) * _reciprocal(qmax)
        q8 = torch.clamp(torch.round(_div_scale(vecs32, norms, torch.clamp(
            scale[:, None], min=1e-30))), -qmax, qmax).to(torch.int8)
        if packed4:
            q8 = pack_int4(q8)
        return q8, scale.float()
    if metric == "cosine":
        norms = torch.linalg.norm(vecs32, dim=1)
        aux = torch.where(norms > 0, 1.0 / torch.clamp(norms, min=1e-30), 0.0)
    else:
        aux = (vecs32 * vecs32).sum(dim=1)
    return vecs32.to(_as_dtype(dtype)), aux.float()


def prepare_queries(q, *, metric: str, quantize: bool = False,
                    return_scale: bool = False):
    """Normalize queries for cosine; ``quantize=True`` rounds each query to
    int8 by its own symmetric scale (``return_scale=True`` also returns the
    (B, 1) f32 scale, which l2 needs)."""
    q0 = q = q.float()
    norms = None
    if metric == "cosine":
        norms = torch.clamp(torch.linalg.norm(q, dim=1, keepdim=True),
                            min=1e-30)
        q = q / norms
    if quantize:
        scale = torch.clamp(
            q.abs().amax(dim=1, keepdim=True) * _reciprocal(127.0), min=1e-30)
        q = torch.clamp(torch.round(_div_scale(q0, norms, scale)),
                        -127, 127).to(torch.int8)
        if return_scale:
            return q, scale
    return q
