"""The port's search kernels: the counterpart of ``vrod_tpu.ops.pallas_topk``.

Two kernels carry SEARCHSIMILAR on an int8 collection with metric cosine or
dot. Each has a wrapper that validates its inputs and dispatches on the
device of the tensors it is given: a CPU tensor goes to the plain PyTorch
version beside it, a CUDA tensor launches the hand-written CUDA kernel (or
raises). No wrapper falls back from the kernel to the plain version.

- ``fused_topk`` (K1, ``csrc/fused_topk.cu``) replaces the Pallas kernel
  ``pallas_topk.fused_topk`` -> ``_fused_call_db``/``_kernel_db`` (and the
  auto-pipelined ``_fused_call``/``_kernel``, which the CUDA kernel covers:
  it takes any dim). Bound on the H100 by bytes: one search streams every
  stored row, 805 MB of int8 at 1M x 768, with the integer operations
  (on the tensor cores) close behind. The design keeps the (B, N) score
  matrix out of device memory and writes only candidates that beat the
  running k-th score or the sampled floor; see the source for the
  parallel-chunk select and merge that replace the TPU's sequential carry.
- ``sampled_submax`` (K3, ``csrc/sampled_submax.cu``) replaces
  ``pallas_topk.sampled_submax`` -> ``_submax_kernel``. It scores a prefix
  sample with K1's scoring code (bit-identical scores, which the floor's
  soundness needs) and emits 128 strided group maxima per row block. The
  sample is small (25 MB at the headline), so parallelism bounds it: the
  kernel splits each row block into segments so the grid fills the card.

Scores, in both: ``float(g) * aux + mask`` with g the exact int32 dot of the
int8 query and row, mask 0 on live slots and -inf on dead ones, and each
of the two float ops rounded once. The other legs of the TPU kernels (int8
l2, bfloat16/float32, packed int4) are not ported yet (ROADMAP Queue 2).

``launches`` counts kernel launches per wrapper; only a CUDA launch adds
to it.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from . import distances as D

NEG_INF = float("-inf")
METRICS = ("cosine", "dot")
# Rows per block of the plain versions: bounds their (B, rows) score
# matrix at 256 MB.
_PLAIN_SCORE_ELEMS = 1 << 26

launches = {"fused_topk": 0, "sampled_submax": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _check(x, aux, valid, q, metric) -> tuple[int, int, int]:
    if metric not in METRICS:
        raise ValueError(
            f"metric {metric!r}: the int8 kernels take {METRICS} "
            "(int8 l2 is ROADMAP Queue 2)")
    if x.dtype != torch.int8 or x.dim() != 2:
        raise TypeError(f"x must be (N, D) int8, got {tuple(x.shape)} "
                        f"{x.dtype}")
    if q.dtype != torch.int8 or q.dim() != 2:
        # A float query truncated to int8 would score garbage with valid
        # shapes: callers quantize it (distances.prepare_queries) first.
        raise TypeError(f"int8 rows require an int8-quantized (B, D) query, "
                        f"got {tuple(q.shape)} {q.dtype}")
    n, d = x.shape
    b = q.shape[0]
    if q.shape[1] != d:
        raise ValueError(f"query dim {q.shape[1]} != row dim {d}")
    if aux.shape != (n,) or aux.dtype != torch.float32:
        raise ValueError(f"aux must be ({n},) float32")
    if valid.shape != (n,) or valid.dtype != torch.bool:
        raise ValueError(f"valid must be ({n},) bool")
    devs = {t.device for t in (x, aux, valid, q)}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {devs}")
    if not all(t.is_contiguous() for t in (x, aux, valid, q)):
        raise ValueError("inputs must be contiguous")
    return n, d, b


def _theta(theta0, b, device):
    if theta0 is None:
        return torch.full((b,), NEG_INF, dtype=torch.float32, device=device)
    t0 = torch.as_tensor(theta0, dtype=torch.float32, device=device)
    return t0.reshape(b).contiguous()


def _mask(valid):
    """The additive mask stream: 0 on live slots, -inf on dead ones."""
    return torch.zeros(valid.shape, dtype=torch.float32,
                       device=valid.device).masked_fill_(~valid, NEG_INF)


def _scores(x, aux, mask, q):
    # Integer products and partial sums stay below 2^24, so the float32
    # product is the exact integer dot in any summation order.
    g = D._matmul_f32(q, x)
    return g * aux[None, :] + mask[None, :]


def _device_kind(t) -> str:
    if t.device.type in ("cpu", "cuda"):
        return t.device.type
    raise ValueError(f"unsupported device {t.device}")


def _ok(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")


def _stream(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


# -- K1 ------------------------------------------------------------------


def fused_topk_plain(x, aux, valid, q, *, k, metric, index_offset=0,
                     theta0=None):
    """Plain PyTorch K1: the top-k of the slots whose score beats theta0,
    ordered by (value desc, slot asc), as (values (B, k) f32, slots (B, k)
    i32) with (-inf, -1) on empty ranks."""
    n, _, b = _check(x, aux, valid, q, metric)
    mask = _mask(valid)
    t0 = _theta(theta0, b, x.device)[:, None]
    dev = x.device
    vals = torch.full((b, k), NEG_INF, dtype=torch.float32, device=dev)
    idx = torch.full((b, k), -1, dtype=torch.int32, device=dev)
    step = max(1, _PLAIN_SCORE_ELEMS // max(b, 1))
    for lo in range(0, n, step):
        hi = min(n, lo + step)
        s = _scores(x[lo:hi], aux[lo:hi], mask[lo:hi], q)
        s = torch.where(s > t0, s, NEG_INF)
        blk = torch.arange(lo, hi, dtype=torch.int32, device=dev) \
            + int(index_offset)
        vals, idx = D.merge_topk(vals, idx, s, blk.expand(b, -1), k)
    return vals, torch.where(torch.isneginf(vals), -1, idx)


def fused_topk(x, aux, valid, q, *, k, metric, index_offset=0,
               theta0=None):
    """Exact top-k of int8 query q (B, D) against int8 rows x (N, D); the
    contract of ``pallas_topk.fused_topk`` for the int8 cosine/dot legs.

    ``theta0`` (B,) or (B, 1): a SOUND floor (<= the true k-th score);
    candidates at or below it are skipped, which keeps results exact.
    ``index_offset`` shifts the returned slots."""
    n, d, b = _check(x, aux, valid, q, metric)
    if k < 1:
        raise ValueError("k must be >= 1")
    if index_offset < 0 or index_offset + n >= 2 ** 31:
        raise ValueError(f"index_offset {index_offset} out of range")
    if _device_kind(x) == "cpu":
        return fused_topk_plain(x, aux, valid, q, k=k, metric=metric,
                                index_offset=index_offset, theta0=theta0)
    dev = x.device
    out_v = torch.full((b, k), NEG_INF, dtype=torch.float32, device=dev)
    out_i = torch.full((b, k), -1, dtype=torch.int32, device=dev)
    if n == 0:
        return out_v, out_i
    t0 = _theta(theta0, b, dev)
    mask = _mask(valid)
    lib = _build.load()
    with torch.cuda.device(dev):
        plan = (ctypes.c_int * 3)()
        _ok(lib.vrod_fused_topk_plan(n, b, k, plan), "fused_topk plan")
        nchunks, chunk_rows, cap = plan
        cand_v = torch.empty(nchunks * b * cap, dtype=torch.float32,
                             device=dev)
        cand_i = torch.empty(nchunks * b * cap, dtype=torch.int32,
                             device=dev)
        cand_n = torch.empty(nchunks * b, dtype=torch.int32, device=dev)
        merge_v = torch.empty(b * nchunks * k, dtype=torch.float32,
                              device=dev)
        merge_i = torch.empty(b * nchunks * k, dtype=torch.int32,
                              device=dev)
        rc = lib.vrod_fused_topk_i8(
            x.data_ptr(), aux.data_ptr(), mask.data_ptr(), q.data_ptr(),
            t0.data_ptr(), n, d, b, k, int(index_offset), nchunks,
            chunk_rows, cap, cand_v.data_ptr(), cand_i.data_ptr(),
            cand_n.data_ptr(), merge_v.data_ptr(), merge_i.data_ptr(),
            out_v.data_ptr(), out_i.data_ptr(), _stream(dev))
    _ok(rc, "fused_topk launch")
    launches["fused_topk"] += 1
    return out_v, out_i


# -- K3 ------------------------------------------------------------------


def _check_blocks(n, block_rows):
    if block_rows % 128 or n % block_rows or n == 0:
        raise ValueError(
            f"sampled_submax needs rows ({n}) a positive multiple of "
            f"block_rows ({block_rows}), itself a multiple of 128")


def sampled_submax_plain(x, aux, valid, q, *, metric, block_rows):
    """Plain PyTorch K3: (B, 128 * N / block_rows) f32, lane t of block j
    the max score over rows j*block_rows + t + 128*i."""
    n, _, b = _check(x, aux, valid, q, metric)
    _check_blocks(n, block_rows)
    s = _scores(x, aux, _mask(valid), q)
    nb = n // block_rows
    return s.reshape(b, nb, block_rows // 128, 128).amax(dim=2) \
        .reshape(b, nb * 128)


def sampled_submax(x, aux, valid, q, *, metric, block_rows):
    """Group-maxima score pre-pass behind the engine's sampled floor; the
    contract of ``pallas_topk.sampled_submax`` for the int8 cosine/dot
    legs."""
    n, d, b = _check(x, aux, valid, q, metric)
    _check_blocks(n, block_rows)
    if _device_kind(x) == "cpu":
        return sampled_submax_plain(x, aux, valid, q, metric=metric,
                                    block_rows=block_rows)
    dev = x.device
    width = 128 * (n // block_rows)
    out = torch.empty((b, width), dtype=torch.float32, device=dev)
    mask = _mask(valid)
    lib = _build.load()
    with torch.cuda.device(dev):
        spb = ctypes.c_int(0)
        _ok(lib.vrod_sampled_submax_plan(n, b, block_rows,
                                         ctypes.byref(spb)),
            "sampled_submax plan")
        part = torch.empty(spb.value * b * width if spb.value > 1 else 1,
                           dtype=torch.float32, device=dev)
        rc = lib.vrod_sampled_submax_i8(
            x.data_ptr(), aux.data_ptr(), mask.data_ptr(), q.data_ptr(),
            n, d, b, block_rows, spb.value, part.data_ptr(), out.data_ptr(),
            _stream(dev))
    _ok(rc, "sampled_submax launch")
    launches["sampled_submax"] += 1
    return out
