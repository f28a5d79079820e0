#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's search paths once on one NVIDIA GPU.

    python3 chip_smoke.py [--rows 1000000] [--seed 0]

Phases (any failure exits non-zero; nothing is caught and ignored, and
nothing falls back to the CPU or to a plain version):
1. Setup: a CUDA device must exist; print the card's name and power limit
   (nvidia-smi) and build the kernels from ``vrod_tpu_torch/csrc``.
2. Kernels vs plain on the card, for every leg (int8 and packed int4 rows
   with an int8 query, bfloat16 and float32 rows with a float query; each
   with metric cosine, dot and l2): K1 (``fused_topk``) and K3
   (``sampled_submax``) against their plain PyTorch versions on the same
   CUDA tensors at 65,536 x 768, b256, with the floor on and off, dead
   rows, k 28, 112 and 1280, dims 96 and 30, tied rows (also spread over
   the row tiles of one persistent block, so that later copies meet a gate
   that a list cut raised to their score), all rows dead and fewer live
   rows than k. int8/int4 scores are exact integer dots
   followed by the same rounded float32 ops, so values and slots must be
   EXACTLY equal. bfloat16/float32 sums run in another order on the tensor
   cores: values must agree within ``cuda_topk.score_error_bound``
   (2^-22 * (sqrt(d) + 1) * |q| * max|x|, scaled by the metric) and slots
   outside near-ties (``cuda_topk.topk_disagreement``); the largest error
   seen, and its largest share of the bound, are printed. A control shows
   the bound would catch a scorer of lower precision: the plain version
   fed inputs truncated to TF32 (as cvt.rz would) or to bfloat16 must
   fail the same comparison. For every leg theta0, the engine's floor from
   K3, must be at or below K1's own k-th value, and K3's maximum must
   equal K1's top-1 on the sample bit for bit.
3. Database phases through the entry points: ``Database.new`` ->
   ``create_collection`` (dim 768) -> ``bulk_insert`` of seeded rows in
   65,536-row chunks (WAL first, fsync) -> 20 x ``search_similar`` at batch
   256, each checked against an exact float32 full scan of the stored rows
   on the card (tie-aware recall 1.0, unique ids; l2 ranks ascending by
   squared distance). Each phase sets the launch counters to 0 before it
   and reads them after it; its leg's K1 and K3 counters must rise with
   every search. Then K1 and K3 are compared with their plain versions,
   and timed, at the shapes the phase gave them.
   - main path: int8 cosine, top-16, ``--rows`` rows, then ``snapshot``,
     delete 1,000 ids, close, ``Database.load`` (snapshot restore + WAL
     replay) and the same queries again: deleted ids are gone and every
     other result is unchanged;
   - (i) int8 l2, top-16, ``--rows`` rows, with the same reopen (the norms
     lane is rebuilt from the restored rows);
   - (ii) int4 l2, top-16; (iii) bfloat16 cosine, top-100, with the same
     reopen (the bfloat16 snapshot path, which needs no ml_dtypes); (iv)
     float32 dot, top-100 (with the float control): ``--rows`` rows each;
   - every leg (12 collections), 3 searches each: int8/int4 at top-16 on
     262,144 rows, bfloat16/float32 at top-100 on 131,072 rows.

Per kernel and leg, at the shapes of its first (largest) phase, the script
also computes the kernel's bound (the larger of the bytes its inputs and
outputs must move at 3.35 TB/s and its tensor-core operations, 2 * B * N *
D, at the dense peak of its type) and times a library yardstick that the
port never calls: two PyTorch calls, since no one call computes either
kernel's function: the leg's GEMM ``q @ x.T`` (``torch._int_mm`` for int8,
the same on unpacked rows for int4, ``torch.matmul`` in bfloat16, and in
float32 with TF32 on), then ``torch.topk(k_scan)`` (K1) or the max over
the strided 128-row groups (K3).

The last two lines of standard output are one JSON object per line: the
kernels' account (one entry per kernel and leg), then ``{"ok": true,
"device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

DIM, BATCH, SEARCHES = 768, 256, 20
INGEST_CHUNK = 65536
N_DELETE = 1000
RECALL_EPS = 1e-5  # tie tolerance of the recall check (bench.py's)
# The every-leg phase: int8/int4 legs at the headline's top-16 (262,144
# rows: the least at which that floor opens), float legs at top-100
# (131,072 rows; their floor opens from k_scan 64).
LEG_SHAPES = {"quant": (262144, 16), "float": (131072, 100)}
LEG_SEARCHES = 3
DB_DTYPE = {"int8": "int8", "int4": "int4", "bf16": "bfloat16",
            "f32": "float32"}
# The H100 SXM's datasheet rates (dense): HBM bytes/s, and tensor-core
# operations/s by the type the kernels multiply in.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"int8": 1979e12, "int4": 1979e12, "bf16": 989e12,
            "f32": 495e12}
SOURCES = {"fused_topk": ("vrod_tpu_torch/csrc/fused_topk.cu",
                          "vrod_tpu/ops/pallas_topk.py:251"),
           "sampled_submax": ("vrod_tpu_torch/csrc/sampled_submax.cu",
                              "vrod_tpu/ops/pallas_topk.py:468")}


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_time_ms(fn, iters=20, warmup=3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def row_dtype(dtype):
    import torch
    return {"int8": torch.int8, "int4": "int4", "bf16": torch.bfloat16,
            "f32": torch.float32}[dtype]


def kernel_inputs(x, q, leg, dev, dead_every=0):
    """(x, aux, valid, kernel-ready q) on ``dev`` and the wrappers' extra
    keywords, for float32 rows x and queries q of one leg."""
    import torch
    from vrod_tpu_torch.ops import distances as D
    dtype, metric = leg.split("-")
    rows, aux = D.prepare_rows(x.to(dev), metric=metric,
                               dtype=row_dtype(dtype))
    valid = torch.ones(x.shape[0], dtype=torch.bool, device=dev)
    if dead_every:
        valid[::dead_every] = False
    kw = dict(packed=dtype == "int4")
    quant = dtype in ("int8", "int4")
    if quant and metric == "l2":
        qk, qs = D.prepare_queries(q.to(dev), metric=metric, quantize=True,
                                   return_scale=True)
        kw.update(row_bias=-D.row_norms2(rows, aux, kw["packed"]),
                  q_scale=qs)
    else:
        qk = D.prepare_queries(q.to(dev), metric=metric, quantize=quant)
    return [rows, aux, valid, qk], kw


def sample_of(args, kw, ns):
    skw = dict(kw)
    if "row_bias" in kw:
        skw["row_bias"] = kw["row_bias"][:ns]
    return [a[:ns] for a in args[:3]] + [args[3]], skw


def floor_theta(sub, k, args, leg):
    """The engine's floor (``engine.floor_threshold``) from K3's
    sub-maxima, for kernel inputs ``args`` of one leg."""
    from vrod_tpu_torch.engine import floor_threshold
    dtype, metric = leg.split("-")
    return floor_threshold(sub, k, args[3], args[1], args[2],
                           metric=metric, quant=dtype in ("int8", "int4"),
                           dim=args[0].shape[1])


def bound_of(tensors, out_bytes, ops, dtype):
    """(bound_ms, bound_by) of a call: each input read once and each output
    written once at the HBM rate, against its operations at the dense
    tensor-core peak of ``dtype``."""
    import torch
    nbytes = out_bytes + sum(t.numel() * t.element_size() for t in tensors
                             if torch.is_tensor(t))
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / PEAK_OPS[dtype] * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops \
        else "operations"


def library_gemm(leg, x, q):
    """The yardstick's GEMM of one leg: a function returning q @ x.T as the
    library computes it (rows unpacked for int4 before timing; TF32 on for
    float32 while it runs)."""
    import torch
    from vrod_tpu_torch.ops import distances as D
    dtype = leg.split("-")[0]
    if dtype in ("int8", "int4"):
        rows = D.unpack_int4_rows(x, torch.int8) if dtype == "int4" else x
        return lambda: torch._int_mm(q, rows.t())
    rows, qq = x, q.to(x.dtype)

    def gemm():
        torch.backends.cuda.matmul.allow_tf32 = dtype == "f32"
        try:
            return torch.matmul(qq, rows.t())
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
    return gemm


def library_times(leg, a1, k_scan, a3, blk):
    """ms of the two-call yardsticks at a phase's shapes: K1's GEMM + topk,
    K3's GEMM + strided group max (the port never calls either)."""
    gemm1 = library_gemm(leg, a1[0], a1[3])
    gemm3 = library_gemm(leg, a3[0], a3[3])
    nb = a3[0].shape[0] // blk

    def k3():
        s = gemm3()
        return s.reshape(s.shape[0], nb, blk // 128, 128).amax(dim=2)
    return {"fused_topk_library": cuda_time_ms(
                lambda: gemm1().topk(k_scan, dim=1), iters=5),
            "sampled_submax_library": cuda_time_ms(k3, iters=5)}


class Compare:
    """Kernel-vs-plain comparisons on the card, per kernel and leg."""

    def __init__(self):
        from vrod_tpu_torch.ops import cuda_topk as K
        self.max_err = {name: 0.0 for name in K.launches}
        # Largest |kernel - plain| / bound (float legs), and per float leg
        # the smallest such share that a truncating control reached.
        self.max_share = {name: 0.0 for name in K.launches}
        self.control_share = {}

    @staticmethod
    def _same_form(got, want, what):
        for g, w in zip(got, want):
            if g.shape != w.shape or g.dtype != w.dtype:
                raise AssertionError(f"{what}: kernel gave {tuple(g.shape)} "
                                     f"{g.dtype}, plain {tuple(w.shape)} "
                                     f"{w.dtype}")

    @staticmethod
    def _share(got, want, bound):
        """Largest |got - want| / bound over finite wanted values."""
        import torch
        fin = torch.isfinite(want)
        if not fin.any() or not bool((bound > 0).all()):
            return 0.0
        err = (got - want).abs() / bound.reshape(-1, 1)
        return float(err[fin].max())

    def _err(self, name, got, want, bound):
        import torch
        fin = torch.isfinite(want)
        if fin.any():
            err = float((got[fin] - want[fin]).abs().max())
            self.max_err[name] = max(self.max_err[name], err)
        self.max_share[name] = max(self.max_share[name],
                                   self._share(got, want, bound))

    def submax(self, leg, args, kw, blk, what):
        import torch
        from vrod_tpu_torch.ops import cuda_topk as K
        metric = leg.split("-")[1]
        got = K.sampled_submax(*args, metric=metric, block_rows=blk, **kw)
        want = K.sampled_submax_plain(*args, metric=metric, block_rows=blk,
                                      **kw)
        bound = K.score_error_bound(*args, metric=metric)
        torch.cuda.synchronize()
        self._same_form((got,), (want,), f"{what}: K3")
        if not torch.equal(torch.isneginf(got), torch.isneginf(want)):
            raise AssertionError(f"{what}: K3 -inf lanes differ from plain")
        fin = torch.isfinite(want)
        if ((got - want).abs().where(fin, 0.0) > bound).any():
            raise AssertionError(f"{what}: K3 differs from plain beyond "
                                 "the bound")
        self._err(f"sampled_submax[{leg}]", got, want, bound)
        # K3 scores with K1's code: its maximum is K1's top-1, bit for bit.
        top1, _ = K.fused_topk(*args, k=1, metric=metric, **kw)
        if not torch.equal(top1[:, 0], got.amax(dim=1)):
            raise AssertionError(f"{what}: K3's max is not K1's top-1")
        return got

    def topk(self, leg, args, kw, k, what, offset=0, theta0=None,
             bound=None):
        import torch
        from vrod_tpu_torch.ops import cuda_topk as K
        metric = leg.split("-")[1]
        kk = dict(k=k, metric=metric, index_offset=offset, theta0=theta0,
                  **kw)
        got = K.fused_topk(*args, **kk)
        want = K.fused_topk_plain(*args, **kk)
        if bound is None:
            bound = K.score_error_bound(*args, metric=metric)
        torch.cuda.synchronize()
        self._same_form(got, want, f"{what}: K1")
        msg = K.topk_disagreement(*got, *want, bound)
        if msg:
            raise AssertionError(f"{what}: K1 vs plain: {msg}")
        self._err(f"fused_topk[{leg}]", got[0], want[0], bound)
        return got

    def control(self, leg, args, kw, k, what):
        """A float leg's bound must reject a scorer of lower precision: the
        plain version fed inputs rounded toward zero (float32 rows and
        query truncated to TF32, as cvt.rz would, and to bfloat16; the
        bfloat16 leg's query truncated to bfloat16) must fail the K1
        comparison that the kernel passes."""
        from vrod_tpu_torch.ops import cuda_topk as K
        dtype, metric = leg.split("-")
        if dtype in ("int8", "int4"):
            return
        bound = K.score_error_bound(*args, metric=metric)
        want = K.fused_topk_plain(*args, k=k, metric=metric, **kw)
        for name, drop in ((("tf32-rz", 13), ("bf16-rz", 16))
                           if dtype == "f32" else (("bf16-rz", 16),)):
            cut = list(args)
            if dtype == "f32":
                cut[0] = truncated(args[0], drop)
            cut[3] = truncated(args[3], drop)
            got = K.fused_topk_plain(*cut, k=k, metric=metric, **kw)
            if K.topk_disagreement(*got, *want, bound) is None:
                raise AssertionError(f"{what}: the float bound passes a "
                                     f"{name} control scorer")
            share = self._share(got[0], want[0], bound)
            self.control_share[leg] = min(
                self.control_share.get(leg, share), share)

    def floor_sound(self, leg, args, kw, k, theta0, what):
        """theta0 at or below K1's own k-th value for every query."""
        from vrod_tpu_torch.ops import cuda_topk as K
        v, _ = K.fused_topk(*args, k=k, metric=leg.split("-")[1], **kw)
        if not bool((theta0[:, 0] <= v[:, k - 1]).all()):
            raise AssertionError(f"{what}: theta0 above K1's k-th value")


def truncated(t, drop):
    """float32 ``t`` with its low ``drop`` mantissa bits cleared: rounded
    toward zero (13 bits: TF32 as cvt.rz.tf32 rounds; 16: bfloat16)."""
    import torch
    bits = t.float().contiguous().view(torch.int32)
    return (bits & -(1 << drop)).view(torch.float32)


def tie_inputs(leg, dev, rng, n, copies):
    """Rows with copies of row 7 at the slots ``copies`` and of row 9000 at
    5000..5039, query 0 = row 7: exact ties inside query 0's top-k and
    inside other queries' lists. For the float legs every value is small
    and exact (rows of -1/0/1, row 7 four 2s, queries four +-2s), so every
    score is exact in any summation order and the kernel must equal the
    plain version bit for bit."""
    import torch
    if leg.split("-")[0] in ("int8", "int4"):
        x = torch.from_numpy(rng.standard_normal((n, DIM), dtype=np.float32))
        q = torch.from_numpy(rng.standard_normal((BATCH, DIM),
                                                 dtype=np.float32))
    else:
        x = torch.from_numpy(rng.integers(-1, 2, (n, DIM))
                             .astype(np.float32))
        x[7] = 0.0
        x[7, :4] = 2.0
        q = torch.zeros((BATCH, DIM))
        for row in q:
            row[torch.from_numpy(rng.choice(DIM, 4, replace=False))] = \
                torch.from_numpy(rng.choice([-2.0, 2.0], 4)).float()
    x[torch.tensor(copies)] = x[7].clone()
    x[5000:5040] = x[9000]
    q[0] = x[7]
    return kernel_inputs(x, q, leg, dev)


def kernel_cases(cmp, rng, dev, leg):
    """Cases (a)-(f) for one leg; returns the times at shape (a)."""
    import torch
    from vrod_tpu_torch.ops import cuda_topk as K
    metric = leg.split("-")[1]
    n = 65536
    x = torch.from_numpy(rng.standard_normal((n, DIM), dtype=np.float32))
    q = torch.from_numpy(rng.standard_normal((BATCH, DIM), dtype=np.float32))
    args, kw = kernel_inputs(x, q, leg, dev, dead_every=7)
    sample, skw = sample_of(args, kw, 32768)
    sub = cmp.submax(leg, sample, skw, 16384, f"{leg} (a) K3 32768 rows")
    theta0 = floor_theta(sub, 28, args, leg)
    cmp.topk(leg, args, kw, 28, f"{leg} (a) k 28, floor, offset", 12345,
             theta0)
    cmp.topk(leg, args, kw, 28, f"{leg} (b) k 28, no floor")
    cmp.control(leg, args, kw, 28, f"{leg} (a) control")
    cmp.floor_sound(leg, args, kw, 28, theta0, f"{leg} (a)")
    sub_c = cmp.submax(leg, sample, skw, 1024, f"{leg} (c) K3 blk 1024")
    theta_c = floor_theta(sub_c, 112, args, leg)
    cmp.topk(leg, args, kw, 112, f"{leg} (c) k 112, floor", 0, theta_c)
    cmp.floor_sound(leg, args, kw, 112, theta_c, f"{leg} (c)")
    cmp.topk(leg, args, kw, 1280, f"{leg} (c) k 1280")
    for d in (96, 30):
        xd = torch.from_numpy(rng.standard_normal((8192, d),
                                                  dtype=np.float32))
        qd = torch.from_numpy(rng.standard_normal((BATCH, d),
                                                  dtype=np.float32))
        ad, kd = kernel_inputs(xd, qd, leg, dev, dead_every=5)
        cmp.submax(leg, ad, kd, 4096, f"{leg} (d) K3 dim {d}")
        cmp.topk(leg, ad, kd, 28, f"{leg} (d) dim {d}", 77)
    exact = torch.zeros((BATCH, 1), device=dev)
    copies = list(range(1000, 1100))
    at, kt = tie_inputs(leg, dev, rng, 16384, copies)
    v, i = cmp.topk(leg, at, kt, 112, f"{leg} (e) ties", bound=exact)
    if i[0, :101].tolist() != [7] + copies:
        raise AssertionError(f"{leg} (e) ties: copies of row 7 not lowest "
                             "slot first")
    # Ties across K1's list cuts: 40 copies of row 7 in each of the first
    # seven row tiles of part 0 (tiles 0, parts, 2 parts, ...). The first
    # four tiles fill query 0's list past k, so the first cut raises its
    # gate to the copies' score, and the copies in the later tiles meet a
    # gate equal to their score (and lose the tie by slot).
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    _, parts, _ = K.topk_plan(8 * K.TILE_ROWS * sms, BATCH, 112, sms)
    copies = [t * parts * K.TILE_ROWS + r for t in range(7)
              for r in range(8, 48)]
    at, kt = tie_inputs(leg, dev, rng, 8 * parts * K.TILE_ROWS, copies)
    v, i = cmp.topk(leg, at, kt, 112, f"{leg} (e) ties across list cuts",
                    bound=exact)
    if i[0, :112].tolist() != [7] + copies[:111]:
        raise AssertionError(f"{leg} (e) ties across list cuts: copies of "
                             "row 7 not lowest slot first")
    dead = torch.zeros_like(args[2])
    v, i = cmp.topk(leg, args[:2] + [dead, args[3]], kw, 28,
                    f"{leg} (f) all dead")
    if not bool((i == -1).all()) or not bool(torch.isneginf(v).all()):
        raise AssertionError(f"{leg} (f) all dead: results not (-inf, -1)")
    few = torch.zeros_like(args[2])
    few[[3, 700, 4000, 50000, 65535]] = True
    v, i = cmp.topk(leg, args[:2] + [few, args[3]], kw, 28,
                    f"{leg} (f) k > live")
    if not bool(((i >= 0).sum(dim=1) == 5).all()):
        raise AssertionError(f"{leg} (f) k > live: wrong number of results")
    k1 = dict(k=28, metric=metric, theta0=theta0, **kw)
    k3 = dict(metric=metric, block_rows=16384, **skw)
    return {
        "fused_topk": cuda_time_ms(lambda: K.fused_topk(*args, **k1)),
        "fused_topk_plain": cuda_time_ms(
            lambda: K.fused_topk_plain(*args, **k1), iters=5),
        "sampled_submax": cuda_time_ms(
            lambda: K.sampled_submax(*sample, **k3)),
        "sampled_submax_plain": cuda_time_ms(
            lambda: K.sampled_submax_plain(*sample, **k3), iters=5),
    }


def oracle_kth(eng, q, top_k):
    """Exact float32 full scan of the stored rows on the card: the k-th
    best user-facing score per query (the plain blockwise scan with the
    float32 query; l2: the k-th smallest squared distance)."""
    import torch
    from vrod_tpu_torch.ops import distances as D
    metric = eng.cfg.metric
    q = torch.from_numpy(q).to(eng.device)
    qp = D.prepare_queries(q, metric=metric)
    blk = 65536 if eng.capacity % 65536 == 0 else eng.capacity
    vals, _ = D.blockwise_topk(eng.x, eng.aux, eng.valid, qp, k=top_k,
                               metric=metric, precision="exact",
                               block_rows=blk, nblocks=eng.capacity // blk,
                               packed=eng.packed)
    vals = D.finalize_scores(vals, q, metric=metric)
    return vals[:, top_k - 1].cpu().numpy()


def check_hits(hits, kth, metric, top_k, what):
    for b, hs in enumerate(hits):
        ids = [h.record_id for h in hs]
        if len(ids) != top_k or len(set(ids)) != top_k:
            raise AssertionError(f"{what}: query {b} got ids {ids}")
        scores = np.array([h.score for h in hs], np.float64)
        tol = RECALL_EPS * max(abs(kth[b]), 1.0)
        if metric == "l2":
            ok = (scores <= kth[b] + tol).all() and \
                (np.diff(scores) >= 0).all()
        else:
            ok = (scores >= kth[b] - tol).all()
        if not ok:
            raise AssertionError(
                f"{what}: query {b} recall < 1 (scores {scores}, exact "
                f"k-th {kth[b]})")


def search_round(col, queries, leg, top_k, what, lat=None):
    """Search every query batch: the leg's K1 and K3 launch counters must
    rise with each; recall 1.0 against the exact scan."""
    from vrod_tpu_torch.ops import cuda_topk as K
    names = [f"fused_topk[{leg}]", f"sampled_submax[{leg}]"]
    results = []
    for b, q in enumerate(queries):
        n0 = [K.launches[n] for n in names]
        t0 = time.perf_counter()
        hits = col.search_similar(q, top_k)
        if lat is not None:
            lat.append(time.perf_counter() - t0)
        for name, before in zip(names, n0):
            if K.launches[name] <= before:
                raise AssertionError(f"{what} {b}: launched no {name}")
        check_hits(hits, oracle_kth(col.engine, q, top_k),
                   col.config.metric, top_k, f"{what} {b}")
        results.append([[(h.record_id, h.score) for h in hs]
                        for hs in hits])
    return results


def db_phase(dev, card, cmp, *, name, leg, top_k, rows, searches, reopen,
             seed):
    """One Database phase through the entry points (module docstring,
    phase 3). Returns (launch counts of the phase, kernel times at its
    shapes)."""
    import torch
    from vrod_tpu_torch import Database
    from vrod_tpu_torch.engine import floor_gate
    from vrod_tpu_torch.ops import cuda_topk as K
    dtype, metric = leg.split("-")
    rng = np.random.default_rng(seed)
    queries = [rng.standard_normal((BATCH, DIM), dtype=np.float32)
               for _ in range(searches)]
    tmp = Path(tempfile.mkdtemp(prefix="vrod_smoke_"))
    try:
        torch.cuda.reset_peak_memory_stats(dev)
        K.reset_launches()
        db = Database.new(tmp, "smoke", device=dev)
        col = db.create_collection("docs", dim=DIM, metric=metric,
                                   dtype=DB_DTYPE[dtype])
        ingest_s, ids = 0.0, []
        for start in range(0, rows, INGEST_CHUNK):
            chunk = rng.standard_normal(
                (min(INGEST_CHUNK, rows - start), DIM), dtype=np.float32)
            t0 = time.perf_counter()
            ids.append(col.bulk_insert(chunk))
            torch.cuda.synchronize(dev)
            ingest_s += time.perf_counter() - t0
        ids = np.concatenate(ids)
        col.search_similar(queries[0], top_k)  # warm-up, not timed
        lat = []
        before = search_round(col, queries, leg, top_k, f"{name} search",
                              lat)
        lat_ms = np.array(lat) * 1e3
        log(f"{name}: {leg}, {rows} rows, top-{top_k}: ingest "
            f"{rows / ingest_s:.1f} rows/s; search_similar b{BATCH} p50 "
            f"{np.percentile(lat_ms, 50):.3f} ms, max {lat_ms.max():.3f} ms "
            f"over {searches} batches after one warm-up, recall 1.0 "
            f"[{card}]")
        if reopen:
            col.snapshot()
            top1 = [bq[j][0][0] for bq in before
                    for j in range(0, BATCH, 4)]
            extra = rng.choice(ids, N_DELETE, replace=False).tolist()
            gone = list(dict.fromkeys(top1[:N_DELETE // 2] + extra))[
                :N_DELETE]
            if col.delete_many(gone) != len(gone):
                raise AssertionError("delete_many deleted fewer ids")
            db.close()
            db = Database.load(tmp / "smoke", device=dev)
            col = db.collection("docs")
            if col.count != rows - len(gone):
                raise AssertionError(f"count after reopen {col.count}")
            after = search_round(col, queries, leg, top_k,
                                 f"{name} reopened")
            gone_set = set(gone)
            for b, (bq, aq) in enumerate(zip(before, after)):
                for j, (was, got) in enumerate(zip(bq, aq)):
                    if any(r in gone_set for r, _ in got):
                        raise AssertionError("a deleted id came back")
                    kept = [p for p in was if p[0] not in gone_set]
                    if got[:len(kept)] != kept:
                        raise AssertionError(
                            f"{name} reopened {b}/{j}: {got} vs kept {kept}")
            log(f"{name}: snapshot, delete {len(gone)}, reopen: deleted ids "
                "gone, every other result unchanged")
        torch.cuda.synchronize(dev)
        launches = dict(K.launches)
        ran = {n: c for n, c in launches.items() if c}
        log(f"{name}: kernel launches {json.dumps(ran)}, "
            f"peak device memory {torch.cuda.max_memory_allocated(dev)} "
            f"bytes [{card}]")

        # The kernels at the shapes this phase gave them (not counted).
        eng = col.engine
        k_scan = eng.scan_widths(top_k)[1]
        q = torch.from_numpy(queries[0]).to(dev)
        from vrod_tpu_torch.ops import distances as D
        q_scan, extras = eng.scan_inputs(q, D.prepare_queries(
            q, metric=metric))
        ok, ns, blk = floor_gate(eng.capacity, k_scan, eng.storage_dim,
                                 eng.x.element_size(), eng.quant)
        if not ok:
            raise AssertionError(f"{name}: floor gate closed")
        a1 = [eng.x, eng.aux, eng.valid, q_scan]
        a3, kw3 = sample_of(a1, extras, ns)
        sub = cmp.submax(leg, a3, kw3, blk, f"{name} K3 {ns} rows")
        theta0 = floor_theta(sub, k_scan, a1, leg)
        cmp.topk(leg, a1, extras, k_scan, f"{name} K1 {eng.capacity} rows",
                 theta0=theta0)
        cmp.floor_sound(leg, a1, extras, k_scan, theta0, name)
        cmp.control(leg, a1, extras, k_scan, f"{name} control")
        eng_lat = []
        for qb in queries:
            t0 = time.perf_counter()
            eng.search(qb, top_k)
            eng_lat.append(time.perf_counter() - t0)
        kw1 = dict(k=k_scan, metric=metric, theta0=theta0, **extras)
        kw3 = dict(metric=metric, block_rows=blk, **kw3)
        times = {
            "fused_topk_plain": cuda_time_ms(
                lambda: K.fused_topk_plain(*a1, **kw1), iters=5),
            "fused_topk": cuda_time_ms(lambda: K.fused_topk(*a1, **kw1)),
            "sampled_submax": cuda_time_ms(
                lambda: K.sampled_submax(*a3, **kw3)),
            "sampled_submax_plain": cuda_time_ms(
                lambda: K.sampled_submax_plain(*a3, **kw3), iters=5),
        }
        dim = eng.cfg.dim
        extra_t = [v for v in extras.values() if hasattr(v, "numel")]
        times["fused_topk_bound"] = bound_of(
            a1 + [theta0] + extra_t, BATCH * k_scan * 8,
            2 * BATCH * eng.capacity * dim, dtype)
        times["sampled_submax_bound"] = bound_of(
            a3 + [v for v in kw3.values() if hasattr(v, "numel")],
            BATCH * 128 * (ns // blk) * 4, 2 * BATCH * ns * dim, dtype)
        times.update(library_times(leg, a1, k_scan, a3, blk))
        log(f"{name}: engine.search p50 "
            f"{np.percentile(np.array(eng_lat) * 1e3, 50):.3f} ms; kernels "
            f"at its shapes ({eng.capacity} rows, sample {ns} in blocks of "
            f"{blk}, b{BATCH}, k_scan {k_scan}), ms: {json.dumps(times)} "
            f"[{card}]")
        db.close()
        return launches, times
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--rows", type=int, default=1_000_000,
                   help="rows of the main path and phases (i)-(iv) "
                   "(default 1M)")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    if args.rows < 262144:
        p.error("below 262,144 rows the sampled floor's gate closes, so K3 "
                "would not run on the path")

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from vrod_tpu_torch.ops import _build
    from vrod_tpu_torch.ops import cuda_topk as K

    wall0 = time.perf_counter()
    # Exact float32 oracle products: no TF32 anywhere outside the kernels.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    lib = _build.build()
    _build.load()
    log(f"kernels built in {time.perf_counter() - t0:.3f} s: {lib.name}")
    for line in lib.with_suffix(".log").read_text().splitlines():
        if any(w in line for w in ("registers", "spill", "Compiling",
                                   "arning", "wgmma")):
            log("  ptxas:", line.strip())

    cmp = Compare()
    rng = np.random.default_rng(args.seed + 1)
    for leg in K.LEGS:
        times = kernel_cases(cmp, rng, dev, leg)
        log(f"kernel cases (a)-(f) {leg}: K1 max err "
            f"{cmp.max_err[f'fused_topk[{leg}]']:.6g}, K3 max err "
            f"{cmp.max_err[f'sampled_submax[{leg}]']:.6g}; shape (a) 65536 x "
            f"{DIM}, b{BATCH}, k 28, ms: {json.dumps(times)} [{card}]")

    phases = [
        ("main path", "int8-cosine", 16, args.rows, True),
        ("(i)", "int8-l2", 16, args.rows, True),
        ("(ii)", "int4-l2", 16, args.rows, False),
        ("(iii)", "bf16-cosine", 100, args.rows, True),
        ("(iv)", "f32-dot", 100, args.rows, False),
    ]
    for leg in K.LEGS:
        rows, top_k = LEG_SHAPES[
            "quant" if leg.startswith(("int8", "int4")) else "float"]
        phases.append((f"leg {leg}", leg, top_k, rows, False))
    launches = dict.fromkeys(K.launches, 0)
    times = {}
    for i, (name, leg, top_k, rows, reopen) in enumerate(phases):
        n, t = db_phase(dev, card, cmp, name=name, leg=leg,
                        top_k=top_k, rows=rows,
                        searches=LEG_SEARCHES if name.startswith("leg")
                        else SEARCHES, reopen=reopen, seed=args.seed + 10 + i)
        for kname, c in n.items():
            launches[kname] += c
        times.setdefault(leg, (name, rows, t))  # the first, largest phase
    kernels = []
    for kern in ("fused_topk", "sampled_submax"):
        for leg in K.LEGS:
            kname = f"{kern}[{leg}]"
            if launches[kname] == 0:
                raise AssertionError(f"{kname} launched no time on the "
                                     "search paths")
            phase, rows, t = times[leg]
            bound_ms, bound_by = t[kern + "_bound"]
            log(f"{kname}: {launches[kname]} launches; at {phase}'s shapes "
                f"({rows} rows) {t[kern]:.4f} ms vs plain "
                f"{t[kern + '_plain']:.4f} ms, bound {bound_ms:.4f} ms "
                f"({bound_by}; {bound_ms / t[kern]:.1%} of it reached), "
                f"library (two calls) {t[kern + '_library']:.4f} ms; max "
                f"abs err vs plain {cmp.max_err[kname]:.6g}, at most "
                f"{cmp.max_share[kname]:.4g} of the score bound [{card}]")
            kernels.append({
                "name": kname, "route": "cuda", "source": SOURCES[kern][0],
                "replaces": SOURCES[kern][1], "launches": launches[kname],
                "max_abs_err": cmp.max_err[kname], "ms": t[kern],
                "plain_ms": t[kern + "_plain"], "bound_ms": bound_ms,
                "bound_by": bound_by,
                "library_ms": t[kern + "_library"]})
    for leg, share in cmp.control_share.items():
        log(f"float control {leg}: truncated inputs reached at least "
            f"{share:.4g} x the bound (the kernels: K1 "
            f"{cmp.max_share[f'fused_topk[{leg}]']:.4g}, K3 "
            f"{cmp.max_share[f'sampled_submax[{leg}]']:.4g})")
    log(f"wall time {time.perf_counter() - wall0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
