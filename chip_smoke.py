#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's search paths once on one NVIDIA GPU.

    python3 chip_smoke.py [--rows 1000000] [--seed 0]

Phases (any failure exits non-zero; nothing is caught and ignored, and
nothing falls back to the CPU or to a plain version):
1. Setup: a CUDA device must exist; print the card's name and power limit
   (nvidia-smi) and build the kernels from ``vrod_tpu_torch/csrc``.
2. Kernels vs plain on the card, for every leg (int8 and packed int4 rows
   with an int8 query, bfloat16 and float32 rows with a float query,
   float32 in TF32 and, as leg f32x3 at precision "exact", in three TF32
   products; each with metric cosine, dot and l2): K1 (``fused_topk``) and K3
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
   fail the same comparison, and on the f32x3 leg so must the TF32 leg's
   plain version. For every leg theta0, the engine's floor from
   K3, must be at or below K1's own k-th value, and K3's maximum must
   equal K1's top-1 on the sample bit for bit. K1 at case (d)'s dim 96
   (8,192 rows, the shapes of the TPU's K2, its auto-pipelined kernel for
   dims that are not a multiple of 128) is timed beside its plain version,
   its bound and its library yardstick.
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
   - every leg (15 collections), 3 searches each: int8/int4 at top-16 on
     262,144 rows, bfloat16/float32 at top-100 on 131,072 rows (f32x3: a
     float32 collection searched at precision "exact").
4. Floor experiments, on the main path's reopened state (k_scan 28 and
   112) and on phase (iii)'s (k_scan 108, the JAX engine's bf16 top-100
   width), before those collections close:
   the A/B pairs of ``tools/kexp_floor.py`` (the port's kexp17/18/20/22)
   with the launch counters set to 0 before and read after: X8 and X6
   (``cuda_floor.fused_theta``, margin 0 and the engine's margin, sample
   dots skipped or not), X7 (K1 with and without the floor) and X9
   (``cuda_floor.fused_intgate``, int8), each EQUAL to the stock
   composition (K3 -> count threshold -> K1); ``fused_theta`` and
   ``fused_intgate`` must have launched. Then, not counted, each against
   its plain version: int8 EXACT, theta0 too; bfloat16 within the bound;
   on every leg theta0 bit-equal to ``bisect_floor`` of K3's sub-maxima
   less the margin.
5. Extraction experiments, on the same states (main path: k_scan 28 and
   112; (iii): 108): the A/B pairs of ``tools/kexp_extract.py`` (the port's
   kexp/kexp2/kexp3/kexp5, X1-X4: ``cuda_extract``'s seven kernels, floor,
   store, gate, unroll2, unroll4, pingpong and carry) against K1 with no
   floor over the whole 2048-row blocks, each agreeing with it (int8
   EQUAL, bfloat16 within the bound; the floor variant against its plain
   version), with the extraction counters set to 0 before and read after:
   every kernel must have launched. Variant names that share a build are
   checked for agreement and timed once. Then, not counted, each kernel
   against its plain twin on the state (dead slots: deleted and never
   written) and on case (e)'s ties across list cuts at the phase's first
   k_scan and at 112 (X2's carry in shared, then in global memory): int8
   EXACT, bfloat16 within the bound, the ties EXACT and lowest slot first;
   and X2's count (one part per query group) EQUAL to its closed form.
6. Serving, on the main path. During its ingest every chunk is also
   quantized on the port's CPU path: the share of stored bytes that differ
   (a cosine norm whose last ulp differs flips a byte at a rounding edge)
   is printed and must stay within the rate measured between the JAX
   engine and the port's CPU engine (``FLIP_RATE_BOUND``), by at most 1.
   Then, on the reopened state before the collection closes, with the
   launch counters set to 0 before and read after: a ``VrodServer`` on
   127.0.0.1 (port 0) over the loaded Database; 4 client processes
   (spawned: no interpreter lock shared with the server) of 64
   connections each, 256 requests in flight, send 2,048 single-query
   SEARCHSIMILAR requests at top-16, which the server's ``QueryBatcher``
   packs into batches of up to 256, and one batch request of 256 queries
   runs through ``search_packed``. Every answer over the wire must have
   recall 1.0 against the exact float32 scan (tie-aware, unique ids) and
   no deleted id; K1 and K3 of int8-cosine must have launched. It prints
   request p50/p99, queries/s and the batcher's batch sizes; the launch
   counts of these requests join the main path's. Then, counted apart: a
   replica, a 65,536-row int8 cosine collection (plus 1,000 rows and
   deletes in its WAL tail) in the same database, pulled by a
   ``Replicator`` into a second Database on the card behind a read-only
   ``VrodServer``, answers 288 queries through a ``VrodPool`` (and 256
   straight) with the primary's ids and scores; K1 must launch. The
   replica's 65,536 rows are a cut in depth, for the time limit.
7. Sharded, one process: the main path's rows and queries (same seed) in
   an int8 cosine collection of ``shards=4`` over devices that cycle the
   visible cards (on one card ``[cuda:0] * 4``): ``Database.new`` ->
   ``create_collection`` -> ``bulk_insert`` -> 20 x ``search_similar`` at
   b256, top-16. Capacity 1,048,576, so 262,144 rows a shard, the least at
   which int8 top-16's floor opens; its gate must open at that size. With
   the launch counters set to 0 before and read after: K1 and K3 launch
   exactly 4 times (once a shard) for every search. Every answer has
   recall 1.0 against the exact float32 scan and EQUALS the one-shard main
   path's (ids and scores); then snapshot, delete the main path's 1,000
   ids, reopen on the same 4 shards, and the answers equal the main path's
   after its reopen. ``engine.search`` p50 and device time per search
   (torch.profiler) are printed beside the main path's.
8. Two processes: this script starts itself twice (``--mh-rank``), each a
   rank of a process group (``VROD_COORDINATOR`` on 127.0.0.1) holding 2
   shards of one 4-shard mesh on its card (both on one card when there is
   one; the backend follows ``parallel.distributed``'s rule: gloo when
   ranks share a card, NCCL when each has its own). SPMD on each rank:
   ``bulk_insert`` of 262,144 x 768 int8 cosine rows (the depth cut for
   the time limit; the floor's gate stays closed at 65,536 rows a shard,
   so K3 does not run here), 5 searches at b256 top-16 with recall 1.0
   against the exact scan of a one-shard copy of the rows, 1,000 deletes,
   a collective snapshot and a collective reload, the searches again. The
   ranks' answers must be equal (a digest of every id and score), and each
   rank's K1 must launch (its counters set to 0 before and read after, in
   its own process). A failed rank fails the run.
9. The remaining verbs, on the main path's reopened 1M x 768 int8 cosine
   database (kept open since phase 6), with the launch counters set to 0
   before and read after; K1 and K3 of int8-cosine must launch in each of
   (a)-(d). (a) Filtered SEARCHSIMILAR: ``within_ids`` of 100,000 seeded
   live ids, then ``exclude_ids`` of 100,000, 5 batches of 256 each at
   top-16: no id outside the filter and recall 1.0 against the exact
   float32 scan of only the admitted rows; one request through
   ``CommandBuilder`` with ``;within=`` answers as ``search_similar``;
   prints the mask build time and the filtered p50 beside the unfiltered.
   (b) Top-100 at the engine's k_scan, 5 batches, recall 1.0. (c) Delete
   250,000 seeded ids, then REINDEX: rows must move and the capacity
   shrink, the same queries return the same ids and scores as before the
   REINDEX and no deleted id; prints its time. (d) BACKUP into the
   phase's directory, ``verify_image`` ok, ``Database.load`` of the image
   on the card answers as the source; prints both times. (e) The fuzz
   streams on the card: ``tools/fuzz_backup.py`` and
   ``tools/fuzz_cold_count.py`` one seed each, and two configurations of
   ``tools/fuzz_model.py``'s op stream, each against its host model.
10. The repo's tools and examples over the package, each a process on
   ``cuda:0`` (``PYTHONPATH`` this checkout): ``tools/filter_bench.py`` at
   its defaults (1,048,576 x 768 bfloat16 cosine, b256, top-16: no
   excluded slot returned, the allowlist held; its K1 must launch) and at
   ``--dtype int8`` (K1 and K3 must launch: the floor opens); then, beside
   ``tools/soak_serve.py`` for SOAK_MINUTES in the background (errors 0,
   fds back within 16 of their start, K1 launched; the RSS and
   device-memory plateau is judged from the 2-minute mark, which this
   soak does not reach, and the output says so), the three port examples
   (``examples/torch_quickstart.py``, whose lines must equal its lines on
   the CPU, every name and score to 3 decimals; ``torch_serving.py``;
   ``torch_replication.py``, read-your-writes and the cutover lines) and
   ``tools/repl_drill.py`` at DRILL_ROWS x 768 with a 100,000-row tail
   (the one depth cut of its 10M: one bootstrap, then a resume after a
   SIGKILL with no bootstrap or resync, spot records bit-identical). Each
   tool's JSON summary is printed on a line of its own; the launches in
   the tools' processes are printed apart and join no count of the
   kernels' line.
11. The port's bench, ``bench_torch.py``, each run a process on
   ``cuda:0``: the headline at its defaults (1,000,000 x 768 int8 cosine,
   b256, top-16), then ``--quick`` runs: l2, int4 dot, and the workloads
   batch-sweep, scaling, mixed, serve and serve-batch (BENCH_RUNS). Each
   run's line is printed and must hold a positive ``value``, no
   ``error``, this card's line, recall 1.0 in every
   ``recall_full_scan@k``, the mixed workload's ``final_count`` (its
   rows + 128 an iteration) and a K1 launch; the headline must launch K3
   too. Their launches are printed apart, as phase 10's. Then one warm
   headline search of the bench's engine in this process under
   ``torch.cuda.set_sync_debug_mode("warn")``: its synchronizing calls
   are printed by the line that made each (a one-slot readback, the
   control, must show as one).

Per kernel and leg, at the shapes of its first (largest) phase, the script
also computes the kernel's bound (the larger of the bytes its inputs and
outputs must move at 3.35 TB/s and its tensor-core operations, 2 * B * N *
D, at the dense peak of its type; f32x3 does three TF32 products for each)
and times a library yardstick that the port never calls: two PyTorch
calls, since no one call computes either kernel's function: the leg's
GEMM ``q @ x.T`` (``torch._int_mm`` for int8, the same on unpacked rows
for int4, ``torch.matmul`` in bfloat16, in float32 with TF32 on, and for
f32x3 in float32 with TF32 off), then ``torch.topk(k_scan)`` (K1) or the
max over the strided 128-row groups (K3).

The floor kernels' bound is K1's (the rows and inputs once, the scan's
operations); their yardstick is the stock composition's time, since no
one PyTorch call computes their function (``library_ms`` null). The
extraction kernels' bound is K1's too; their yardstick is K1 with no
floor on the same tensors (``k1_ms``; ``library_ms`` null).

The last two lines of standard output are one JSON object per line: the
kernels' account (one entry per kernel and leg), then ``{"ok": true,
"device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
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
            "f32": "float32", "f32x3": "float32"}
# The H100 SXM's datasheet rates (dense): HBM bytes/s, and tensor-core
# operations/s by the type the kernels multiply in (f32x3: three TF32
# products for each float32 product).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"int8": 1979e12, "int4": 1979e12, "bf16": 989e12,
            "f32": 495e12, "f32x3": 495e12 / 3}
SOURCES = {"fused_topk": ("vrod_tpu_torch/csrc/fused_topk.cu",
                          "vrod_tpu/ops/pallas_topk.py:251"),
           "sampled_submax": ("vrod_tpu_torch/csrc/sampled_submax.cu",
                              "vrod_tpu/ops/pallas_topk.py:468"),
           "fused_theta": ("vrod_tpu_torch/csrc/fused_theta.cu",
                           "experiments/kexp20.py:178"),
           "fused_intgate": ("vrod_tpu_torch/csrc/fused_topk.cu",
                             "experiments/kexp22.py:127")}
# The floor experiments' phases and k_scans (phase 4).
FLOOR_KSCANS = {"main path": (28, 112), "(iii)": (108,)}
# The extraction experiments' phases and k_scans (phase 5), their block, and
# the line of each experiment's pallas_call (a kernel's experiment:
# cuda_extract.KERNEL_CALLS).
EXTRACT_KSCANS = {"main path": (28, 112), "(iii)": (108,)}
EXTRACT_BLOCK = 2048
# The serve phase (6): client processes and connections in each (256 in
# flight: one full batch of the server's QueryBatcher), their single
# queries (batches of the main path's queries), and the replica's rows.
SERVE_PROCS, SERVE_CONNS, SERVE_MAX_BATCH = 4, 64, 256
SERVE_SINGLE_BATCHES, REPLICA_ROWS = 8, 65536
# Stored int8 bytes that may differ between two quantizers of the same
# rows whose cosine norms differ in the last ulp: the rate measured between
# the JAX engine and the port's CPU engine at 65,536 x 768
# (tests/test_torch_search_options.py, 27 of 50,331,648 elements).
FLIP_RATE_BOUND = 27 / 50331648
EXTRACT_PALLAS_LINE = {"kexp": 248, "kexp2": 170, "kexp3": 158, "kexp5": 156}
# Phase 7: the main path's collection on this many shards. Phase 8: ranks,
# shards a rank, rows (the depth cut for the time limit), searches and the
# ranks' time limit.
SHARDS = 4
# The least --rows at which each of phase 7's shards holds 262,144 rows
# (capacity grows by 65,536 rows a shard), the least at which int8
# top-16's floor opens.
SHARDED_MIN_ROWS = SHARDS * (262144 - 65536) + 1
MH_RANKS, MH_SHARDS_PER_RANK, MH_ROWS, MH_SEARCHES = 2, 2, 262144, 5
MH_TIMEOUT_S = 300
# Phase 9: query batches, the filters' id counts, the ids deleted before
# REINDEX, the fuzz seeds run on the card (tools/fuzz_backup.py seed 2 is
# its int8 tier; the model stream's configurations by index in
# tools/fuzz_model.CONFIGS).
VERB_BATCHES, VERB_TOP_K, VERB_TOP_K_WIDE = 5, 16, 100
FILTER_IDS, REINDEX_DELETE = 100_000, 250_000
FUZZ_BACKUP_SEED, FUZZ_COLD_SEED, FUZZ_MODEL_CONFIGS = 2, 0, (1, 2)
# Phase 10: the soak's minutes (no 2-minute plateau mark within them), the
# drill's rows and tail (the depth cut of tools/repl_drill.py's 10M rows),
# and the time limit of each tool's process.
SOAK_MINUTES = 1.5
DRILL_ROWS, DRILL_TAIL_ROWS = 1_048_576, 100_000
TOOL_TIMEOUT_S = 600
# Phase 11: bench_torch.py's runs (the headline at its defaults first),
# and the final count of its mixed workload at --quick (65,536 rows, 3
# iterations, each +256 -128).
BENCH_RUNS = (("headline", []),
              ("l2", ["--metric", "l2", "--quick"]),
              ("int4 dot", ["--dtype", "int4", "--metric", "dot", "--quick"]),
              ("batch-sweep", ["--workload", "batch-sweep", "--quick"]),
              ("scaling", ["--workload", "scaling", "--quick"]),
              ("mixed", ["--workload", "mixed", "--quick"]),
              ("serve", ["--workload", "serve", "--quick"]),
              ("serve-batch", ["--workload", "serve-batch", "--quick"]))
MIXED_QUICK_COUNT = 65536 + 128 * 3


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
            "f32": torch.float32, "f32x3": torch.float32}[dtype]


def leg_precision(leg) -> str:
    """The search precision of a leg: "exact" for f32x3 (float32 rows in
    three TF32 products), else "fast"."""
    return "exact" if leg.startswith("f32x3") else "fast"


def error_bound(args, leg):
    """``cuda_topk.score_error_bound`` of kernel inputs ``args`` of a leg."""
    from vrod_tpu_torch.ops import cuda_topk as K
    return K.score_error_bound(*args, metric=leg.split("-")[1],
                               precision=leg_precision(leg))


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
    if dtype == "f32x3":
        kw["precision"] = "exact"
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
    from vrod_tpu_torch.engine import FloorSettings, floor_threshold
    dtype, metric = leg.split("-")
    return floor_threshold(sub, k, args[3], args[1], args[2],
                           metric=metric, quant=dtype in ("int8", "int4"),
                           dim=args[0].shape[1],
                           fs=FloorSettings.from_env())


def reached(bound_ms, t) -> str:
    """The share of its bound a timed kernel reached: by device time, or by
    CUDA events where the profiler kept none of its kernels."""
    if t["device_ms"] > 0:
        return f"{bound_ms / t['device_ms']:.1%} of it reached by device time"
    return (f"{bound_ms / t['ms']:.1%} of it reached by events; the profiler "
            "kept none of its kernels")


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
    float32 while it runs, off for f32x3: a float32 GEMM)."""
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
        from vrod_tpu_torch.ops import cuda_extract as X
        from vrod_tpu_torch.ops import cuda_floor as F
        from vrod_tpu_torch.ops import cuda_topk as K
        names = list(K.launches) + list(F.launches) + list(X.launches)
        self.max_err = {name: 0.0 for name in names}
        # Largest |kernel - plain| / bound (float legs), and per float leg
        # the smallest such share that a truncating control reached.
        self.max_share = {name: 0.0 for name in names}
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
        bound = error_bound(args, leg)
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
            bound = error_bound(args, leg)
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
        comparison that the kernel passes; and on the f32x3 leg so must
        the TF32 leg's plain version ("tf32": one TF32 product)."""
        from vrod_tpu_torch.ops import cuda_topk as K
        dtype, metric = leg.split("-")
        if dtype in ("int8", "int4"):
            return
        bound = error_bound(args, leg)
        want = K.fused_topk_plain(*args, k=k, metric=metric, **kw)
        controls = {"f32": (("tf32-rz", 13), ("bf16-rz", 16)),
                    "f32x3": (("tf32-rz", 13), ("bf16-rz", 16),
                              ("tf32", 0)),
                    "bf16": (("bf16-rz", 16),)}[dtype]
        for name, drop in controls:
            cut, ckw = list(args), dict(kw)
            if name == "tf32":
                ckw.pop("precision")
            else:
                if dtype != "bf16":
                    cut[0] = truncated(args[0], drop)
                cut[3] = truncated(args[3], drop)
            got = K.fused_topk_plain(*cut, k=k, metric=metric, **ckw)
            if K.topk_disagreement(*got, *want, bound) is None:
                raise AssertionError(f"{what}: the float bound passes a "
                                     f"{name} control scorer")
            share = self._share(got[0], want[0], bound)
            self.control_share[leg] = min(
                self.control_share.get(leg, share), share)

    def theta(self, leg, args, k, blk, s_blocks, margin, skip, what):
        """fused_theta (X6/X8) against its plain version: int8/int4
        EXACT, theta0 too; float legs within the bound. On every leg theta0
        is bisect_floor of K3's sub-maxima (K1's scores) less the margin,
        bit for bit."""
        import torch
        from vrod_tpu_torch.ops import cuda_floor as F
        from vrod_tpu_torch.ops import cuda_topk as K
        from vrod_tpu_torch.ops import distances as D
        metric = leg.split("-")[1]
        kw = dict(k=k, metric=metric, block_rows=blk, s_blocks=s_blocks,
                  margin=margin, skip_sample_dots=skip, return_theta=True)
        got = F.fused_theta(*args, **kw)
        want = F.fused_theta_plain(*args, **kw)
        ns = blk * s_blocks
        sub = K.sampled_submax(*[a[:ns] for a in args[:3]], args[3],
                               metric=metric, block_rows=blk)
        bound = K.score_error_bound(*args, metric=metric)
        torch.cuda.synchronize()
        self._same_form(got, want, f"{what}: fused_theta")
        msg = K.topk_disagreement(*got[:2], *want[:2], bound)
        if msg:
            raise AssertionError(f"{what}: fused_theta vs plain: {msg}")
        if leg.startswith(("int8", "int4")) and not torch.equal(got[2],
                                                                want[2]):
            raise AssertionError(f"{what}: theta0 differs from the plain "
                                 "version's")
        if not torch.equal(got[2], D.bisect_floor(sub, k) - (margin or 0.0)):
            raise AssertionError(f"{what}: theta0 is not bisect_floor of "
                                 "K3's sub-maxima less the margin")
        self._err(f"fused_theta[{leg}]", got[0], want[0], bound)

    def intgate(self, leg, args, k, theta0, what):
        """fused_intgate (X9) EXACTLY equal to its plain version."""
        import torch
        from vrod_tpu_torch.ops import cuda_floor as F
        metric = leg.split("-")[1]
        got = F.fused_intgate(*args, k=k, metric=metric, theta0=theta0)
        want = F.fused_intgate_plain(*args, k=k, metric=metric,
                                     theta0=theta0)
        torch.cuda.synchronize()
        self._same_form(got, want, f"{what}: fused_intgate")
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"{what}: fused_intgate differs from plain")
        self._err(f"fused_intgate[{leg}]", got[0], want[0],
                  torch.zeros((args[3].shape[0], 1), device=got[0].device))

    def extract(self, kern, leg, xargs, k, what, block_rows=EXTRACT_BLOCK,
                exact=False):
        """An extraction kernel against its plain twin on the experiments'
        inputs ``xargs``: int8 (and with ``exact``, every leg) EXACT, float
        legs within the bound."""
        import torch
        from vrod_tpu_torch.ops import cuda_extract as X
        from vrod_tpu_torch.ops import cuda_topk as K
        metric = leg.split("-")[1]
        kw = dict(k=k, metric=metric, block_rows=block_rows)
        got = X.run_kernel(kern, *xargs, **kw)
        want = X.run_kernel(kern, *xargs, plain=True, **kw)
        n = xargs[0].shape[0]
        if exact or xargs[0].dtype == torch.int8:
            bound = torch.zeros((xargs[3].shape[0], 1), device=got[0].device)
        else:
            bound = K.score_error_bound(
                xargs[0], xargs[1].reshape(n),
                torch.isfinite(xargs[2].reshape(n)), xargs[3], metric=metric)
        torch.cuda.synchronize()
        self._same_form(got, want, f"{what}: extract_{kern}")
        msg = K.topk_disagreement(*got, *want, bound)
        if msg:
            raise AssertionError(f"{what}: extract_{kern} vs plain: {msg}")
        self._err(f"extract_{kern}[{leg}]", got[0], want[0], bound)
        return got

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
    """Cases (a)-(f) for one leg; returns the times at shape (a) and K1's
    at case (d)'s dim 96."""
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
    k2 = {}
    for d in (96, 30):
        xd = torch.from_numpy(rng.standard_normal((8192, d),
                                                  dtype=np.float32))
        qd = torch.from_numpy(rng.standard_normal((BATCH, d),
                                                  dtype=np.float32))
        ad, kd = kernel_inputs(xd, qd, leg, dev, dead_every=5)
        cmp.submax(leg, ad, kd, 4096, f"{leg} (d) K3 dim {d}")
        cmp.topk(leg, ad, kd, 28, f"{leg} (d) dim {d}", 77)
        if d == 96:
            # K2's shapes (the TPU's auto-pipelined kernel for dims that
            # are not a multiple of 128): K1 at dim 96, its library
            # yardstick and its bound.
            kk = dict(k=28, metric=metric, index_offset=77, **kd)
            gemm = library_gemm(leg, ad[0], ad[3])
            extra = [v for v in kd.values() if torch.is_tensor(v)]
            k2 = {"fused_topk_dim96": cuda_time_ms(
                      lambda: K.fused_topk(*ad, **kk)),
                  "fused_topk_dim96_plain": cuda_time_ms(
                      lambda: K.fused_topk_plain(*ad, **kk), iters=5),
                  "fused_topk_dim96_library": cuda_time_ms(
                      lambda: gemm().topk(28, dim=1), iters=5),
                  "fused_topk_dim96_bound": bound_of(
                      ad + extra, BATCH * 28 * 8, 2 * BATCH * 8192 * d,
                      leg.split("-")[0])}
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
        **k2,
    }


def tool_module(name):
    """``tools/<name>.py`` of this checkout."""
    import importlib.util
    path = Path(__file__).resolve().parent / "tools" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def floor_phase(cmp, card, name, leg, args, k_scans):
    """Phase 4 on one Database phase's kernel inputs ``args`` (x, aux,
    valid, q_scan): the floor experiments' A/B pairs with the floor
    kernels' counters set to 0 before and read after (each must have
    launched), then, not counted, the kernels against their plain
    versions. Returns (launches, records, times at the first k_scan)."""
    import torch
    from vrod_tpu_torch import engine
    from vrod_tpu_torch.ops import cuda_floor as F
    kf = tool_module("kexp_floor")
    dtype = leg.split("-")[0]
    F.reset_launches()
    recs = kf.run_pairs(args, dtype, k_scans, kf.LEGS, iters=10, card=card)
    torch.cuda.synchronize()
    launches = dict(F.launches)
    need = [f"fused_theta[{leg}]"] + (
        [f"fused_intgate[{leg}]"] if leg in F.INTGATE_LEGS else [])
    for kname in need:
        if launches[kname] == 0:
            raise AssertionError(f"{name} floor experiments: launched no "
                                 f"{kname}")
    log(f"{name} floor experiments: {len(recs)} pairs equal to the stock "
        f"composition; launches {json.dumps({n: c for n, c in launches.items() if c})}")
    for r in recs:
        log(f"  {leg} k_scan {r['k_scan']} {r['leg']} {r['variant']}: stock "
            f"{r['stock_ms']:.4f} ms (device {r['stock_device_ms']:.4f}, "
            f"{r['stock_kernels_per_call']:g} kernels), variant "
            f"{r['variant_ms']:.4f} ms (device {r['variant_device_ms']:.4f}, "
            f"{r['variant_kernels_per_call']:g} kernels), sample "
            f"{r['sample_rows']} in blocks of {r['block_rows']} [{card}]")
    times = {}
    for k in k_scans:
        theta0, (ns, blk) = kf.stock_floor(args, k)
        for margin in (None, engine.THETA0_MARGIN):
            for skip in (False, True):
                cmp.theta(leg, args, k, blk, ns // blk, margin, skip,
                          f"{name} fused_theta k {k} margin {margin} "
                          f"skip {skip}")
        if leg in F.INTGATE_LEGS:
            cmp.intgate(leg, args, k, theta0, f"{name} fused_intgate k {k}")
        if times:
            continue
        first = {(r["leg"], r["variant"]): r for r in recs
                 if r["k_scan"] == k}
        kw = dict(k=k, metric=leg.split("-")[1], block_rows=blk,
                  s_blocks=ns // blk)
        x8 = first[("x8", "plain")]
        n, d = args[0].shape
        bound = bound_of(args, BATCH * k * 8, 2 * BATCH * n * d, dtype)
        times["fused_theta"] = dict(
            ms=x8["variant_ms"], device_ms=x8["variant_device_ms"],
            kernels=x8["variant_kernels_per_call"],
            stock_ms=x8["stock_ms"], stock_device_ms=x8["stock_device_ms"],
            plain_ms=cuda_time_ms(
                lambda: F.fused_theta_plain(*args, **kw), iters=3),
            bound=bound, k_scan=k, rows=n)
        if leg in F.INTGATE_LEGS:
            x9 = first[("x9", "intgate")]
            times["fused_intgate"] = dict(
                ms=x9["variant_ms"], device_ms=x9["variant_device_ms"],
                kernels=x9["variant_kernels_per_call"],
                stock_ms=x9["stock_ms"],
                stock_device_ms=x9["stock_device_ms"],
                plain_ms=cuda_time_ms(lambda: F.fused_intgate_plain(
                    *args, k=k, metric=leg.split("-")[1], theta0=theta0),
                    iters=3),
                bound=bound, k_scan=k, rows=n)
    return launches, recs, times


def tie_extract_inputs(leg, dev, rng):
    """Case (e)'s ties across list cuts as the experiments take them: 40
    copies of row 7 in each of the first seven row tiles of part 0, query 0
    = row 7, rows of -1/0/1 and queries of four +-2, aux 1, no dead slot,
    so every score is exact; (x, aux2d, mask2d, q, offset) and the
    copies."""
    import torch
    from vrod_tpu_torch.ops import cuda_topk as K
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    _, parts, _ = K.topk_plan(8 * K.TILE_ROWS * sms, BATCH, 112, sms)
    n = 8 * parts * K.TILE_ROWS
    copies = [t * parts * K.TILE_ROWS + r for t in range(7)
              for r in range(8, 48)]
    x = rng.integers(-1, 2, (n, DIM)).astype(np.float32)
    x[7] = 0.0
    x[7, :4] = 2.0
    x[copies] = x[7]
    q = np.zeros((BATCH, DIM), np.float32)
    for row in q:
        row[rng.choice(DIM, 4, replace=False)] = rng.choice([-2.0, 2.0], 4)
    q[0] = x[7]
    quant = leg.startswith("int8")
    kind = torch.int8 if quant else row_dtype(leg.split("-")[0])
    return [torch.from_numpy(x).to(kind).to(dev),
            torch.ones((1, n), device=dev), torch.zeros((1, n), device=dev),
            torch.from_numpy(q).to(torch.int8 if quant else torch.float32)
            .to(dev), torch.zeros(1, dtype=torch.int32, device=dev)], copies


def extract_phase(cmp, card, name, leg, args, k_scans):
    """Phase 5 on one Database phase's kernel inputs ``args`` (x, aux,
    valid, q_scan): the extraction experiments' A/B pairs with the
    extraction counters set to 0 before and read after (every kernel must
    have launched), then, not counted, each kernel against its plain twin
    on this state and on the ties across list cuts, and X2's count against
    its closed form. Returns (launches, records, times at the first
    k_scan)."""
    import torch
    from vrod_tpu_torch.ops import cuda_extract as X
    ke = tool_module("kexp_extract")
    dtype, metric = leg.split("-")
    wall0 = time.perf_counter()
    X.reset_launches()
    recs = ke.run_pairs(args, dtype, k_scans, ke.EXPERIMENTS,
                        block_rows=EXTRACT_BLOCK, iters=10, card=card)
    torch.cuda.synchronize()
    launches = dict(X.launches)
    for kern in X.KERNELS:
        if launches[f"extract_{kern}[{leg}]"] == 0:
            raise AssertionError(f"{name} extraction experiments: launched "
                                 f"no extract_{kern}[{leg}]")
    log(f"{name} extraction experiments: {len(recs)} pairs agree with K1 "
        f"(no floor) or the plain floor; launches "
        f"{json.dumps({n: c for n, c in launches.items() if c})}")
    for r in recs:
        what = f"  {leg} k_scan {r['k_scan']} {r['experiment']} " \
            f"{r['variant']} ({r['kernel']}):"
        if "timed_as" in r:
            log(f"{what} agrees; same build as {r['timed_as']}")
            continue
        log(f"{what} {r['reference']} {r['reference_ms']:.4f} ms "
            f"(device {r['reference_device_ms']:.4f}, "
            f"{r['reference_kernels_per_call']:g} kernels), variant "
            f"{r['variant_ms']:.4f} ms (device {r['variant_device_ms']:.4f}, "
            f"{r['variant_kernels_per_call']:g} kernels) [{card}]")
    xargs = ke.experiment_args(args)
    k = k_scans[0]
    for kern in X.KERNELS:
        cmp.extract(kern, leg, xargs, k, f"{name} k {k} dead slots")
    cnt = ke.count_of(args, k, EXTRACT_BLOCK, tiles=2)[2]
    log(f"{name} X2 count (tiles 2, k_scan {k}): {int(cnt[0])}, equal to "
        "the closed form")
    targs, copies = tie_extract_inputs(leg, args[0].device,
                                       np.random.default_rng(7))
    # At the phase's first k_scan (X2's carry in shared memory at k 28) and
    # at 112 (in global memory).
    for kt in dict.fromkeys((k, 112)):
        for kern in X.KERNELS:
            _, i = cmp.extract(kern, leg, targs, kt,
                               f"{name} (e) ties across list cuts, k {kt}",
                               block_rows=2 * 128, exact=True)
            if kern != "floor" and i[0].tolist() != [7] + copies[:kt - 1]:
                raise AssertionError(
                    f"{name} (e) ties across list cuts, k {kt}: "
                    f"extract_{kern} not lowest slot first")
    first = {r["kernel"]: r for r in recs
             if r["k_scan"] == k and "variant_ms" in r}
    k1 = first["gate"]
    n, d = args[0].shape
    bound = bound_of(xargs, BATCH * k * 8, 2 * BATCH * n * d, dtype)
    kw = dict(k=k, metric=metric, block_rows=EXTRACT_BLOCK)
    times = {}
    for kern, r in first.items():
        times[kern] = dict(
            ms=r["variant_ms"], device_ms=r["variant_device_ms"],
            kernels=r["variant_kernels_per_call"], k1_ms=k1["reference_ms"],
            k1_device_ms=k1["reference_device_ms"],
            plain_ms=cuda_time_ms(lambda kern=kern: X.run_kernel(
                kern, *xargs, plain=True, **kw), iters=2, warmup=1),
            bound=bound, k_scan=k, rows=n)
    log(f"{name} extraction experiments: {time.perf_counter() - wall0:.1f} s")
    return launches, recs, times


def oracle_kth(eng, q, top_k, state=None):
    """Exact float32 full scan of the stored rows on the card: the k-th
    best user-facing score per query (the plain blockwise scan with the
    float32 query; l2: the k-th smallest squared distance). ``state`` is
    a sharded engine's ``gather_state()``; a one-shard engine's own
    tensors by default."""
    import torch
    from vrod_tpu_torch.ops import distances as D
    metric = eng.cfg.metric
    x, aux, valid = state[:3] if state else (eng.x, eng.aux, eng.valid)
    q = torch.from_numpy(q).to(eng.device)
    qp = D.prepare_queries(q, metric=metric)
    blk = 65536 if eng.capacity % 65536 == 0 else eng.capacity
    vals, _ = D.blockwise_topk(x, aux, valid, qp, k=top_k,
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
        hits = col.search_similar(q, top_k, precision=leg_precision(leg))
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


def quant_flips(col, chunk, ids, flips):
    """Quantize ``chunk`` on the port's CPU path and add to ``flips`` (count,
    largest difference) how its stored bytes differ from those the card
    stored for ``ids``."""
    import torch
    from vrod_tpu_torch.ops import distances as D
    want, _ = D.prepare_rows(torch.from_numpy(chunk), metric="cosine",
                             dtype="int8")
    slots = col.alloc.slots_of(np.asarray(ids, np.uint64)).astype(np.int64)
    got = col.engine.x[torch.from_numpy(slots).to(col.engine.device)].cpu()
    diff = (got.int() - want.int()).abs()
    flips[0] += int((diff != 0).sum())
    flips[1] = max(flips[1], int(diff.max()))


def serve_client_process(index, addr, vecs, top_k, conns, barrier, out):
    """One client process of the serve phase: ``conns`` threads, each with
    its own connection, send the single queries ``vecs[t::conns]`` one at a
    time once every process is connected (``barrier``), and put (index,
    [(id, score), ...] per query, latencies in s) on ``out``."""
    import threading
    from vrod_tpu_torch import VrodClient
    clients = [VrodClient(addr) for _ in range(conns)]
    hits, lat = [None] * len(vecs), [[] for _ in range(conns)]

    def run(t):
        for i in range(t, len(vecs), conns):
            t0 = time.perf_counter()
            got = clients[t].search_similar("docs", vecs[i], k=top_k)
            lat[t].append(time.perf_counter() - t0)
            hits[i] = [(h.record_id, h.score) for h in got]

    threads = [threading.Thread(target=run, args=(t,)) for t in range(conns)]
    barrier.wait()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for c in clients:
        c.close()
    out.put((index, hits, [x for ts in lat for x in ts]))


def serve_load(addr, single, top_k):
    """Send the single queries from SERVE_PROCS client processes of
    SERVE_CONNS connections each (spawned, so they share no interpreter
    lock with the server). Returns (hits per query as (id, score) lists,
    request latencies in ms, wall s from the start signal to the last
    answer)."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    barrier, out = ctx.Barrier(SERVE_PROCS + 1), ctx.Queue()
    procs = [ctx.Process(target=serve_client_process,
                         args=(p, addr, single[p::SERVE_PROCS], top_k,
                               SERVE_CONNS, barrier, out))
             for p in range(SERVE_PROCS)]
    for p in procs:
        p.start()
    try:
        barrier.wait(timeout=300)
        wall0 = time.perf_counter()
        hits, lat = [None] * len(single), []
        for _ in procs:
            index, got, ts = out.get(timeout=600)
            hits[index::SERVE_PROCS] = got
            lat += ts
        wall = time.perf_counter() - wall0
        for p in procs:
            p.join(timeout=60)
            if p.exitcode != 0:
                raise AssertionError(f"serve client process exited "
                                     f"{p.exitcode}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    return hits, np.array(lat) * 1e3, wall


def serve_phase(card, db, col, queries, top_k, gone, seed):
    """The serving slice on the main path's reopened collection (module
    docstring, phase 6). Returns the launch counts of the served main-path
    requests (the replica check's are counted apart)."""
    import torch
    from vrod_tpu_torch import VrodClient, VrodServer, metrics
    from vrod_tpu_torch.collection import SearchHit
    from vrod_tpu_torch.ops import cuda_topk as K
    dev = col.engine.device
    single = np.concatenate(queries[:SERVE_SINGLE_BATCHES])
    kth = np.concatenate([oracle_kth(col.engine, q, top_k)
                          for q in queries[:SERVE_SINGLE_BATCHES]])
    batch_q = queries[SERVE_SINGLE_BATCHES]
    batch_kth = oracle_kth(col.engine, batch_q, top_k)
    batches = []

    def sink(rec):
        if rec["event"] == "frontend.batch":
            batches.append(rec["batch"])

    metrics.query_log.configure(sink)
    server = VrodServer(db, ("127.0.0.1", 0)).start()
    try:
        with VrodClient(server.address) as c:  # warm-up, not timed
            c.search_similar("docs", single[0], k=top_k)
        batches.clear()
        K.reset_launches()
        got, lat_ms, wall = serve_load(server.address, single, top_k)
        out = [[SearchHit(r, sc, "") for r, sc in hs] for hs in got]
        check_hits(out, kth, col.config.metric, top_k, "serve single")
        single_batches = list(batches)
        with VrodClient(server.address) as c:
            t0 = time.perf_counter()
            packed = c.search_similar_batch("docs", batch_q, k=top_k)
            batch_ms = (time.perf_counter() - t0) * 1e3
        check_hits(packed, batch_kth, col.config.metric, top_k,
                   "serve batch")
        for hs in out + packed:
            if any(h.record_id in gone for h in hs):
                raise AssertionError("serve: a deleted id came back")
        torch.cuda.synchronize(dev)
        launches = dict(K.launches)
        for kname in ("fused_topk[int8-cosine]",
                      "sampled_submax[int8-cosine]"):
            if not launches[kname]:
                raise AssertionError(f"serve: launched no {kname}")
        ran = {k: v for k, v in launches.items() if v}
        sizes = np.array(single_batches)
        log(f"serve: {len(single)} single SEARCHSIMILAR requests from "
            f"{SERVE_PROCS} client processes x {SERVE_CONNS} connections "
            f"over TCP, top-{top_k} on {col.count} rows: request p50 "
            f"{np.percentile(lat_ms, 50):.3f} ms, p99 "
            f"{np.percentile(lat_ms, 99):.3f} ms, "
            f"{len(single) / wall:.1f} queries/s; the batcher ran "
            f"{len(sizes)} batches, mean {sizes.mean():.2f} queries, "
            f"median {np.median(sizes):.0f}, largest {sizes.max()}, "
            f"{int((sizes == SERVE_MAX_BATCH).sum())} of "
            f"{SERVE_MAX_BATCH}; one batch request of {BATCH} queries "
            f"(packed hits) {batch_ms:.3f} ms; recall 1.0, unique ids, no "
            f"deleted id; launches {json.dumps(ran)} [{card}]")
        K.reset_launches()
        replica_check(card, db, server, seed)
        if not K.launches["fused_topk[int8-cosine]"]:
            raise AssertionError("serve replica: launched no K1")
        log("serve replica: launches (not counted in the kernels line) "
            f"{json.dumps({k: v for k, v in K.launches.items() if v})}")
    finally:
        metrics.query_log.configure(None)
        server.close()
    return launches


def replica_check(card, db, server, seed):
    """A replica of a REPLICA_ROWS-row int8 collection of the primary's
    database (a Replicator behind a read-only VrodServer, on the same card)
    answers the primary's queries, read through a VrodPool, with the
    primary's ids and scores."""
    from vrod_tpu_torch import (Database, Replicator, VrodClient, VrodPool,
                                VrodServer)
    rng = np.random.default_rng(seed)
    col = db.create_collection("replicated", dim=DIM, metric="cosine",
                               dtype="int8")
    col.bulk_insert(rng.standard_normal((REPLICA_ROWS, DIM),
                                        dtype=np.float32))
    col.snapshot()
    col.delete_many(np.arange(1, REPLICA_ROWS, 97))
    col.bulk_insert(rng.standard_normal((1000, DIM), dtype=np.float32))
    q = rng.standard_normal((BATCH, DIM), dtype=np.float32)
    tmp = Path(tempfile.mkdtemp(prefix="vrod_replica_"))
    try:
        rdb = Database.new(tmp, "replica", device=col.engine.device)
        try:
            t0 = time.perf_counter()
            rep = Replicator(rdb, server.address,
                             collections=["replicated"]).start()
            rserver = VrodServer(rdb, ("127.0.0.1", 0),
                                 read_only=True).start()
            rserver.attach_replicator(rep)
            try:
                rep.wait_caught_up(timeout=600)
                sync_s = time.perf_counter() - t0
                with VrodClient(server.address) as pc, \
                        VrodClient(rserver.address) as rc, \
                        VrodPool(server.address, [rserver.address]) as pool:
                    want = pc.search_similar_batch("replicated", q, k=16)
                    got = pool.search_similar_batch("replicated", q, k=16)
                    direct = rc.search_similar_batch("replicated", q, k=16)
                    want1 = [pc.search_similar("replicated", v, k=16)
                             for v in q[:32]]
                    got1 = [pool.search_similar("replicated", v, k=16)
                            for v in q[:32]]
                for w, g in zip(want + want + want1, got + direct + got1):
                    if [(h.record_id, h.score) for h in w] != \
                            [(h.record_id, h.score) for h in g]:
                        raise AssertionError(
                            f"replica answered {g[:3]}..., primary "
                            f"{w[:3]}...")
                log(f"serve replica: {REPLICA_ROWS} + 1000 rows int8 "
                    f"cosine (snapshot + WAL tail), caught up in "
                    f"{sync_s:.3f} s; {len(want) + len(want1)} queries "
                    f"through a VrodPool and {len(direct)} straight to the "
                    f"replica: ids and scores equal to the primary's "
                    f"[{card}]")
            finally:
                rserver.close()
        finally:
            rdb.close()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        db.drop_collection("replicated")


def db_phase(dev, card, cmp, *, name, leg, top_k, rows, searches, reopen,
             seed, floor_kscans=(), extract_kscans=(), serve=False,
             keep=None):
    """One Database phase through the entry points (module docstring,
    phase 3), then with ``floor_kscans`` the floor experiments on its state
    (phase 4), with ``extract_kscans`` the extraction experiments (phase
    5), and with ``serve`` the quantizer check during ingest and the
    serving slice on the reopened state (phase 6). Returns (launch counts
    of the phase, kernel times at its shapes, the floor experiments'
    (launches, records, times) or None, the extraction experiments'
    likewise, the serve phase's launch counts or None). With ``keep`` (a
    dict), it also keeps the phase's answers before and after the reopen,
    the deleted ids, its ``engine.search`` p50 and its device time per
    search, for phase 7 to hold the sharded collection against, and the
    open database and its directory (``db``, ``dir``) for phase 9."""
    import torch
    from vrod_tpu_torch import Database
    from vrod_tpu_torch.engine import FloorSettings, floor_gate
    from vrod_tpu_torch.ops import cuda_topk as K
    dtype, metric = leg.split("-")
    precision = leg_precision(leg)
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
        ingest_s, ids, flips = 0.0, [], [0, 0]
        for start in range(0, rows, INGEST_CHUNK):
            chunk = rng.standard_normal(
                (min(INGEST_CHUNK, rows - start), DIM), dtype=np.float32)
            t0 = time.perf_counter()
            ids.append(col.bulk_insert(chunk))
            torch.cuda.synchronize(dev)
            ingest_s += time.perf_counter() - t0
            if serve:
                quant_flips(col, chunk, ids[-1], flips)
        ids = np.concatenate(ids)
        if serve:
            rate = flips[0] / (rows * DIM)
            log(f"{name}: quantized on the card and on the port's CPU path, "
                f"{flips[0]} of {rows * DIM} stored bytes differ ({rate:.4g}"
                f"; bound {FLIP_RATE_BOUND:.4g}), by at most {flips[1]}")
            if rate > FLIP_RATE_BOUND or flips[1] > 1:
                raise AssertionError(f"{name}: the card's quantizer flips "
                                     f"{rate:.4g} of stored bytes")
        # warm-up, not timed
        col.search_similar(queries[0], top_k, precision=precision)
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
            q, metric=metric), precision)
        ok, ns, blk = floor_gate(eng.capacity, k_scan, eng.storage_dim,
                                 eng.x.element_size(), eng.quant,
                                 FloorSettings.from_env())
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
            eng.search(qb, top_k, precision=precision)
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
        if keep is not None:
            keep.update(before=before, after=after, gone=gone,
                        p50_ms=float(np.percentile(np.array(eng_lat) * 1e3,
                                                   50)),
                        device=search_device_ms(eng, queries, top_k,
                                                precision))
        log(f"{name}: engine.search p50 "
            f"{np.percentile(np.array(eng_lat) * 1e3, 50):.3f} ms; kernels "
            f"at its shapes ({eng.capacity} rows, sample {ns} in blocks of "
            f"{blk}, b{BATCH}, k_scan {k_scan}), ms: {json.dumps(times)} "
            f"[{card}]")
        floor = floor_phase(cmp, card, name, leg, a1, floor_kscans) \
            if floor_kscans else None
        extract = extract_phase(cmp, card, name, leg, a1, extract_kscans) \
            if extract_kscans else None
        served = serve_phase(card, db, col, queries, top_k, set(gone),
                             seed + 1) if serve else None
        if keep is not None:
            keep.update(db=db, dir=tmp)  # phase 9 closes and removes it
        else:
            db.close()
        return launches, times, floor, extract, served
    finally:
        if keep is None or keep.get("dir") != tmp:
            shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()


def search_device_ms(eng, queries, top_k, precision, calls=5):
    """(CUDA kernel time per ``engine.search``, kernels per search) by
    torch.profiler over ``calls`` warm searches; (None, 0) where the
    profiler saw no device time (then it is not measured)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    eng.search(queries[0], top_k, precision=precision)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for qb in queries[:calls]:
            eng.search(qb, top_k, precision=precision)
        torch.cuda.synchronize()
    total, count = 0.0, 0
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA:
            total += getattr(ev, "self_device_time_total",
                             getattr(ev, "self_cuda_time_total", 0))
            count += ev.count
    return (total / 1e3 / calls if total else None), count / calls


def fmt_ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.3f} ms"


def sharded_round(col, queries, top_k, what, want, per_search):
    """Search every query batch on a sharded collection: K1 and K3 of
    int8-cosine must launch ``per_search`` times each for every search
    (once a shard); recall 1.0 against the exact scan; the answers equal
    ``want`` (the one-shard main path's) exactly, ids and scores."""
    from vrod_tpu_torch.ops import cuda_topk as K
    names = ["fused_topk[int8-cosine]", "sampled_submax[int8-cosine]"]
    state = col.engine.gather_state()  # the oracle's copy, once a round
    for b, q in enumerate(queries):
        n0 = [K.launches[n] for n in names]
        hits = col.search_similar(q, top_k)
        for name, before in zip(names, n0):
            if K.launches[name] - before != per_search:
                raise AssertionError(
                    f"{what} {b}: {name} launched "
                    f"{K.launches[name] - before} times, not {per_search}")
        check_hits(hits, oracle_kth(col.engine, q, top_k, state), "cosine",
                   top_k, f"{what} {b}")
        got = [[(h.record_id, h.score) for h in hs] for hs in hits]
        if got != want[b]:
            bad = next(j for j, (g, w) in enumerate(zip(got, want[b]))
                       if g != w)
            raise AssertionError(
                f"{what} {b}/{bad}: {got[bad]} vs the one-shard main "
                f"path's {want[b][bad]}")


def shard_phase(card, main, *, rows, seed):
    """Phase 7 (module docstring): the main path's rows and queries on an
    int8 cosine collection of SHARDS shards over devices that cycle the
    visible cards. Returns its launch counts."""
    import torch
    from vrod_tpu_torch import Database
    from vrod_tpu_torch.engine import FloorSettings, floor_gate
    from vrod_tpu_torch.ops import cuda_topk as K
    top_k, cards = 16, torch.cuda.device_count()
    devices = [torch.device("cuda", i % cards) for i in range(SHARDS)]
    rng = np.random.default_rng(seed)  # the main path's seed
    queries = [rng.standard_normal((BATCH, DIM), dtype=np.float32)
               for _ in range(SEARCHES)]
    tmp = Path(tempfile.mkdtemp(prefix="vrod_smoke_"))
    wall0 = time.perf_counter()
    try:
        K.reset_launches()
        db = Database.new(tmp, "smoke", devices=devices)
        col = db.create_collection("docs", dim=DIM, metric="cosine",
                                   dtype="int8", shards=SHARDS)
        ingest_s = 0.0
        for start in range(0, rows, INGEST_CHUNK):
            chunk = rng.standard_normal(
                (min(INGEST_CHUNK, rows - start), DIM), dtype=np.float32)
            t0 = time.perf_counter()
            col.bulk_insert(chunk)
            torch.cuda.synchronize()
            ingest_s += time.perf_counter() - t0
        eng = col.engine
        k_scan = eng.scan_widths(top_k)[1]
        ok, ns, blk = floor_gate(eng.rows_local, k_scan, eng.storage_dim,
                                 eng.dtype.itemsize, eng.quant,
                                 FloorSettings.from_env())
        if eng.shards != SHARDS or not ok:
            raise AssertionError(f"sharded: {eng.shards} shards, floor "
                                 f"{'open' if ok else 'closed'}")
        log(f"sharded: {SHARDS} shards on {[str(d) for d in devices]}, "
            f"capacity {eng.capacity}, {eng.rows_local} rows a shard; "
            f"floor open on every shard (k_scan {k_scan}, sample {ns} rows "
            f"in blocks of {blk}); ingest {rows / ingest_s:.1f} rows/s")
        col.search_similar(queries[0], top_k)  # warm-up
        sharded_round(col, queries, top_k, "sharded search", main["before"],
                      SHARDS)
        lat = []
        for qb in queries:
            t0 = time.perf_counter()
            eng.search(qb, top_k)
            lat.append(time.perf_counter() - t0)
        p50 = float(np.percentile(np.array(lat) * 1e3, 50))
        dev_ms, kernels = search_device_ms(eng, queries, top_k, "fast")
        main_dev, main_kernels = main["device"]
        log(f"sharded: {SEARCHES} x search_similar b{BATCH} top-{top_k} "
            f"equal to the one-shard main path's answers (ids and scores), "
            f"recall 1.0, K1 and K3 {SHARDS} launches each a search; "
            f"engine.search p50 {p50:.3f} ms (main path {main['p50_ms']:.3f}"
            f" ms, x{p50 / main['p50_ms']:.2f}), device time per search "
            f"{fmt_ms(dev_ms)} in {kernels:g} kernels (main path "
            f"{fmt_ms(main_dev)} in {main_kernels:g}) [{card}]")
        col.snapshot()
        gone = main["gone"]
        if col.delete_many(gone) != len(gone):
            raise AssertionError("sharded: delete_many deleted fewer ids")
        db.close()
        db = Database.load(tmp / "smoke", devices=devices)
        col = db.collection("docs")
        if col.engine.shards != SHARDS or col.count != rows - len(gone):
            raise AssertionError(f"sharded reopen: {col.engine.shards} "
                                 f"shards, count {col.count}")
        sharded_round(col, queries, top_k, "sharded reopened", main["after"],
                      SHARDS)
        db.close()
        torch.cuda.synchronize()
        launches = dict(K.launches)
        log(f"sharded: snapshot, delete {len(gone)}, reopen on {SHARDS} "
            f"shards: answers equal the main path's after its reopen; "
            f"launches {json.dumps({n: c for n, c in launches.items() if c})}"
            f"; {time.perf_counter() - wall0:.1f} s [{card}]")
        return launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()


def free_port() -> int:
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def mh_phase(card, seed):
    """Phase 8 (module docstring): MH_RANKS processes of this script
    (``--mh-rank``), each holding MH_SHARDS_PER_RANK shards of one row
    mesh. Returns each rank's launch counts; a failed rank fails the run."""
    tmp = Path(tempfile.mkdtemp(prefix="vrod_smoke_mh_"))
    port = free_port()
    wall0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--mh-rank",
         str(r), "--mh-port", str(port), "--mh-dir", str(tmp), "--seed",
         str(seed)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(MH_RANKS)]
    try:
        outs = [p.communicate(timeout=MH_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
        shutil.rmtree(tmp, ignore_errors=True)
    results = []
    for r, (p, out) in enumerate(zip(procs, outs)):
        for line in out.splitlines():
            if line.startswith(("vrod_tpu_torch.parallel:", "rank ")):
                log(f"  [rank {r}] {line}")
        if p.returncode != 0:
            raise AssertionError(f"rank {r} exited {p.returncode}:\n"
                                 f"{out[-4000:]}")
        res = [line for line in out.splitlines()
               if line.startswith("MH_RESULT ")]
        results.append(json.loads(res[-1][len("MH_RESULT "):]))
    for key in ("digest", "digest_reopened"):
        if len({res[key] for res in results}) != 1:
            raise AssertionError(f"ranks answered differently ({key}: "
                                 f"{[res[key] for res in results]})")
    for r, res in enumerate(results):
        if not res["launches"].get("fused_topk[int8-cosine]"):
            raise AssertionError(f"rank {r} launched no K1")
    log(f"two processes: {MH_RANKS} ranks x {MH_SHARDS_PER_RANK} shards, "
        f"backend {results[0]['backend']}, {MH_ROWS} rows: equal answers "
        f"on every rank before and after the collective snapshot and "
        f"reload, recall 1.0; search p50 by rank "
        f"{[round(res['p50_ms'], 3) for res in results]} ms; "
        f"{time.perf_counter() - wall0:.1f} s [{card}]")
    return [res["launches"] for res in results]


def mh_worker(rank, port, workdir, seed) -> int:
    """One rank of phase 8: joins the group, then runs the same program
    as every other rank (SPMD) on its own database directory."""
    import hashlib
    import os
    import torch
    os.environ.update(VROD_COORDINATOR=f"127.0.0.1:{port}",
                      VROD_NUM_PROCESSES=str(MH_RANKS),
                      VROD_PROCESS_ID=str(rank))
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from vrod_tpu_torch import Database
    from vrod_tpu_torch.config import CollectionConfig
    from vrod_tpu_torch.engine import DeviceEngine
    from vrod_tpu_torch.ops import cuda_topk as K
    from vrod_tpu_torch.parallel import distributed
    distributed.initialize()
    own = distributed.local_device()
    devices = distributed.global_devices([own] * MH_SHARDS_PER_RANK)
    top_k = 16
    rng = np.random.default_rng(seed)
    queries = [rng.standard_normal((BATCH, DIM), dtype=np.float32)
               for _ in range(MH_SEARCHES)]
    K.reset_launches()
    db = Database.new(Path(workdir) / f"rank{rank}", "mh", devices=devices)
    col = db.create_collection("docs", dim=DIM, metric="cosine",
                               dtype="int8", shards=len(devices))
    if not col.engine.multiprocess or col.engine.shards != len(devices):
        raise AssertionError("the collection does not span the ranks")
    # The oracle's state: the same rows in a one-shard engine of this rank.
    ref = DeviceEngine(CollectionConfig(name="ref", dim=DIM,
                                        metric="cosine", dtype="int8"),
                       device=own)
    ref.ensure_capacity(MH_ROWS)
    ids = []
    for start in range(0, MH_ROWS, INGEST_CHUNK):
        chunk = rng.standard_normal((min(INGEST_CHUNK, MH_ROWS - start),
                                     DIM), dtype=np.float32)
        ids.append(col.bulk_insert(chunk))
        ref.write(ids[-1].astype(np.int64) - 1, chunk)
    ids = np.concatenate(ids)

    def run(what, gone=()):
        out, lat = [], []
        for b, q in enumerate(queries):
            t0 = time.perf_counter()
            hits = col.search_similar(q, top_k)
            lat.append(time.perf_counter() - t0)
            check_hits(hits, oracle_kth(ref, q, top_k), "cosine", top_k,
                       f"rank {rank} {what} {b}")
            got = [[(h.record_id, h.score) for h in hs] for hs in hits]
            if any(r in gone for hs in got for r, _ in hs):
                raise AssertionError(f"rank {rank}: a deleted id came back")
            out.append(got)
        digest = hashlib.sha256(json.dumps(out).encode()).hexdigest()
        return digest, float(np.percentile(np.array(lat) * 1e3, 50))

    digest, p50 = run("search")
    gone = rng.choice(ids, N_DELETE, replace=False)
    if col.delete_many(gone.tolist()) != N_DELETE:
        raise AssertionError(f"rank {rank}: delete_many deleted fewer ids")
    ref.erase(gone.astype(np.int64) - 1)
    col.snapshot()
    db.close()
    db = Database.load(Path(workdir) / f"rank{rank}" / "mh", devices=devices)
    col = db.collection("docs")
    if not col.engine.multiprocess or col.count != MH_ROWS - N_DELETE:
        raise AssertionError(f"rank {rank}: reload count {col.count}")
    digest2, _ = run("reloaded", set(gone.tolist()))
    db.close()
    torch.cuda.synchronize()
    launches = {n: c for n, c in K.launches.items() if c}
    print(f"rank {rank}: {len(devices)} shards, launches "
          f"{json.dumps(launches)}", flush=True)
    print("MH_RESULT " + json.dumps({
        "digest": digest, "digest_reopened": digest2, "p50_ms": p50,
        "backend": distributed.backend(), "launches": launches}),
        flush=True)
    distributed.shutdown()
    return 0


def launch_delta(before):
    """Launches since the counts ``before`` (a dict of K.launches)."""
    from vrod_tpu_torch.ops import cuda_topk as K
    return {n: c - before.get(n, 0) for n, c in K.launches.items()
            if c - before.get(n, 0)}


def need_kernels(delta, what, leg="int8-cosine"):
    for kern in ("fused_topk", "sampled_submax"):
        if not delta.get(f"{kern}[{leg}]"):
            raise AssertionError(f"{what}: launched no {kern}[{leg}]")


def filtered_round(col, queries, ids, mode, what):
    """Filtered ``search_similar`` of every batch at VERB_TOP_K: K1 and K3
    rise with each; no id outside the filter; recall 1.0 against the exact
    float32 scan over only the admitted rows. Returns (mask build ms,
    per-batch latencies in s)."""
    import torch
    from vrod_tpu_torch.ops import cuda_topk as K
    eng = col.engine
    t0 = time.perf_counter()
    slots = col.alloc.slots_of(np.asarray(ids, np.uint64)).astype(np.int64)
    mask = eng.filter_mask_from_slots(slots, mode=mode)
    torch.cuda.synchronize(eng.device)
    mask_ms = (time.perf_counter() - t0) * 1e3
    admitted = eng.valid & mask
    idset = set(np.asarray(ids).tolist())
    lat = []
    kw = {"within_ids" if mode == "within" else "exclude_ids": ids}
    for b, q in enumerate(queries):
        n0 = dict(K.launches)
        t0 = time.perf_counter()
        hits = col.search_similar(q, VERB_TOP_K, **kw)
        lat.append(time.perf_counter() - t0)
        need_kernels(launch_delta(n0), f"{what} {b}")
        for hs in hits:
            inside = [h.record_id in idset for h in hs]
            outside = not all(inside) if mode == "within" else any(inside)
            if outside:
                raise AssertionError(f"{what} {b}: an id outside the "
                                     f"{mode} filter")
        check_hits(hits, oracle_kth(eng, q, VERB_TOP_K,
                                    (eng.x, eng.aux, admitted)),
                   "cosine", VERB_TOP_K, f"{what} {b}")
    return mask_ms, lat


def verbs_phase(card, main, seed):
    """Phase 9 (module docstring): filtered SEARCHSIMILAR, top-100, REINDEX
    and BACKUP on the main path's reopened collection, then the fuzz
    streams on the card. Closes the main path's database (the caller
    removes its directory). Returns its launch counts."""
    import torch
    from vrod_tpu_torch import Database
    from vrod_tpu_torch.commands.builder import CommandBuilder
    from vrod_tpu_torch.ops import cuda_topk as K
    from vrod_tpu_torch.verify_image import verify_image
    db, tmp = main["db"], main["dir"]
    wall0 = time.perf_counter()
    try:
        col = db.collection("docs")
        eng = col.engine
        dev = eng.device
        rng = np.random.default_rng(seed)
        queries = [rng.standard_normal((BATCH, DIM), dtype=np.float32)
                   for _ in range(VERB_BATCHES)]
        live = col.alloc.ids_of(col.alloc.live_slots().astype(np.uint64))
        K.reset_launches()

        # (a) filtered SEARCHSIMILAR
        n0 = dict(K.launches)
        col.search_similar(queries[0], VERB_TOP_K)  # warm-up
        lat = []
        for q in queries:
            t0 = time.perf_counter()
            col.search_similar(q, VERB_TOP_K)
            lat.append(time.perf_counter() - t0)
        p50 = {"unfiltered": float(np.percentile(lat, 50)) * 1e3}
        within = rng.choice(live, FILTER_IDS, replace=False)
        exclude = rng.choice(live, FILTER_IDS, replace=False)
        mask_ms = {}
        for mode, ids in (("within", within), ("exclude", exclude)):
            mask_ms[mode], lat = filtered_round(
                col, queries, ids, mode, f"filtered {mode}")
            p50[mode] = float(np.percentile(lat, 50)) * 1e3
        q0 = queries[0][0]
        arg = (",".join(repr(float(v)) for v in q0) + f";k={VERB_TOP_K}"
               + ";within=" + ",".join(str(int(i)) for i in within))
        out = CommandBuilder(db).build("docs", "SEARCHSIMILAR",
                                       arg).execute()
        verb_ids = [int(line.split("\t")[0]) for line in out.splitlines()]
        api_ids = [h.record_id for h in
                   col.search_similar(q0, VERB_TOP_K, within_ids=within)]
        if verb_ids != api_ids:
            raise AssertionError(f"SEARCHSIMILAR ;within=: {verb_ids} vs "
                                 f"search_similar {api_ids}")
        a_counts = launch_delta(n0)
        need_kernels(a_counts, "(a)")
        log(f"verbs (a): {VERB_BATCHES} x b{BATCH} top-{VERB_TOP_K} within "
            f"{FILTER_IDS} ids and excluding {FILTER_IDS}: recall 1.0 "
            f"against the exact scan of the admitted rows, no id outside "
            f"the filter; the ;within= verb answered as search_similar; "
            f"mask build {mask_ms['within']:.3f} / {mask_ms['exclude']:.3f}"
            f" ms; search_similar p50 within {p50['within']:.3f} ms, "
            f"exclude {p50['exclude']:.3f} ms, unfiltered "
            f"{p50['unfiltered']:.3f} ms [{card}]")

        # (b) int8 cosine top-100 at the policy's k_scan
        n0 = dict(K.launches)
        search_round(col, queries, "int8-cosine", VERB_TOP_K_WIDE,
                     "top-100")
        need_kernels(launch_delta(n0), "(b)")
        log(f"verbs (b): {VERB_BATCHES} x b{BATCH} top-{VERB_TOP_K_WIDE} "
            f"at k_scan {eng.scan_widths(VERB_TOP_K_WIDE)[1]}: recall 1.0")

        # (c) delete, then REINDEX
        gone = rng.choice(live, REINDEX_DELETE, replace=False)
        if col.delete_many(gone) != REINDEX_DELETE:
            raise AssertionError("delete_many deleted fewer ids")
        n0 = dict(K.launches)
        before = search_round(col, queries, "int8-cosine", VERB_TOP_K,
                              "before REINDEX")
        kept = col.alloc.ids_of(col.alloc.live_slots().astype(np.uint64))
        slots0 = col.alloc.slots_of(kept)
        cap0 = eng.capacity
        t0 = time.perf_counter()
        moved = col.reindex()
        torch.cuda.synchronize(dev)
        reindex_s = time.perf_counter() - t0
        rebound = int((col.alloc.slots_of(kept) != slots0).sum())
        if moved < 1 or rebound < 1 or col.engine.capacity >= cap0:
            raise AssertionError(f"REINDEX moved {moved} rows ({rebound} "
                                 f"rebound), capacity {cap0} -> "
                                 f"{col.engine.capacity}")
        after = search_round(col, queries, "int8-cosine", VERB_TOP_K,
                             "after REINDEX")
        gone_set = set(gone.tolist())
        for b, (bq, aq) in enumerate(zip(before, after)):
            if any(r in gone_set for hs in aq for r, _ in hs):
                raise AssertionError("REINDEX: a deleted id came back")
            if bq != aq:
                raise AssertionError(f"REINDEX changed batch {b}'s answers")
        need_kernels(launch_delta(n0), "(c)")
        log(f"verbs (c): deleted {REINDEX_DELETE}, REINDEX moved {moved} "
            f"rows, capacity {cap0} -> {col.engine.capacity}, in "
            f"{reindex_s:.3f} s; the same ids and scores before and after, "
            f"no deleted id [{card}]")

        # (d) BACKUP, verify_image, load the image on the card
        dest = tmp / "backup"
        t0 = time.perf_counter()
        stats = db.backup(dest)
        backup_s = time.perf_counter() - t0
        report = verify_image(dest)
        if not report["ok"]:
            raise AssertionError(f"verify_image: {report}")
        n0 = dict(K.launches)
        t0 = time.perf_counter()
        db2 = Database.load(dest, device=dev)
        col2 = db2.collection("docs")
        torch.cuda.synchronize(dev)
        load_s = time.perf_counter() - t0
        if col2.count != col.count:
            raise AssertionError(f"backup count {col2.count} vs "
                                 f"{col.count}")
        restored = search_round(col2, queries, "int8-cosine", VERB_TOP_K,
                                "backup loaded")
        db2.close()
        if restored != after:
            raise AssertionError("the backup's answers differ")
        need_kernels(launch_delta(n0), "(d)")
        log(f"verbs (d): BACKUP of {col.count} rows ({stats}) in "
            f"{backup_s:.3f} s, verify_image ok, Database.load of the image "
            f"on {dev} in {load_s:.3f} s, its answers equal the source's "
            f"[{card}]")
        db.close()

        # (e) the fuzz streams on the card
        t0 = time.perf_counter()
        tool_module("fuzz_backup").run_seed(FUZZ_BACKUP_SEED)
        tool_module("fuzz_cold_count").run_seed(FUZZ_COLD_SEED)
        fm = tool_module("fuzz_model")
        for i in FUZZ_MODEL_CONFIGS:
            seed_i, cfg_kw = fm.CONFIGS[i]
            with tempfile.TemporaryDirectory(prefix="vrod_fuzz_") as td:
                cols, model = fm.run_stream(
                    [fm.port_opens(td, cfg_kw, device=dev)], seed_i)
                if cols[0].engine.x.device.type != dev.type:
                    raise AssertionError("the model stream left the card")
                for c in cols:
                    c.close()
        torch.cuda.synchronize(dev)
        launches = dict(K.launches)
        log(f"verbs (e): fuzz_backup seed {FUZZ_BACKUP_SEED}, fuzz_cold_count "
            f"seed {FUZZ_COLD_SEED} and the model stream "
            f"{[fm.CONFIGS[i] for i in FUZZ_MODEL_CONFIGS]} on {dev}: ok in "
            f"{time.perf_counter() - t0:.1f} s")
        log(f"verbs: launches "
            f"{json.dumps({n: c for n, c in launches.items() if c})}; "
            f"{time.perf_counter() - wall0:.1f} s [{card}]")
        return launches
    finally:
        torch.cuda.empty_cache()


def run_tool(argv, what, cwd=None):
    """One of the repo's programs (a ``tools/`` script or an example) in a
    process of its own on ``cuda:0``: its standard output; a non-zero exit
    fails the phase."""
    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root), VROD_PLATFORM="cuda")
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, *argv], cwd=cwd or root, env=env,
                         capture_output=True, text=True,
                         timeout=TOOL_TIMEOUT_S)
    if out.returncode != 0:
        raise AssertionError(f"{what} exited {out.returncode}:\n"
                             f"{out.stdout[-3000:]}\n{out.stderr[-5000:]}")
    log(f"  {what}: {time.perf_counter() - t0:.1f} s")
    return out.stdout


def tool_summary(stdout, what):
    """The JSON summary a tool prints as its last line, ``ok`` true; printed
    on a line of its own."""
    summary = json.loads(stdout.strip().splitlines()[-1])
    if summary.get("ok") is not True:
        raise AssertionError(f"{what}: not ok: {summary}")
    print(json.dumps(summary), flush=True)
    return summary


def device_mib(memory):
    """(max allocated, max reserved) MiB of a drill process's memory."""
    return tuple(round(memory[f"device_max_{k}_bytes"] / 2 ** 20, 1)
                 for k in ("allocated", "reserved"))


def need_launches(launches, kernels, what):
    for name in kernels:
        if not launches.get(name):
            raise AssertionError(f"{what}: launched no {name}")


def tools_phase(card):
    """Phase 10 (module docstring): the repo's tools and examples on the
    card, each in its own process: ``tools/filter_bench.py`` (bfloat16,
    then int8), ``tools/soak_serve.py`` (in the background, beside) the
    three port examples and ``tools/repl_drill.py`` at DRILL_ROWS. Prints
    the search kernels' launches in the tools' processes, counted apart."""
    import torch
    torch.cuda.empty_cache()
    log(f"phase 10: the tools and examples, each a process on cuda:0 "
        f"[{card}]")
    launches = {}

    def count(summary):
        for name, c in summary["launches"].items():
            launches[name] = launches.get(name, 0) + c

    for dtype, kernels in (
            ("bfloat16", ["fused_topk[bf16-cosine]"]),
            ("int8", ["fused_topk[int8-cosine]",
                      "sampled_submax[int8-cosine]"])):
        fb = tool_summary(run_tool(
            ["tools/filter_bench.py", "--dtype", dtype],
            f"filter_bench {dtype}"), f"filter_bench {dtype}")
        need_launches(fb["launches"], kernels, f"filter_bench {dtype}")
        count(fb)
        log(f"  filter_bench {dtype} {fb['rows']:,} x {fb['dim']} b"
            f"{fb['batch']} top-{fb['k']}: p50 unfiltered / exclude "
            f"{fb['excluded']:,} / within {fb['within']:,} = "
            f"{' / '.join(f'{v:.3f}' for v in fb['p50_ms'])} ms, window "
            f"means {' / '.join(f'{v:.3f}' for v in fb['latency_ms'])} ms; "
            f"mask {fb['mask_build_ms']:.3f} ms (first "
            f"{fb['mask_build_cold_ms']:.3f}) [{card}]")

    root = Path(__file__).resolve().parent
    soak_out = tempfile.TemporaryFile(mode="w+")
    soak = subprocess.Popen(
        [sys.executable, "tools/soak_serve.py", "--minutes",
         str(SOAK_MINUTES)], cwd=root, stdout=soak_out,
        stderr=subprocess.DEVNULL,
        env=dict(os.environ, PYTHONPATH=str(root), VROD_PLATFORM="cuda"))
    try:
        with tempfile.TemporaryDirectory() as tmp:
            cpu_quick = subprocess.run(
                [sys.executable, str(root / "examples/torch_quickstart.py")],
                cwd=tmp, capture_output=True, text=True, check=True,
                timeout=TOOL_TIMEOUT_S, env=dict(
                    os.environ, PYTHONPATH=str(root), VROD_PLATFORM="cpu"))
            quick = run_tool([str(root / "examples/torch_quickstart.py")],
                               "examples/torch_quickstart.py", cwd=tmp)
            lines = quick.splitlines()
            if (lines[:1] != ["Inserted 18 records"]
                    or "recall check: 1.0" not in lines[-1]
                    or lines != cpu_quick.stdout.splitlines()):
                raise AssertionError(f"quickstart printed {lines}, on the "
                                     f"CPU {cpu_quick.stdout.splitlines()}")
            serving = run_tool([str(root / "examples/torch_serving.py")],
                                 "examples/torch_serving.py", cwd=tmp)
            if not (serving.startswith("served ") and "from 8 clients" in
                    serving and "packed batches" in serving
                    and "auto-snapshots: " in serving):
                raise AssertionError(f"serving printed {serving!r}")
            repl = run_tool([str(root / "examples/torch_replication.py")],
                              "examples/torch_replication.py", cwd=tmp)
            for want in ("read-your-writes through the pool: Hit(501, "
                         "1.000000, 'fresh-write')", "fenced:",
                         "promoted:", "replica promoted; first write on "
                         "the new primary: id 502"):
                if want not in repl:
                    raise AssertionError(f"replication printed {repl!r}")
            if repl.splitlines()[-1] != "done":
                raise AssertionError(f"replication printed {repl!r}")
            for out in (quick, serving, repl):
                for line in out.splitlines():
                    log(f"    {line}")
        drill = tool_summary(run_tool(
            ["tools/repl_drill.py", "--rows", str(DRILL_ROWS),
             "--tail-rows", str(DRILL_TAIL_ROWS)], "repl_drill"),
            "repl_drill")
        log(f"  repl_drill {drill['rows']:,} x {drill['dim']} int8 (the depth"
            f" cut of 10M), tail {drill['tail_rows']:,}: ingest "
            f"{drill['ingest_rows_per_s']:,.0f} rows/s, snapshot "
            f"{drill['snapshot_gb_per_s']:.3f} GB/s, bootstrap "
            f"{drill['times']['bootstrap_s']:.1f} s, resume "
            f"{drill['times']['resume_s']:.1f} s with no bootstrap or "
            f"resync, {drill['verified_records']} records bit-identical; "
            f"device max allocated / reserved MiB "
            f"{ {n: device_mib(m) for n, m in drill['memory'].items()} }, "
            f"card memory.used by phase {drill['card_used_peak_mb']} "
            f"[{card}]")
        soak.wait(timeout=SOAK_MINUTES * 60 + TOOL_TIMEOUT_S)
    finally:
        if soak.poll() is None:
            soak.kill()
            soak.wait(timeout=60)
    soak_out.seek(0)
    text = soak_out.read()
    soak_out.close()
    if soak.returncode != 0:
        raise AssertionError(f"soak_serve exited {soak.returncode}: {text}")
    sk = tool_summary(text, "soak_serve")
    need_launches(sk["launches"], ["fused_topk[int8-cosine]"], "soak_serve")
    count(sk)
    log(f"  soak_serve {sk['wall_s']} s: {sk['searches']:,} searches "
        f"({sk['qps']:.1f}/s), {sk['mutations']:,} mutations, errors "
        f"{sk['errors']}, fds {sk['fd_start']} -> {sk['fd_end']}; device "
        f"allocated peak {sk['dev_alloc_peak_mb']:.1f} MiB, end "
        f"{sk['dev_alloc_end_mb']:.1f}; the RSS and device-memory plateau "
        f"is judged from the 2-minute mark, which a "
        f"{SOAK_MINUTES * 60:.0f} s soak does not reach [{card}]")
    log(f"phase 10 launches (counted apart): {json.dumps(launches)}")


def check_bench_line(line, what, card):
    """A bench_torch line as phase 11 requires it (module docstring)."""
    extra = line.get("extra") or {}
    recalls = [p["recall_full_scan@k"]
               for p in extra.get("curve", {}).values()]
    if "recall_full_scan@k" in extra:
        recalls.append(extra["recall_full_scan@k"])
    faults = []
    if "error" in line or not line.get("value") or line["value"] <= 0:
        faults.append("no value")
    if extra.get("card") != card:
        faults.append(f"card {extra.get('card')!r}")
    if any(r != 1.0 for r in recalls):
        faults.append(f"recall {recalls}")
    if what == "mixed" and extra.get("final_count") != MIXED_QUICK_COUNT:
        faults.append(f"final_count, want {MIXED_QUICK_COUNT}")
    kernels = ["fused_topk"] + (["sampled_submax"] if what == "headline"
                                else [])
    for kern in kernels:
        if not any(n.startswith(kern + "[") for n in
                   extra.get("launches", {})):
            faults.append(f"launched no {kern}")
    if faults:
        raise AssertionError(f"bench_torch {what}: {'; '.join(faults)}: "
                             f"{json.dumps(line)}")


def host_syncs():
    """The synchronizing calls of one warm headline search (bench_torch's
    engine, fill and queries; 3 searches before) under
    ``torch.cuda.set_sync_debug_mode("warn")``: {where: count}, where
    naming the innermost line of this checkout on the call's stack, its
    source, and the line outside the checkout that made the call. A
    control must show: a one-slot readback of a result is one such call."""
    import linecache
    import traceback
    import warnings
    import torch
    import bench_torch
    root = Path(__file__).resolve().parent
    eng = bench_torch.build_engine(1_000_000, DIM, "cosine", "int8")
    q = bench_torch.staged_queries(BATCH, DIM, eng.device)
    for _ in range(3):
        _, idx = eng.search(q, 16, as_numpy=False)
    torch.cuda.synchronize()

    def syncs(fn):
        sites = {}

        def seen(message, category, filename, lineno, file=None,
                 line=None):
            if "called a synchronizing CUDA operation" not in str(message):
                return
            ours = [f for f in traceback.extract_stack(sys._getframe(1))
                    if Path(f.filename).is_relative_to(root)][-1]
            path = Path(ours.filename).relative_to(root)
            src = linecache.getline(ours.filename, ours.lineno).strip()
            where = (f"{path}:{ours.lineno} ({src}), via "
                     f"{Path(filename).parent.name}/{Path(filename).name}:"
                     f"{lineno}")
            sites[where] = sites.get(where, 0) + 1

        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = seen
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return sites

    found = syncs(lambda: eng.search(q, 16, as_numpy=False))
    control = syncs(lambda: idx[0, :1].cpu())
    if sum(control.values()) != 1:
        raise AssertionError(f"sync debug mode saw {control} for one "
                             "readback")
    del eng, idx
    torch.cuda.empty_cache()
    return found


def bench_phase(card):
    """Phase 11 (module docstring): bench_torch.py's runs, each a process
    on cuda:0, then the headline search's host syncs."""
    import torch
    torch.cuda.empty_cache()
    log(f"phase 11: bench_torch.py, each run a process on cuda:0 [{card}]")
    launches = {}
    for what, argv in BENCH_RUNS:
        out = run_tool(["bench_torch.py", *argv], f"bench_torch {what}")
        line = json.loads(out.strip().splitlines()[-1])
        print(json.dumps(line), flush=True)
        check_bench_line(line, what, card)
        for name, c in line["extra"]["launches"].items():
            launches[name] = launches.get(name, 0) + c
    log(f"phase 11 launches (counted apart): {json.dumps(launches)}")
    sites = host_syncs()
    log(f"phase 11: one warm headline search under sync debug mode made "
        f"{sum(sites.values())} synchronizing calls [{card}]")
    for where, n in sites.items():
        log(f"  {n} x {where}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--rows", type=int, default=1_000_000,
                   help="rows of the main path, phases (i)-(iv) and phase 7 "
                   "(default 1M)")
    p.add_argument("--seed", type=int, default=0)
    # Phase 8 starts this script once a rank with these.
    p.add_argument("--mh-rank", type=int, help=argparse.SUPPRESS)
    p.add_argument("--mh-port", type=int, help=argparse.SUPPRESS)
    p.add_argument("--mh-dir", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.mh_rank is not None:
        return mh_worker(args.mh_rank, args.mh_port, args.mh_dir, args.seed)
    if args.rows < SHARDED_MIN_ROWS:
        p.error(f"below {SHARDED_MIN_ROWS:,} rows phase 7's shards hold "
                "fewer than 262,144 rows each, where the sampled floor's "
                "gate closes, so K3 would not run on that path")

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
                                   "arning", "wgmma", "nvcc ")):
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
    times, floors, extracts, main_path = {}, [], [], {}
    for i, (name, leg, top_k, rows, reopen) in enumerate(phases):
        n, t, floor, extract, served = db_phase(
            dev, card, cmp, name=name, leg=leg, top_k=top_k, rows=rows,
            searches=LEG_SEARCHES if name.startswith("leg") else SEARCHES,
            reopen=reopen, seed=args.seed + 10 + i,
            floor_kscans=FLOOR_KSCANS.get(name, ()),
            extract_kscans=EXTRACT_KSCANS.get(name, ()),
            serve=name == "main path",
            keep=main_path if name == "main path" else None)
        for kname, c in list(n.items()) + list((served or {}).items()):
            launches[kname] += c
        times.setdefault(leg, (name, rows, t))  # the first, largest phase
        if floor:
            floors.append((name, leg, floor))
        if extract:
            extracts.append((name, leg, extract))
    # Phases 7 and 8: their launches join the totals, each path's read in
    # its own run (phase 8's in each rank's process).
    try:
        sharded = shard_phase(card, main_path, rows=args.rows,
                              seed=args.seed + 10)
        ranks = mh_phase(card, args.seed + 30)
        verbs = verbs_phase(card, main_path, args.seed + 40)
    finally:
        shutil.rmtree(main_path["dir"], ignore_errors=True)
    tools_phase(card)
    bench_phase(card)
    for n in [sharded] + ranks + [verbs]:
        for kname, c in n.items():
            launches[kname] += c
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
    for name, leg, (fl, _, ftimes) in floors:
        for kern, t in ftimes.items():
            kname = f"{kern}[{leg}]"
            bound_ms, bound_by = t["bound"]
            log(f"{kname}: {fl[kname]} launches in {name}'s floor "
                f"experiments; at its shapes ({t['rows']} rows, k_scan "
                f"{t['k_scan']}) {t['ms']:.4f} ms (device "
                f"{t['device_ms']:.4f} ms, {t['kernels']:g} kernels a call) "
                f"vs plain {t['plain_ms']:.4f} ms, bound {bound_ms:.4f} ms "
                f"({bound_by}; {reached(bound_ms, t)}); stock composition "
                f"{t['stock_ms']:.4f} ms "
                f"(device {t['stock_device_ms']:.4f}); max abs err vs plain "
                f"{cmp.max_err[kname]:.6g}, at most "
                f"{cmp.max_share[kname]:.4g} of the score bound [{card}]")
            kernels.append({
                "name": kname, "route": "cuda", "source": SOURCES[kern][0],
                "replaces": SOURCES[kern][1], "launches": fl[kname],
                "max_abs_err": cmp.max_err[kname], "ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": None,
                "stock_ms": t["stock_ms"]})
    from vrod_tpu_torch.ops import cuda_extract as X
    for name, leg, (xl, _, xtimes) in extracts:
        for kern, t in xtimes.items():
            kname = f"extract_{kern}[{leg}]"
            fn = X.KERNEL_CALLS[kern][0]
            bound_ms, bound_by = t["bound"]
            log(f"{kname}: {xl[kname]} launches in {name}'s extraction "
                f"experiments; at its shapes ({t['rows']} rows, k_scan "
                f"{t['k_scan']}, blocks of {EXTRACT_BLOCK}) {t['ms']:.4f} ms "
                f"(device {t['device_ms']:.4f} ms, {t['kernels']:g} kernels "
                f"a call) vs plain {t['plain_ms']:.4f} ms, bound "
                f"{bound_ms:.4f} ms ({bound_by}; {reached(bound_ms, t)}); "
                f"K1 with no floor {t['k1_ms']:.4f} ms (device "
                f"{t['k1_device_ms']:.4f}); max abs err vs plain "
                f"{cmp.max_err[kname]:.6g}, at most "
                f"{cmp.max_share[kname]:.4g} of the score bound [{card}]")
            kernels.append({
                "name": kname, "route": "cuda",
                "source": f"vrod_tpu_torch/csrc/extract_"
                          f"{X.KERNELS[kern][0]}.cu",
                "replaces": f"experiments/{fn}.py:{EXTRACT_PALLAS_LINE[fn]}",
                "launches": xl[kname],
                "max_abs_err": cmp.max_err[kname], "ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": None,
                "k1_ms": t["k1_ms"]})
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
