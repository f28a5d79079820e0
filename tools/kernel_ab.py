#!/usr/bin/env python3
"""Time K1, K3 and ``engine.search`` of one or more trees of the port on one
GPU, in turns, at the shapes of every ``chip_smoke.py`` phase.

    python tools/kernel_ab.py TREE [TREE ...] [--ring 2,3,4] [--profile]
        [--library] [--phases "main path,(iii)"] [--out FILE]

Each TREE is the root of a checkout that holds ``vrod_tpu_torch/`` (for
instance an unpacked ``git archive`` of the parent commit, and ``.``). Each
runs in a process of its own, in the order given, so an A/B reads
``PARENT . . PARENT``. Per phase it builds a device engine directly from
seeded random normal rows (no WAL; the capacity is padded with dead slots
to whole 65,536-row segments, as a collection's is), then times, with CUDA
events after a warm-up, K1 (``fused_topk``) and K3 (``sampled_submax``) on
exactly the inputs a search gives them (mean of 20 launches), their
device time per call (torch.profiler's CUDA kernel time over 5 calls:
what the card spends, without the wrapper's host work), and
``engine.search`` (host clock, median of 20 batches of 256 queries).

At the main path's shapes it also times K1 without the floor (theta0
None), as a search whose floor gate is closed runs it.
``--ring 2,3,4``: the main path's K1 built at each ring depth
(``-DVROD_K1_RING=N``, a library beside the default one) and timed in
turns (2, 3, 4, 4, 3, 2), in trees whose ``cuda_topk`` has
``_topk_cuda`` (the launch from a given library).
``--profile``: a torch.profiler trace of 10 main-path ``engine.search``
calls, summed by kernel (device time per search, and the device's idle
share of the unprofiled search p50).
``--phases``: only the phases named (comma-separated), e.g. ``main
path,(iii)``.
``--library``: per phase also the kernels' bounds and the two-call library
yardsticks, computed and timed by ``chip_smoke.py``'s own functions
(``bound_of``, ``library_times``) from this file's checkout.

Prints one JSON object per line and writes them all to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

DIM, BATCH, ITERS, SEARCHES = 768, 256, 20, 20
SEGMENT = 65536
DB_DTYPE = {"int8": "int8", "int4": "int4", "bf16": "bfloat16",
            "f32": "float32"}
PHASES = [("main path", "int8-cosine", 16, 1_000_000),
          ("(i)", "int8-l2", 16, 1_000_000),
          ("(ii)", "int4-l2", 16, 1_000_000),
          ("(iii)", "bf16-cosine", 100, 1_000_000),
          ("(iv)", "f32-dot", 100, 1_000_000)]
for _d in ("int8", "int4", "bf16", "f32"):
    for _m in ("cosine", "dot", "l2"):
        _quant = _d in ("int8", "int4")
        PHASES.append((f"leg {_d}-{_m}", f"{_d}-{_m}", 16 if _quant else 100,
                       262144 if _quant else 131072))


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


def events_ms(fn, iters=ITERS, warmup=3) -> float:
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


def make_engine(leg, rows, seed, dev):
    """A DeviceEngine of the tree on ``sys.path`` holding ``rows`` seeded
    random normal rows of one leg, capacity padded to whole segments."""
    import torch
    from vrod_tpu_torch.engine import DeviceEngine
    from vrod_tpu_torch.ops import distances as D
    dtype, metric = leg.split("-")
    cfg = SimpleNamespace(name="ab", dim=DIM, metric=metric,
                          dtype=DB_DTYPE[dtype], segment_rows=SEGMENT,
                          shards=1, rescore_margin=8)
    eng = DeviceEngine(cfg, device=dev)
    cap = -(-rows // SEGMENT) * SEGMENT
    x = torch.zeros((cap, eng.storage_dim), dtype=eng.dtype, device=dev)
    aux = torch.zeros(cap, dtype=torch.float32, device=dev)
    valid = torch.zeros(cap, dtype=torch.bool, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    kind = "int4" if dtype == "int4" else eng.dtype
    for lo in range(0, rows, SEGMENT):
        hi = min(rows, lo + SEGMENT)
        v = torch.randn((hi - lo, DIM), generator=gen, device=dev)
        x[lo:hi], aux[lo:hi] = D.prepare_rows(v, metric=metric, dtype=kind)
    valid[:rows] = True
    eng.load_state(x, aux, valid)
    return eng


def kernel_inputs(eng, q, k_scan):
    """(K1 args, K1 keywords, K3 args, K3 keywords) of one search, as
    ``DeviceEngine._scan`` builds them (the floor gate must be open)."""
    from vrod_tpu_torch import engine as E
    from vrod_tpu_torch.engine import floor_gate, floor_threshold
    from vrod_tpu_torch.ops import cuda_topk as K
    from vrod_tpu_torch.ops import distances as D
    metric = eng.cfg.metric
    # Trees older than the floor's environment settings take no ``fs``.
    fs = dict(fs=E.FloorSettings.from_env()) \
        if hasattr(E, "FloorSettings") else {}
    q_scan, extras = eng.scan_inputs(q, D.prepare_queries(q, metric=metric))
    ok, ns, blk = floor_gate(eng.capacity, k_scan, eng.storage_dim,
                             eng.x.element_size(), eng.quant, **fs)
    assert ok, "floor gate closed"
    kw3 = dict(extras)
    if "row_bias" in kw3:
        kw3["row_bias"] = kw3["row_bias"][:ns]
    a3 = [eng.x[:ns], eng.aux[:ns], eng.valid[:ns], q_scan]
    kw3.update(metric=metric, block_rows=blk)
    sub = K.sampled_submax(*a3, **kw3)
    theta0 = floor_threshold(sub, k_scan, q_scan, eng.aux, eng.valid,
                             metric=metric, quant=eng.quant,
                             dim=eng.storage_dim, **fs)
    a1 = [eng.x, eng.aux, eng.valid, q_scan]
    kw1 = dict(k=k_scan, metric=metric, theta0=theta0, **extras)
    return a1, kw1, a3, kw3, (ns, blk)


def device_ms(fn, calls=5) -> tuple[float, float]:
    """(CUDA kernel time per call, kernels per call) of ``fn`` by
    torch.profiler, warm."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total, count = 0.0, 0
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA:
            total += getattr(ev, "self_device_time_total",
                             getattr(ev, "self_cuda_time_total", 0))
            count += ev.count
    return total / 1e3 / calls, count / calls


def profile_search(eng, queries, top_k, p50_ms):
    """Device time per main-path search by kernel, from torch.profiler;
    the idle share is taken against the unprofiled search p50 (tracing
    slows the host)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for qb in queries[:3]:
        eng.search(qb, top_k)
    torch.cuda.synchronize()
    n = 10
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for qb in queries[:n]:
            eng.search(qb, top_k)
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        # Kernels only: an aten op's entry repeats its kernels' time.
        if ev.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0)
        if dev_us > 0:
            rows.append((ev.key, dev_us / 1e3 / n, ev.count / n))
    rows.sort(key=lambda r: -r[1])
    total = sum(r[1] for r in rows)
    return {"device_ms_per_search": total,
            "idle_share_vs_p50": 1.0 - total / p50_ms,
            "kernels": [{"name": k[:120], "ms_per_search": ms,
                         "calls_per_search": c} for k, ms, c in rows[:25]]}


def smoke_module():
    """``chip_smoke.py`` of the checkout that holds this file."""
    import importlib.util
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_ab", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_tree(tree: str, rings, profile: bool, library: bool,
             phases=()) -> list[dict]:
    smoke = smoke_module() if library else None
    sys.path.insert(0, str(Path(tree).resolve()))
    import numpy as np
    import torch
    from vrod_tpu_torch.ops import _build
    from vrod_tpu_torch.ops import cuda_topk as K
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    t0 = time.perf_counter()
    _build.load()
    out = [{"tree": tree, "build_s": time.perf_counter() - t0,
            "card": card}]
    print(json.dumps(out[-1]), flush=True)
    for i, (name, leg, top_k, rows) in enumerate(PHASES):
        if phases and name not in phases:
            continue
        eng = make_engine(leg, rows, 100 + i, dev)
        rng = np.random.default_rng(200 + i)
        queries = [rng.standard_normal((BATCH, DIM), dtype=np.float32)
                   for _ in range(SEARCHES)]
        k_scan = eng.scan_widths(top_k)[1]
        q = torch.from_numpy(queries[0]).to(dev)
        a1, kw1, a3, kw3, (ns, blk) = kernel_inputs(eng, q, k_scan)
        rec = {"tree": tree, "phase": name, "leg": leg, "rows": rows,
               "capacity": eng.capacity, "k_scan": k_scan, "sample": ns,
               "block_rows": blk,
               "k1_ms": events_ms(lambda: K.fused_topk(*a1, **kw1)),
               "k3_ms": events_ms(lambda: K.sampled_submax(*a3, **kw3)),
               "k1_device_ms": device_ms(
                   lambda: K.fused_topk(*a1, **kw1))[0],
               "k3_device_ms": device_ms(
                   lambda: K.sampled_submax(*a3, **kw3))[0]}
        if name == "main path":  # K1 as a search with the floor closed
            kw0 = dict(kw1, theta0=None)
            rec["k1_nofloor_ms"] = events_ms(
                lambda: K.fused_topk(*a1, **kw0), iters=5)
        if rings and name == "main path" and hasattr(K, "_topk_cuda"):
            kw = dict(kw1)
            call = K._Call(*a1, kw.pop("metric"), kw.pop("row_bias", None),
                           kw.pop("q_scale", None), kw.pop("packed"))
            for r in list(rings) + list(reversed(rings)):
                lib = _build.load((f"VROD_K1_RING={r}",))
                rec.setdefault("k1_ring_ms", {}).setdefault(str(r), []) \
                    .append(events_ms(lambda: K._topk_cuda(
                        lib, call, kw["k"], 0, kw["theta0"])))
        if smoke is not None:
            dtype = leg.split("-")[0]
            extra1 = [v for v in kw1.values() if hasattr(v, "numel")]
            extra3 = [v for v in kw3.values() if hasattr(v, "numel")]
            rec["k1_bound"] = smoke.bound_of(
                a1 + extra1, BATCH * k_scan * 8,
                2 * BATCH * eng.capacity * DIM, dtype)
            rec["k3_bound"] = smoke.bound_of(
                a3 + extra3, BATCH * 128 * (ns // blk) * 4,
                2 * BATCH * ns * DIM, dtype)
            rec.update(smoke.library_times(leg, a1, k_scan, a3, blk))
        eng.search(queries[0], top_k)
        lat = []
        for qb in queries:
            t1 = time.perf_counter()
            eng.search(qb, top_k)
            lat.append((time.perf_counter() - t1) * 1e3)
        rec["search_p50_ms"] = float(np.percentile(lat, 50))
        if profile and name == "main path":
            rec["profile"] = profile_search(eng, queries, top_k,
                                            rec["search_p50_ms"])
        rec["card"] = card
        out.append(rec)
        print(json.dumps(rec), flush=True)
        del eng, a1, a3, kw1, kw3
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("trees", nargs="*")
    p.add_argument("--one", help=argparse.SUPPRESS)
    p.add_argument("--ring", default="")
    p.add_argument("--profile", action="store_true")
    p.add_argument("--library", action="store_true")
    p.add_argument("--phases", default="")
    p.add_argument("--out", default="chiprun_out/kernel_ab.jsonl")
    args = p.parse_args(argv)
    rings = [int(r) for r in args.ring.split(",") if r]
    phases = [ph for ph in args.phases.split(",") if ph]
    if args.one:
        run_tree(args.one, rings, args.profile, args.library, phases)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    lines = []
    for tree in args.trees:
        cmd = [sys.executable, __file__, "--one", tree, "--ring", args.ring,
               "--phases", args.phases]
        cmd += [f for f, on in (("--profile", args.profile),
                                ("--library", args.library)) if on]
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=1800)
        sys.stderr.write(res.stderr[-4000:])
        if res.returncode != 0:
            print(f"kernel_ab: {tree} failed ({res.returncode})",
                  file=sys.stderr)
            return 1
        for line in res.stdout.splitlines():
            if line.startswith("{"):
                lines.append(line)
                print(line, flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
