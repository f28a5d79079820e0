#!/usr/bin/env python3
"""Where K1's time goes: K1 at the 1M-row phases' shapes built whole and
with parts of its scan switched off, on one GPU.

    python tools/kernel_probe.py [--small | --f32x3 | --floor]
        [--variants V,..] [--legs f32x3] [--cases C,..] [--out FILE]

Builds the kernels once per variant (compile-time switches of csrc/; the
builds live beside the normal one under csrc/build/, and the port never
loads them):
- ``whole``;
- ``test_only`` (``VROD_PROBE_TEST_ONLY``): the dots and each score's
  test, no appends and so no cuts;
- ``no_gate`` (``VROD_PROBE_NO_GATE``): the dots and the scan's barriers,
  no test;
- ``no_barriers`` (``VROD_PROBE_NO_GATE`` with
  ``VROD_PROBE_NO_CUT_BARRIERS``): the dots alone, without the barriers
  that the scan's list cuts (or its vote) hold both warpgroups at;
- ``ring_alone`` (``VROD_PROBE_NO_GATE`` with ``VROD_PROBE_NO_MMA``): the
  TMA ring and ldmatrix only.
Then times ``fused_topk`` with CUDA events (mean of 20 after a warm-up) on
the main path's inputs (int8 cosine, k_scan 28) and (iii)'s (bf16 cosine,
k_scan 108) at 1M x 768, b256, with the floor from K3 as a search gives
it, and with no floor (theta0 None), in turns: the variants in order, then
in reverse. With the floor the calls take K1's scan from a floor
(``csrc/fused_topk_floor.cu``); without, the gated core
(``csrc/fused_topk.cu``); both know every switch. The switched builds
return meaningless results; only their times are printed. Last, a
``VROD_PROBE_COUNT`` build counts per call the scores appended, the lists
cut, the cut rounds (a block's vote rounds) and the tiles walked
(``vrod_probe_counts``: the gated core's; ``--floor`` reads the scan from
a floor's), at the same inputs. Prints one JSON object per line and writes
them to ``--out``.

``--floor``: instead, K1's scan from a floor alone
(``csrc/fused_topk_floor.cu``, which then knows every switch above),
each variant built from that source alone (all builds at once, beside the
default library that makes the inputs): ``whole``, ``test_only``,
``no_gate``, ``no_barriers``, ``ring_alone``, and the schedules for
every build, ``lockstep`` (``VROD_PROBE_LOCKSTEP``: both consumer
warpgroups on every stage together; the TMA builds' default) and
``pingpong`` (``VROD_PROBE_PINGPONG``: the warpgroups' turns on the tensor
cores; the copying builds'), and ``radix_cut`` (``VROD_PROBE_RADIX_CUT``:
every list cut by the radix select) (``--variants``: some of them), timed
with CUDA events (mean of 20) at the main path's and (iii)'s inputs from
their K3 floors and from a floor of -1e30 (", cuts": the lists are cut),
in turns (the variants in order, then in reverse), and ``whole``,
``lockstep`` and ``pingpong`` also at the other phases whose searches
take the scan from a floor (``FLOOR_CASES``: (i), (ii), (iv) at the
default precision and at "exact", glove-100's rows; ``--cases``: some of
them), ``whole`` also by device time (torch.profiler), and the variants
that keep the results checked equal to the default library's top-k;
then the counts of a ``VROD_PROBE_COUNT`` build per call
(``vrod_probe_counts_floor``: scores appended, lists cut, cut points,
tiles walked, the appends' shared atomics); then, from the whole build's
ptxas report, each ``fused_topk_floor`` / X9 entry's registers, spills,
stack and static shared memory and its count of "wgmma serialized"
(C7520) and "warpgroup.arrive injected" (C7519) lines. A copy of this
file in another checkout's ``tools/`` probes that checkout's scan (a
parent/change A/B: ``--variants whole``).

``--f32x3``: instead, K1 without a floor (the gated core) on float32
rows at "exact" (leg f32x3-dot: three TF32 products) at (iv)'s 1,048,576
x 768, b256, k 108, CUDA events (mean of 20) in turns, built whole,
without the split of the rows' registers into their TF32 parts
(``VROD_PROBE_NO_SPLIT``), with the split by ``cvt.rna.tf32.f32`` in
place of the integer rounding (``VROD_PROBE_CVT_SPLIT``), with the rows
split once a stage by the producer warpgroup (``VROD_PROBE_PRESPLIT``:
its warps 1-3 write the big parts in place and the small parts into a
third box of the stage, 48 KB, and the consumers load both and split
nothing; K1's gated core alone, TMA builds), without the second stage of
a k-block where the build walks one (``VROD_PROBE_ONE_WALK``), with the
test but no appends (``test_only``), without the test (``no_gate``) and
with the ring, the loads and the split alone (``ring_alone``)
(``--variants``: some of them). The variants but ``whole`` build
``csrc/fused_topk.cu`` alone. Each is timed at its layout (ring, list
places) of ``F32X3_LAYOUTS`` (default: ``cuda_topk.topk_layout``'s);
``whole`` also at k 24 beside 4 and 3 stages, three times each in turns.
Then the counts (``VROD_PROBE_COUNT``) and the whole build's time on
those rows at f32x3 and as bfloat16 cosine rows, k 108.

``--small``: instead, K3 on the int8 headline's sample (32,768 x 768 in
blocks of 16,384, b256) and on a bf16 sample (131,072 x 768), and K1's
small scan at 8,192 x 96, b256, k 28 (int8 and bf16, no floor) and at
32,768 x 768 (int8); at f32x3 ("exact"), K3 on 32,768 and 131,072 rows
of 768 in blocks of 8,192 and K1's small scan at 8,192 x 96 and 32,768
x 768; each by torch.profiler's device time a call, whole, without the
MMAs (``VROD_PROBE_NO_MMA``: the ring, the loads and for K1 the gate),
without K1's gate and with the ring alone (``--variants``, ``--legs``:
some of them). A copy of this file in another checkout's ``tools/`` times
that checkout's kernels (a parent/change A/B: ``--variants whole``).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
VARIANTS = {"whole": (), "test_only": ("VROD_PROBE_TEST_ONLY",),
            "no_gate": ("VROD_PROBE_NO_GATE",),
            "no_barriers": ("VROD_PROBE_NO_GATE",
                            "VROD_PROBE_NO_CUT_BARRIERS"),
            "ring_alone": ("VROD_PROBE_NO_GATE", "VROD_PROBE_NO_MMA")}
CASES = (("main path", "int8-cosine", 16), ("(iii)", "bf16-cosine", 100))
COUNTS = ("appends", "cuts", "cut_rounds", "tiles")


SMALL_VARIANTS = {v: VARIANTS[v] for v in ("whole", "no_gate",
                                           "ring_alone")}
SMALL_VARIANTS["no_mma"] = ("VROD_PROBE_NO_MMA",)
SMALL_CASES = (("K3", "int8-cosine", 32768, 768, 16384),
               ("K3", "bf16-cosine", 131072, 768, 16384),
               ("K1", "int8-cosine", 8192, 96, 0),
               ("K1", "bf16-cosine", 8192, 96, 0),
               ("K1", "int8-cosine", 32768, 768, 0),
               # f32x3 ("exact"): K3 on the samples of chip_smoke's phase
               # (iv) (262,144 rows) and of 1,048,576 rows, K1's small scan
               ("K3", "f32x3-dot", 32768, 768, 8192),
               ("K3", "f32x3-dot", 131072, 768, 8192),
               ("K1", "f32x3-dot", 8192, 96, 0),
               ("K1", "f32x3-dot", 32768, 768, 0))


F32X3_VARIANTS = {"whole": (), "no_split": ("VROD_PROBE_NO_SPLIT",),
                  "cvt_split": ("VROD_PROBE_CVT_SPLIT",),
                  "presplit": ("VROD_PROBE_PRESPLIT",),
                  "one_walk": ("VROD_PROBE_ONE_WALK",),
                  "test_only": VARIANTS["test_only"],
                  "no_gate": VARIANTS["no_gate"],
                  "ring_alone": VARIANTS["ring_alone"]}
# (ring, list places) of a variant at k 108 beside its default layout:
# the whole build also at 3 stages of 242 places and of 146 (the places
# that 3 presplit stages of 48 KB leave), the presplit build at 3 stages
# of 146 and 2 of 242 (its 4 stages would leave 49).
F32X3_LAYOUTS = {"whole": [None, (3, 242), (3, 146)],
                 "presplit": [(3, 146), (2, 242)]}


FLOOR_COUNTS = ("appends", "cuts", "cut_points", "tiles", "atomics")
# --floor: (case, leg, top-k, rows, dim, precision) of every phase whose
# searches take the scan from a floor: the main path, (i), (ii), (iii),
# (iv) at the default precision and at "exact" (f32x3), and glove-100's
# rows (1,183,514 x 100 int8: the copying build, 4-byte copies).
FLOOR_CASES = (("main path", "int8-cosine", 16, 1_000_000, 768, "fast"),
               ("(i)", "int8-l2", 16, 1_000_000, 768, "fast"),
               ("(ii)", "int4-l2", 16, 1_000_000, 768, "fast"),
               ("(iii)", "bf16-cosine", 100, 1_000_000, 768, "fast"),
               ("(iv)", "f32-dot", 100, 1_000_000, 768, "fast"),
               ("(iv) exact", "f32-dot", 100, 1_000_000, 768, "exact"),
               ("glove-100 int8", "int8-cosine", 16, 1_183_514, 100,
                "fast"))
# The cases every variant is timed at, each also from a floor of -1e30
# below every score (", cuts": every row passes until the lists' cuts
# raise the gates, so each list is cut several times a part); the others
# take ``whole``, ``lockstep`` and ``pingpong`` alone.
FLOOR_PROBE_CASES = ("main path", "(iii)")
# --floor: the switches above, the scan from a floor's schedules for
# every build: both warpgroups on every stage together (the TMA builds'
# default) and the ping-pong (the copying builds'), and every cut by the
# radix select (warp_select, in place of the warp sorts below k 193).
FLOOR_VARIANTS = dict(VARIANTS, lockstep=("VROD_PROBE_LOCKSTEP",),
                      pingpong=("VROD_PROBE_PINGPONG",),
                      radix_cut=("VROD_PROBE_RADIX_CUT",))
# The variants that keep the results, checked equal to the library's.
FLOOR_EXACT = ("whole", "lockstep", "pingpong", "radix_cut")


def _floor_lib(defines):
    """K1's scan from a floor built from ``csrc/fused_topk_floor.cu`` alone
    with ``defines``, its entry bound as the default library's."""
    import ctypes
    from vrod_tpu_torch.ops import _build
    lib = ctypes.CDLL(str(_build.build(defines, ("fused_topk_floor.cu",))))
    full = _build.load()
    f, g = lib.vrod_fused_topk_floor, full.vrod_fused_topk_floor
    f.restype, f.argtypes = g.restype, g.argtypes
    return lib


_KINDS = {"2I8": "int8", "2I4": "int4", "4BF16": "bf16", "4TF32": "f32",
          "5F32X3": "f32x3"}
_EPIS = ("scale", "scale_qs", "l2", "dot")


def ptxas_entries(log, kernel="fused_topk_floor"):
    """Per entry of ``kernel`` in a build's ptxas report (``-Xptxas -v``):
    its kind, epilogue, load (tma or copy), int gate, registers, spill
    stores and loads, stack, static shared memory and counts of C7520
    ("wgmma serialized") and C7519 ("warpgroup.arrive injected") lines."""
    import re
    head = re.compile(r"Compiling entry function '(\S*" + kernel
                      + r"I(?:NS_)?(\d\w+?)ELi(\d)ELb(\d)ELb(\d)E\S*)'")
    recs, cur = {}, None

    def rec_of(name):
        return recs.setdefault(name, {"entry": name, "serialized": 0,
                                      "arrive_injected": 0})

    for line in log.splitlines():
        m = head.search(line)
        if m:
            name, kind, epi, tma, gate = m.groups()
            cur = rec_of(name)
            cur["entry"] = (f"{_KINDS.get(kind, kind)}-{_EPIS[int(epi)]}"
                            f"{'' if tma == '1' else '-copy'}"
                            f"{'-intgate' if gate == '1' else ''}")
            continue
        for code, key in (("C7520", "serialized"),
                          ("C7519", "arrive_injected")):
            # These reports come before their entry's header.
            m = re.search(r"function '(\S+)'", line)
            if code in line and m and kernel in m.group(1):
                rec_of(m.group(1))[key] += 1
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur.update(stack=int(m[1]), spill_stores=int(m[2]),
                       spill_loads=int(m[3]))
        m = re.search(r"Used (\d+) registers.*?(\d+) bytes smem", line)
        if m:
            cur.update(registers=int(m[1]), static_smem=int(m[2]))
            cur = None
    return list(recs.values())


def floor_probe(kab, names=(), cases=()):
    """The ``--floor`` records: K1's scan from a floor by variant (those of
    ``names``, else all) at FLOOR_PROBE_CASES' inputs, from their K3
    floors and from -1e30 (``whole``, ``lockstep`` and ``pingpong`` at
    every FLOOR_CASES' of ``cases``, else all), then its counts, then its
    entries' ptxas report."""
    import ctypes
    import torch
    from concurrent.futures import ThreadPoolExecutor
    from vrod_tpu_torch.ops import _build
    from vrod_tpu_torch.ops import cuda_topk as K
    variants = {v: d for v, d in FLOOR_VARIANTS.items()
                if not names or v in names}
    builds = list(dict.fromkeys(list(variants.values())
                                + [(), ("VROD_PROBE_COUNT",)]))
    # Every build at once (one nvcc a source), the default library among
    # them.
    jobs = [(d, ("fused_topk_floor.cu",)) for d in builds] + [((), ())]
    with ThreadPoolExecutor() as ex:
        list(ex.map(lambda job: _build.build(*job), jobs))
    dev = torch.device("cuda", 0)
    card = kab.card_line()
    inputs = {}
    for i, (name, leg, top_k, rows, dim, precision) in enumerate(
            FLOOR_CASES):
        if cases and name not in cases:
            continue
        eng = kab.make_engine(leg, rows, 300 + i, dev, dim)
        q = torch.randn(kab.BATCH, dim, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(i))
        # The floor K3 gives a search at the default precision (at
        # "exact" too: the same floor, f32x3's scan from it).
        a1, kw1, _, _, _ = kab.kernel_inputs(eng, q,
                                             eng.scan_widths(top_k)[1])
        kw = dict(kw1)
        call = K._Call(*a1, kw.pop("metric"), kw.pop("row_bias", None),
                       kw.pop("q_scale", None), kw.pop("packed"),
                       precision)
        want = K._topk_cuda(_build.load(), call, kw["k"], 0, kw["theta0"])
        inputs[name] = (call, kw["k"], kw["theta0"], want)
        if name in FLOOR_PROBE_CASES:
            low = torch.full_like(kw["theta0"], -1e30)
            inputs[name + ", cuts"] = (
                call, kw["k"], low,
                K._topk_cuda(_build.load(), call, kw["k"], 0, low))
        del eng
    probe = [c for c in inputs
             if c in FLOOR_PROBE_CASES or c.endswith(", cuts")]
    order = list(variants) + list(reversed(variants))
    for variant in order:
        lib = _floor_lib(variants[variant])
        rec = {"variant": variant, "card": card}
        for name, (call, k, theta0, want) in inputs.items():
            if name not in probe and variant not in (
                    "whole", "lockstep", "pingpong"):
                continue

            def run(lib=lib, call=call, k=k, theta0=theta0):
                return K._topk_cuda(lib, call, k, 0, theta0)
            rec[name] = kab.events_ms(run)
            if variant == "whole":
                rec[name + " device"] = kab.device_ms(run)[0]
            if variant in FLOOR_EXACT:
                rec[name + " equal to the library's"] = all(
                    torch.equal(g, w) for g, w in zip(run(), want))
        yield rec
    lib = _floor_lib(("VROD_PROBE_COUNT",))
    if not hasattr(lib, "vrod_probe_counts_floor"):
        return  # a checkout whose scan from a floor counts nothing
    lib.vrod_probe_counts_floor.restype = ctypes.c_int
    lib.vrod_probe_counts_floor.argtypes = [ctypes.c_void_p]
    buf = (ctypes.c_int * 8)()
    for name, (call, k, theta0, _) in inputs.items():
        if name not in probe:
            continue
        K._ok(lib.vrod_probe_counts_floor(buf), "probe counts")  # zero
        K._topk_cuda(lib, call, k, 0, theta0)
        torch.cuda.synchronize()
        K._ok(lib.vrod_probe_counts_floor(buf), "probe counts")
        yield {"variant": "counts", "case": name, "k_scan": k,
               "rows": call.n, "card": card,
               **dict(zip(FLOOR_COUNTS, list(buf)))}
    log = _build.build((), ("fused_topk_floor.cu",)).with_suffix(".log")
    for rec in ptxas_entries(log.read_text()):
        yield {"variant": "ptxas", **rec}


def _fused_topk_lib(defines):
    """K1's gated core built from ``csrc/fused_topk.cu`` alone with
    ``defines``, its entry points bound as the default library's."""
    import ctypes
    from vrod_tpu_torch.ops import _build
    if not defines:
        return _build.load()
    lib = ctypes.CDLL(str(_build.build(defines, ("fused_topk.cu",))))
    full = _build.load()
    for name in ("vrod_fused_topk", "vrod_k1_ring"):
        f, g = getattr(lib, name), getattr(full, name)
        f.restype, f.argtypes = g.restype, g.argtypes
    return lib


def f32x3_probe(kab, names=()):
    """The ``--f32x3`` records: K1's gated core at f32x3 by variant (those
    of ``names``, else all) and layout, then its counts, and the same at
    bfloat16 cosine rows for comparison."""
    import torch
    from concurrent.futures import ThreadPoolExecutor
    from vrod_tpu_torch.ops import _build
    from vrod_tpu_torch.ops import cuda_topk as K
    spec = importlib.util.spec_from_file_location("smoke",
                                                  ROOT / "chip_smoke.py")
    sm = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sm)
    variants = {v: d for v, d in F32X3_VARIANTS.items()
                if not names or v in names}
    # Every build at once (one nvcc a source), the default among them.
    with ThreadPoolExecutor() as ex:
        list(ex.map(lambda d: _build.build(d, ("fused_topk.cu",) if d
                                           else ()),
                    list(dict.fromkeys(list(variants.values())
                                       + [(), ("VROD_PROBE_COUNT",)]))))
    dev = torch.device("cuda", 0)
    card = kab.card_line()
    gen = torch.Generator(device=dev).manual_seed(18)
    x = torch.randn((1 << 20, kab.DIM), generator=gen, device=dev)
    q = torch.randn((kab.BATCH, kab.DIM), generator=gen, device=dev)
    calls = {}
    for leg in ("f32x3-dot", "bf16-cosine"):
        args, kw = sm.kernel_inputs(x, q, leg, dev)
        calls[leg] = K._Call(*args, leg.split("-")[1], None, None, False,
                             kw.get("precision", "fast"))
    del x
    call = calls["f32x3-dot"]
    default_plan = K.card_plan

    def timed(lib, k, lay):
        """K1's events ms at k beside layout (ring, cap) (None: the
        default), its plan and its outputs."""
        plan = default_plan(lib, call, k)
        if lay is not None:
            plan = plan._replace(ring=lay[0], cap=lay[1], on_chip=True)
        K.card_plan = lambda *a: plan
        try:
            out = K._topk_cuda(lib, call, k, 0, None)
            return kab.events_ms(lambda: K._topk_cuda(lib, call, k, 0,
                                                      None)), plan, out
        finally:
            K.card_plan = default_plan

    want = K._topk_cuda(_build.load(), call, 108, 0, None)
    runs = [(v, lay) for v in variants
            for lay in F32X3_LAYOUTS.get(v, [None])]
    for variant, lay in runs + list(reversed(runs)):
        ms, plan, got = timed(_fused_topk_lib(variants[variant]), 108, lay)
        # The variants that keep the scores (the split's two forms, the
        # presplit and every layout) return the whole build's top-k.
        same = all(torch.equal(g, w) for g, w in zip(got, want))
        yield {"variant": variant, "case": "(iv) f32x3-dot no floor",
               "rows": call.n, "k_scan": 108, "ring": plan.ring,
               "cap": plan.cap, "on_chip": plan.on_chip, "k1_ms": ms,
               "equal_to_whole": same, "card": card}
    if "whole" in variants:
        for lay in [None, (3, 242)] * 3:
            ms, plan, _ = timed(_build.load(), 24, lay)
            yield {"variant": "whole", "case": "(iv) f32x3-dot no floor",
                   "rows": call.n, "k_scan": 24, "ring": plan.ring,
                   "cap": plan.cap, "on_chip": plan.on_chip, "k1_ms": ms,
                   "card": card}
    import ctypes
    lib = _fused_topk_lib(("VROD_PROBE_COUNT",))
    lib.vrod_probe_counts.restype = ctypes.c_int
    lib.vrod_probe_counts.argtypes = [ctypes.c_void_p]
    buf = (ctypes.c_int * 8)()
    for leg, c in calls.items():
        K._ok(lib.vrod_probe_counts(buf), "probe counts")  # zero them
        K._topk_cuda(lib, c, 108, 0, None)
        torch.cuda.synchronize()
        K._ok(lib.vrod_probe_counts(buf), "probe counts")
        whole = _build.load(())
        yield {"variant": "counts", "case": f"{leg} no floor",
               "rows": c.n, "k_scan": 108, "card": card,
               "whole_ms": kab.events_ms(
                   lambda: K._topk_cuda(whole, c, 108, 0, None)),
               **dict(zip(COUNTS, list(buf)))}


def small_probe(names=(), legs=()):
    """The ``--small`` records: K3 and K1's small scan by device time, by
    variant (those of ``names``, else all) and case (those of the row
    kinds ``legs``, e.g. f32x3, else all)."""
    import numpy as np
    import torch
    from vrod_tpu_torch.ops import _build
    from vrod_tpu_torch.ops import cuda_topk as K
    spec = importlib.util.spec_from_file_location("smoke",
                                                  ROOT / "chip_smoke.py")
    sm = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sm)
    dev = torch.device("cuda", 0)
    card = sm.card_line()
    libs = {v: _build.load(d) for v, d in SMALL_VARIANTS.items()
            if not names or v in names}
    rng = np.random.default_rng(3)
    for kind, leg, n, d, blk in SMALL_CASES:
        if legs and leg.split("-")[0] not in legs:
            continue
        x = torch.from_numpy(rng.standard_normal((n, d), dtype=np.float32))
        q = torch.from_numpy(rng.standard_normal((256, d), dtype=np.float32))
        args, kw = sm.kernel_inputs(x, q, leg, dev, dead_every=5)
        call = K._Call(*args, leg.split("-")[1], kw.get("row_bias"),
                       kw.get("q_scale"), kw["packed"],
                       kw.get("precision", "fast"))
        rec = {"kernel": kind, "leg": leg, "rows": n, "dim": d,
               "card": card}
        for variant, lib in libs.items():
            fn = (lambda lib=lib: K._submax_cuda(lib, call, blk)) \
                if kind == "K3" else \
                (lambda lib=lib: K._topk_cuda(lib, call, 28, 0, None))
            rec[variant] = sm.device_time(fn)[0]
        yield rec


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--small", action="store_true")
    p.add_argument("--f32x3", action="store_true")
    p.add_argument("--floor", action="store_true")
    p.add_argument("--variants", default="",
                   help="--f32x3, --small, --floor: the variants to build "
                   "and time "
                   "(comma-separated; default all)")
    p.add_argument("--cases", default="",
                   help="--floor: the FLOOR_CASES to time (comma-separated "
                   "names; default all)")
    p.add_argument("--legs", default="",
                   help="--small: the row kinds of the cases to time "
                   "(comma-separated, e.g. f32x3; default all)")
    p.add_argument("--out", default="chiprun_out/kernel_probe.jsonl")
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("kernel_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    if args.small or args.f32x3 or args.floor:
        lines = []
        spec = importlib.util.spec_from_file_location(
            "kernel_ab", Path(__file__).with_name("kernel_ab.py"))
        kab = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(kab)
        names = [v for v in args.variants.split(",") if v]
        legs = [v for v in args.legs.split(",") if v]
        cases = [c for c in args.cases.split(",") if c]
        gen = (f32x3_probe(kab, names) if args.f32x3
               else floor_probe(kab, names, cases) if args.floor
               else small_probe(names, legs))
        for rec in gen:
            lines.append(json.dumps(rec))
            print(lines[-1], flush=True)
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(lines) + "\n")
        return 0
    from vrod_tpu_torch.ops import _build
    from vrod_tpu_torch.ops import cuda_topk as K
    spec = importlib.util.spec_from_file_location(
        "kernel_ab", Path(__file__).with_name("kernel_ab.py"))
    kab = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(kab)
    torch.backends.cuda.matmul.allow_tf32 = False
    # Every variant's build at once (each runs one nvcc a source).
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor() as ex:
        list(ex.map(_build.build, list(VARIANTS.values())
                    + [("VROD_PROBE_COUNT",)]))
    dev = torch.device("cuda", 0)
    card = kab.card_line()
    inputs = {}
    for i, (name, leg, top_k) in enumerate(CASES):
        eng = kab.make_engine(leg, 1_000_000, 300 + i, dev)
        q = torch.randn(kab.BATCH, kab.DIM, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(i))
        a1, kw1, _, _, _ = kab.kernel_inputs(eng, q, eng.scan_widths(top_k)[1])
        kw = dict(kw1)
        call = K._Call(*a1, kw.pop("metric"), kw.pop("row_bias", None),
                       kw.pop("q_scale", None), kw.pop("packed"))
        inputs[name] = (eng, call, kw["k"], kw["theta0"])
    order = list(VARIANTS) + list(reversed(VARIANTS))
    lines = []
    for variant in order:
        lib = _build.load(VARIANTS[variant])
        rec = {"variant": variant, "card": card}
        for name, (_, call, k, theta0) in inputs.items():
            for floor, t0 in (("", theta0), (" no floor", None)):
                rec[name + floor] = kab.events_ms(
                    lambda: K._topk_cuda(lib, call, k, 0, t0))
        lines.append(json.dumps(rec))
        print(lines[-1], flush=True)
    import ctypes
    lib = _build.load(("VROD_PROBE_COUNT",))
    lib.vrod_probe_counts.restype = ctypes.c_int
    lib.vrod_probe_counts.argtypes = [ctypes.c_void_p]
    buf = (ctypes.c_int * 8)()
    for name, (_, call, k, theta0) in inputs.items():
        for floor, t0 in (("", theta0), (" no floor", None)):
            K._ok(lib.vrod_probe_counts(buf), "probe counts")  # zero them
            K._topk_cuda(lib, call, k, 0, t0)
            torch.cuda.synchronize()
            K._ok(lib.vrod_probe_counts(buf), "probe counts")
            rec = {"variant": "counts", "case": name + floor, "k_scan": k,
                   "card": card, **dict(zip(COUNTS, list(buf)))}
            lines.append(json.dumps(rec))
            print(lines[-1], flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
