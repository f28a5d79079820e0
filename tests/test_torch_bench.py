"""``bench_torch.py``, the port's bench, on the CPU (``VROD_PLATFORM=cpu``,
the kernels' plain versions) at small sizes, against ``bench.py``, the JAX
package's bench:

- each of the six workloads prints one JSON line with ``bench.py``'s keys
  (plus ``card`` and ``launches``) and recall 1.0 wherever it reports one;
- the recall probe reads what ``bench.device_recall_probe`` reads on the
  JAX engine over the same stored state, for int8 cosine, l2 and dot, on
  the kernel path and the plain scan, at the default margin and at margin
  0 (where the scan's rank jitter shows);
- the direct fill stores what ``engine.write`` stores for the same rows,
  over 1 and 2 shards, and the probe reads below 1.0 when the int8 l2
  norms lane is left unbuilt after it;
- the mixed workload ends at ``bench.mixed_workload``'s count;
- a workload that raises prints the failed line and exits 2; with no card
  and no ``VROD_PLATFORM=cpu`` the program prints the failed line and
  exits 1 before any workload runs.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
import bench_torch
from vrod_tpu.config import CollectionConfig
from vrod_tpu.engine import DeviceEngine as JaxEngine
from vrod_tpu_torch import convert
from vrod_tpu_torch.config import CollectionConfig as PortConfig
from vrod_tpu_torch.engine import DeviceEngine

REPO = Path(__file__).resolve().parent.parent
ROWS, DIM, ITERS = 4096, 64, 2
SMALL = ["--quick", "--rows", str(ROWS), "--dim", str(DIM), "--batch", "16",
         "--iters", str(ITERS), "--clients", "4"]
# bench.py's ``extra`` keys by workload; the port adds "card" and
# "launches" to each.
EXTRA = {
    "search": {"batch_latency_ms", "latency_percentiles",
               "recall_full_scan@k", "cpu_brute_force_qps", "dtype"},
    "batch-sweep": {"curve"},
    "scaling": {"qps_by_shards", "devices_available", "recall_full_scan@k"},
    "serve": {"avg_queries_per_tile", "client_p50_ms", "client_p99_ms",
              "server_request", "recall_spotcheck"},
    "serve-batch": {"request_p50_ms", "request_p99_ms", "server_request",
                    "recall_spotcheck"},
    "mixed": {"restore_seconds", "reindex_seconds", "final_count"},
}


def run_bench(*argv, env=None):
    return subprocess.run([sys.executable, str(REPO / "bench_torch.py"),
                           *argv], cwd=REPO, capture_output=True, text=True,
                          timeout=240, env=env)


@pytest.mark.parametrize("workload", list(EXTRA))
def test_workload_prints_one_line(workload, capsys):
    bench_torch.main(bench_torch.parse_args(["--workload", workload,
                                             *SMALL]))
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1, lines
    line = json.loads(lines[0])
    assert set(line) == {"metric", "value", "unit", "vs_baseline", "extra"}
    assert line["value"] > 0
    extra = line["extra"]
    assert set(extra) == EXTRA[workload] | {"card", "launches"}
    assert extra["card"] is None and extra["launches"] == {}
    if workload == "batch-sweep":
        assert list(extra["curve"]) == ["1", "16", "64", "256", "1024"]
        assert all(p["recall_full_scan@k"] == 1.0
                   for p in extra["curve"].values())
    elif workload == "scaling":
        assert extra["qps_by_shards"].keys() == {"1"}
    if "recall_full_scan@k" in extra:
        assert extra["recall_full_scan@k"] == 1.0
    if workload == "mixed":
        assert extra["final_count"] == ROWS + 128 * ITERS


def carried(metric):
    """A JAX engine of ROWS x DIM int8 rows written from seeded vectors,
    and the port's engine holding the same stored state."""
    cfg = CollectionConfig(name="b", dim=DIM, metric=metric, dtype="int8",
                           segment_rows=ROWS, shards=1)
    jeng = JaxEngine(cfg)
    rows = np.random.default_rng(0).standard_normal((ROWS, DIM))
    jeng.write(np.arange(ROWS), rows.astype(np.float32))
    pcfg = PortConfig(**dataclasses.asdict(cfg))
    eng = DeviceEngine(pcfg, device="cpu")
    eng.load_state(*convert.engine_state_from_numpy(
        pcfg, np.asarray(jeng.x), np.asarray(jeng.aux),
        np.asarray(jeng.valid), "cpu"))
    return jeng, eng


@pytest.mark.parametrize("margin", [None, 0])
@pytest.mark.parametrize("impl", ["pallas", "scan"])
@pytest.mark.parametrize("metric", ["cosine", "l2", "dot"])
def test_recall_probe_equals_jax_bench(metric, impl, margin):
    """16 queries, so that the JAX engine runs its Pallas kernel (in
    interpret mode here) where asked: at batch 8 it takes its scan."""
    jeng, eng = carried(metric)
    precision = "fast" if impl == "pallas" else "high"
    jeng.impl, jeng.precision = impl, precision  # as bench.tpu_qps sets them
    q = np.random.default_rng(1).standard_normal((16, DIM)).astype(
        np.float32)
    want = bench.device_recall_probe(jeng, jnp.asarray(q), 16, margin=margin)
    got = bench_torch.device_recall_probe(eng, torch.from_numpy(q), 16,
                                          margin=margin, impl=impl,
                                          precision=precision)
    assert got == want
    if margin is None:
        assert got == 1.0
    elif impl == "pallas":
        assert got < 1.0  # these seeds miss at margin 0: a real comparison


def written(cfg, n_rows, devices):
    """An engine holding bench_torch's rows for ``n_rows`` slots, written
    through ``engine.write`` from the host."""
    eng = DeviceEngine(cfg, devices=devices)
    eng.ensure_capacity(n_rows)
    g = torch.Generator()
    for start in range(0, n_rows, 1024):
        g.manual_seed(start)
        n = min(1024, n_rows - start)
        eng.write(np.arange(start, start + n),
                  torch.randn((n, DIM), generator=g).numpy())
    return eng


@pytest.mark.parametrize("shards", [1, 2])
@pytest.mark.parametrize("dtype,metric", [("int8", "l2"), ("int4", "dot"),
                                          ("bfloat16", "l2")])
def test_direct_fill_stores_what_write_stores(dtype, metric, shards):
    """In chunks of 1,024 rows (seeded by their first slot) over 3,000 of
    the 65,536 slots, split over the shards; every lane equal."""
    cfg = PortConfig(name="b", dim=DIM, metric=metric, dtype=dtype,
                     segment_rows=65536 // shards, shards=shards)
    devices = [torch.device("cpu")] * shards
    eng = DeviceEngine(cfg, devices=devices)
    eng.ensure_capacity(3000)
    bench_torch.fill_direct(eng, 3000, chunk=1024)
    want = written(cfg, 3000, devices).gather_state()
    got = eng.gather_state()
    assert int(got[2].sum()) == 3000
    for a, b in zip(got, want):
        if a is None:
            assert b is None
        else:
            assert torch.equal(a, b)


def test_probe_reads_below_one_without_the_norms_lane():
    """bench.py's fill once left the int8 l2 norms lane unbuilt and its
    probe read 0.195 (``bench.py:124-127``): the port's probe catches the
    same fault."""
    eng = bench_torch.build_engine(ROWS, DIM, "l2", "int8")
    q = bench_torch.staged_queries(8, DIM, eng.device)
    assert bench_torch.device_recall_probe(eng, q, 16) == 1.0
    eng.norms.zero_()
    assert bench_torch.device_recall_probe(eng, q, 16) < 0.5


def test_mixed_count_equals_jax_bench():
    """The same ops from the same default_rng(3) stream, so the same final
    count: each iteration inserts 256 rows and deletes 128."""
    want = bench.mixed_workload(1024, 32, 3)[2]
    got = bench_torch.mixed_workload(1024, 32, 3)[2]
    assert got == want == 1024 + 128 * 3


def test_a_raising_workload_prints_the_failed_line_and_exits_2():
    out = run_bench("--precision", "bogus", *SMALL,
                    env=dict(os.environ, VROD_PLATFORM="cpu"))
    assert out.returncode == 2, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["value"] is None and line["metric"] == \
        "bench search (failed)"
    assert "precision" in line["error"]


def test_no_card_prints_the_failed_line_and_exits_1():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the bench runs on it")
    env = {k: v for k, v in os.environ.items() if k != "VROD_PLATFORM"}
    env["VROD_PROBE_ATTEMPTS"] = "1"
    out = run_bench("--workload", "mixed", *SMALL, env=env)
    assert out.returncode == 1
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1, lines  # nothing ran on the CPU
    line = json.loads(lines[0])
    assert line["value"] is None and line["metric"] == "bench mixed (failed)"
    assert "no CUDA device" in line["error"]
