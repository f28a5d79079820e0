"""The port's tools in ``tools/`` (``filter_bench``, ``soak_serve``,
``repl_drill``: the counterparts of ``experiments/filter_bench.py``,
``soak_serve.py`` and ``repl_drill.py``), each run small on the CPU
(``VROD_PLATFORM=cpu``, which the drill's server processes inherit) as a
user runs it, in a process of its own. Each must exit 0 and print its JSON
summary with ``ok`` true; their own asserts (no excluded slot, the
allowlist held, errors 0 and fds bounded, one bootstrap and then a resume
with no bootstrap or resync, spot records bit-identical) run inside.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

TOOLS = Path(__file__).resolve().parent.parent / "tools"


def run_tool(name, *argv, timeout=240):
    env = dict(os.environ, VROD_PLATFORM="cpu")
    out = subprocess.run([sys.executable, str(TOOLS / f"{name}.py"), *argv],
                         capture_output=True, text=True, timeout=timeout,
                         env=env)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
    summary = json.loads(out.stdout.strip().splitlines()[-1])
    assert summary["ok"] is True, summary
    return summary


def test_filter_bench_small():
    for dtype in ("bfloat16", "int8"):
        s = run_tool("filter_bench", "--rows", "65536", "--dim", "64",
                     "--dtype", dtype, "--batch", "32", "--iters", "2")
        assert (s["rows"], s["dtype"], s["excluded"], s["within"]) == \
            (65536, dtype, 16384, 4096)
        assert s["device"] == "cpu" and s["card"] is None
        assert s["launches"] == {}  # the plain versions on the CPU


def test_soak_serve_brief():
    s = run_tool("soak_serve", "--minutes", "0.09",
                 "--seconds-per-sample", "5")
    assert s["errors"] == 0 and s["samples"] == 2
    assert s["searches"] > 0 and s["mutations"] > 0
    assert s["fd_end"] <= s["fd_start"] + 16
    assert s["plateau_judged"] is False  # no 2-minute mark in 10 s


def test_repl_drill_small(tmp_path):
    s = run_tool("repl_drill", "--rows", "20000", "--dim", "32",
                 "--chunk", "10000", "--tail-rows", "2000",
                 "--workdir", str(tmp_path))
    assert s["verified_records"] == 4
    # Each process's memory, the servers' from their STATS (no device
    # memory on the CPU).
    assert set(s["memory"]) == {"drill_ingest", "primary", "replica",
                                "replica_resumed"}
    assert all(m["rss_bytes"] > 0 and "device_max_allocated_bytes"
               not in m for m in s["memory"].values())
    assert s["snapshot_bytes"] > 20000 * 32
    assert s["disk_peak_bytes"] <= s["disk_need_bytes"]
    assert {"ingest_s", "snapshot_s", "bootstrap_s", "tail_ack_s",
            "resume_s"} <= set(s["times"])


def test_repl_drill_refuses_a_disk_too_small(tmp_path):
    out = subprocess.run(
        [sys.executable, str(TOOLS / "repl_drill.py"), "--rows",
         str(10 ** 12), "--workdir", str(tmp_path)],
        capture_output=True, text=True, timeout=120,
        env=dict(os.environ, VROD_PLATFORM="cpu"))
    assert out.returncode == 2
    assert "GB free" in out.stderr and "Cut --rows" in out.stderr
    assert not any(tmp_path.iterdir())
