"""Keep the port's fuzz harnesses (``tools/fuzz_*.py``) importable and
passing: a few seeds of each, so the deep campaigns (PERF.md) can be
re-launched any time without rot.

``tests/test_fuzz_smoke.py`` (5 cases) over the port, with the same seed
ranges: wal 0-50 (skipped without the native library, as there),
cold_count 0-2, replication 0-1, backup 0-2, protocol 0-2, each run in
this process. Two more run as subprocesses, each with a time limit of its
own: ``fuzz_verify`` 0-2 and ``fuzz_multihost`` seed 0 (two ranks, gloo
on the CPU).
"""

import os
import runpy
import subprocess
import sys
from pathlib import Path

import pytest

from vrod_tpu_torch._native.build import load_native

TOOLS = Path(__file__).resolve().parents[1] / "tools"


def _run(name, lo, hi):
    argv = sys.argv
    sys.argv = [name, str(lo), str(hi)]
    try:
        runpy.run_path(str(TOOLS / name), run_name="__main__")
    except SystemExit as e:
        assert not e.code, f"{name} exited with {e.code}"
    finally:
        sys.argv = argv


def _run_limited(name, lo, hi, timeout_s):
    env = dict(os.environ, VROD_PLATFORM="cpu")
    out = subprocess.run(
        [sys.executable, str(TOOLS / name), str(lo), str(hi)], env=env,
        capture_output=True, text=True, timeout=timeout_s)
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-4000:]
    return out.stdout


def test_wal_corruption_fuzz_smoke():
    if load_native() is None:
        pytest.skip("native WAL unavailable (fallback leg): the harness "
                    "checks native-vs-python parity, meaningless here")
    _run("fuzz_wal.py", 0, 50)


def test_cold_count_fuzz_smoke():
    _run("fuzz_cold_count.py", 0, 2)


def test_replication_fuzz_smoke():
    _run("fuzz_replication.py", 0, 1)


def test_backup_fuzz_smoke():
    _run("fuzz_backup.py", 0, 2)


def test_protocol_fuzz_smoke():
    _run("fuzz_protocol.py", 0, 2)


def test_verify_fuzz_smoke():
    out = _run_limited("fuzz_verify.py", 0, 2, timeout_s=300)
    assert "PASS seeds 0-1" in out, out


def test_multihost_fuzz_smoke():
    out = _run_limited("fuzz_multihost.py", 0, 1, timeout_s=300)
    assert "ALL 1 SEEDS PASSED" in out and "backend=gloo" in out, out
