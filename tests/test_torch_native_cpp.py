"""Build and run the pure-C++ native self-test (WAL + allocator) of the port.

``tests/test_native_cpp.py`` (1 test) over ``vrod_tpu_torch/_native``:
``native_test.cpp`` there is the JAX package's self-test, compiled with
``g++`` against the port's own ``native.cpp``.
"""

import subprocess
from pathlib import Path

import pytest

NATIVE = Path(__file__).resolve().parent.parent / "vrod_tpu_torch" / "_native"


def test_native_selftest(tmp_path):
    exe = tmp_path / "native_test"
    try:
        subprocess.run(
            ["g++", "-O2", "-std=c++17", "-o", str(exe),
             str(NATIVE / "native_test.cpp"), str(NATIVE / "native.cpp")],
            check=True, capture_output=True, timeout=300)
    except FileNotFoundError:
        pytest.skip("no C++ toolchain")
    out = subprocess.run([str(exe), str(tmp_path)], capture_output=True,
                         text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert "native self-test OK" in out.stdout
