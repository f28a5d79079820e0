"""Build and bind the port's CUDA kernels (``vrod_tpu_torch/csrc``).

``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a`` into one shared library
with a plain C interface, named by a hash of the sources, headers and flags,
under ``csrc/build/`` (ignored by git). The build publishes atomically
(compile into a temp dir, then ``os.replace``), so concurrent builders never
load a half-written file. There is no fallback: a missing ``nvcc`` or a
failed compile raises, with the compiler's output.

The library is bound with ``ctypes``: pointers and the stream go as
``c_void_p`` (a bare Python int would be cut to 32 bits), and every entry
point returns ``cudaGetLastError()`` after its launches.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = _CSRC / "build"

# No --use_fast_math; --fmad=false keeps every multiply and add rounded on
# its own (the kernels also use __fmul_rn/__fadd_rn explicitly).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "--fmad=false",
              "-Xptxas", "-v")

_lib = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [str(Path(home) / "bin" / "nvcc")] if home else []
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and Path(c).is_file():
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the CUDA kernels of vrod_tpu_torch "
        "are built from source on first use")


def _sources() -> list[Path]:
    return sorted(_CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256()
    for p in sorted(_CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libvrodkernels-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless this exact build exists; return its path.
    The compiler's output (``-Xptxas -v``: registers, shared memory, spills
    per kernel) is kept beside the library as ``<name>.log``."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        tmp_out = Path(tmp) / out.name
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp_out),
               *map(str, _sources())]
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=900)
        log = res.stdout + res.stderr
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({res.returncode}): {' '.join(cmd)}\n{log}")
        (Path(tmp) / "build.log").write_text(log)
        os.replace(Path(tmp) / "build.log", out.with_suffix(".log"))
        os.replace(tmp_out, out)
    return out


def load() -> ctypes.CDLL:
    """The bound kernel library, built on first use."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    ip = ctypes.POINTER(ctypes.c_int)
    lib.vrod_fused_topk_plan.restype = ci
    lib.vrod_fused_topk_plan.argtypes = [ci, ci, ci, ip]
    lib.vrod_fused_topk_i8.restype = ci
    lib.vrod_fused_topk_i8.argtypes = (
        [vp] * 5 + [ci] * 8 + [vp] * 8)
    lib.vrod_sampled_submax_plan.restype = ci
    lib.vrod_sampled_submax_plan.argtypes = [ci, ci, ci, ip]
    lib.vrod_sampled_submax_i8.restype = ci
    lib.vrod_sampled_submax_i8.argtypes = [vp] * 4 + [ci] * 5 + [vp] * 3
    _lib = lib
    return lib
