"""Build and bind the port's CUDA kernels (``vrod_tpu_torch/csrc``).

``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a`` (one compiler process
per source, all started together) and links them into one shared library
with a plain C interface, named by a hash of the sources, headers and flags,
under ``csrc/build/`` (ignored by git). The build publishes atomically
(compile into a temp dir, then ``os.replace``), so concurrent builders never
load a half-written file. There is no fallback: a missing ``nvcc`` or a
failed compile raises, with the compiler's output. ``defines`` (extra
``-D`` flags) build a variant beside the default library, for the
measurement scripts under ``tools/``; the port itself always loads the
default.

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
              "-O3", "-Xcompiler", "-fPIC", "--fmad=false", "-Xptxas", "-v")

_libs: dict[tuple[str, ...], ctypes.CDLL] = {}


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


def _flags(defines: tuple[str, ...]) -> tuple[str, ...]:
    return NVCC_FLAGS + tuple(f"-D{d}" for d in defines)


def library_path(defines: tuple[str, ...] = ()) -> Path:
    h = hashlib.sha256()
    for p in sorted(_CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(_flags(defines)).encode())
    return BUILD_DIR / f"libvrodkernels-{h.hexdigest()[:16]}.so"


def build(defines: tuple[str, ...] = ()) -> Path:
    """Compile the kernels, with ``-D`` for each of ``defines``, unless this
    exact build exists; return its path. The compiler's output (``-Xptxas
    -v``: registers, shared memory, spills per kernel) is kept beside the
    library as ``<name>.log``."""
    out = library_path(defines)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        srcs = _sources()
        objs = [Path(tmp) / (src.stem + ".o") for src in srcs]
        cmds = [[nvcc, *_flags(defines), "-c", "-o", str(obj), str(src)]
                for src, obj in zip(srcs, objs)]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for cmd in cmds]
        log, failed = "", []
        try:
            for cmd, proc in zip(cmds, procs):
                log += proc.communicate(timeout=900)[0]
                if proc.returncode != 0:
                    failed.append(f"nvcc failed ({proc.returncode}): "
                                  f"{' '.join(cmd)}")
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        tmp_out = Path(tmp) / out.name
        if not failed:
            cmd = [nvcc, "-shared", "-o", str(tmp_out), *map(str, objs),
                   "-ldl"]
            res = subprocess.run(cmd, capture_output=True, text=True,
                                 timeout=300)
            log += res.stdout + res.stderr
            if res.returncode != 0:
                failed.append(f"nvcc link failed ({res.returncode}): "
                              f"{' '.join(cmd)}")
        if failed:
            raise RuntimeError("\n".join(failed) + "\n" + log)
        (Path(tmp) / "build.log").write_text(log)
        os.replace(Path(tmp) / "build.log", out.with_suffix(".log"))
        os.replace(tmp_out, out)
    return out


def load(defines: tuple[str, ...] = ()) -> ctypes.CDLL:
    """The bound kernel library built with ``defines``, built on first
    use."""
    defines = tuple(defines)
    if defines in _libs:
        return _libs[defines]
    lib = ctypes.CDLL(str(build(defines)))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    # (elem, epi, tma, x, aux, mask, q, qs2, theta0, n, row_bytes, b, k,
    #  offset, groups, parts, cap, 7 scratch/output pointers, stream)
    lib.vrod_fused_topk.restype = ci
    lib.vrod_fused_topk.argtypes = [ci] * 3 + [vp] * 6 + [ci] * 8 + [vp] * 8
    # (elem, epi, tma, x, aux, mask, q, qs2, n, row_bytes, b, blk, spb,
    #  groups, part, out, stream)
    lib.vrod_sampled_submax.restype = ci
    lib.vrod_sampled_submax.argtypes = [ci] * 3 + [vp] * 5 + [ci] * 6 \
        + [vp] * 3
    _libs[defines] = lib
    return lib
