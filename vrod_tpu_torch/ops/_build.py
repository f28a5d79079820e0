"""Build and bind the port's CUDA kernels (``vrod_tpu_torch/csrc``).

``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a`` (one compiler process
per source, all started together) and links them into one shared library
with a plain C interface, named by a hash of the sources, headers and flags,
under ``csrc/build/`` (ignored by git). The build publishes atomically
(compile into a temp dir, then ``os.replace``), so concurrent builders never
load a half-written file. There is no fallback: a missing ``nvcc`` or a
failed compile raises, with the compiler's output. ``defines`` (extra
``-D`` flags) build a variant beside the default library, for the
measurement scripts under ``tools/``, which may also build it from some of
the sources alone (``sources``: file names; such a library holds only
their entry points, and the scripts bind those themselves); the port
itself always loads the default.

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
import time
from pathlib import Path

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = _CSRC / "build"

# No --use_fast_math; --fmad=false keeps every multiply and add rounded on
# its own (the kernels also use __fmul_rn/__fadd_rn explicitly).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "--fmad=false", "-Xptxas", "-v")

_libs: dict[tuple[str, ...], ctypes.CDLL] = {}

# The extraction modes, one csrc/extract_<mode>.cu each (and its copying
# build, csrc/extract_<mode>_copy.cu).
EXTRACT_MODES = ("floor", "store", "gate", "unroll", "pingpong", "carry")


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


def _sources(names: tuple[str, ...] = ()) -> list[Path]:
    return sorted(p for p in _CSRC.glob("*.cu")
                  if not names or p.name in names)


def _flags(defines: tuple[str, ...]) -> tuple[str, ...]:
    return NVCC_FLAGS + tuple(f"-D{d}" for d in defines)


def library_path(defines: tuple[str, ...] = (),
                 sources: tuple[str, ...] = ()) -> Path:
    h = hashlib.sha256()
    for p in sorted(_CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(_flags(defines)).encode())
    if sources:
        h.update(" ".join(sorted(sources)).encode())
    return BUILD_DIR / f"libvrodkernels-{h.hexdigest()[:16]}.so"


def build(defines: tuple[str, ...] = (),
          sources: tuple[str, ...] = ()) -> Path:
    """Compile the kernels (of ``sources`` alone if given), with ``-D`` for
    each of ``defines``, unless this exact build exists; return its path. The compiler's output (``-Xptxas
    -v``: registers, shared memory, spills per kernel) and each source's
    compile time (``nvcc <source>: <s> s``) are kept beside the library as
    ``<name>.log``."""
    out = library_path(defines, sources)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        srcs = _sources(sources)
        objs = [Path(tmp) / (src.stem + ".o") for src in srcs]
        cmds = [[nvcc, *_flags(defines), "-c", "-o", str(obj), str(src)]
                for src, obj in zip(srcs, objs)]
        outs = [Path(tmp) / (src.stem + ".out") for src in srcs]
        t0 = time.monotonic()
        procs = []
        for cmd, out_path in zip(cmds, outs):
            with open(out_path, "w") as fh:
                procs.append(subprocess.Popen(cmd, stdout=fh,
                                              stderr=subprocess.STDOUT))
        log, failed, secs = "", [], {}
        try:
            # Poll (the outputs go to files, so no pipe can fill): each
            # source's compile time goes to the log.
            while len(secs) < len(procs):
                if time.monotonic() - t0 > 900:
                    raise RuntimeError("nvcc took over 900 s")
                for i, proc in enumerate(procs):
                    if i not in secs and proc.poll() is not None:
                        secs[i] = time.monotonic() - t0
                time.sleep(0.05)
            for i, (cmd, proc) in enumerate(zip(cmds, procs)):
                log += outs[i].read_text()
                log += f"nvcc {srcs[i].name}: {secs[i]:.1f} s\n"
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


def bind_floor(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Bind the scan from a floor's entry of ``lib`` (the whole library,
    or a build of ``fused_topk_floor.cu`` alone): vrod_fused_topk's
    arguments without on_chip and ring."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.vrod_fused_topk_floor.restype = ci
    lib.vrod_fused_topk_floor.argtypes = [ci] * 3 + [vp] * 7 + [ci] * 8 \
        + [vp] * 7
    return lib


def load(defines: tuple[str, ...] = ()) -> ctypes.CDLL:
    """The bound kernel library built with ``defines``, built on first
    use."""
    defines = tuple(defines)
    if defines in _libs:
        return _libs[defines]
    lib = ctypes.CDLL(str(build(defines)))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    # (elem, epi, granule, x, aux, valid, bias, q, q_scale, theta0, n,
    #  row_bytes, b, k, offset, groups, parts, cap, on_chip, ring, scratch,
    #  out_v, out_i, x_map, q_map, q_hi_map, stream); granule: 16 for TMA,
    #  else the copy's (cuda_topk.copy_granule)
    lib.vrod_fused_topk.restype = ci
    lib.vrod_fused_topk.argtypes = [ci] * 3 + [vp] * 7 + [ci] * 10 \
        + [vp] * 7
    # The small scan: (elem, epi, granule, x, aux, valid, bias, q, q_scale,
    #  theta0, n, row_bytes, b, k, offset, groups, parts, cap, out_v,
    #  out_i, x_map, q_map, q_hi_map, stream)
    lib.vrod_fused_topk_small.restype = ci
    lib.vrod_fused_topk_small.argtypes = [ci] * 3 + [vp] * 7 + [ci] * 8 \
        + [vp] * 6
    bind_floor(lib)
    # K1's ring depth; a long-scan block's shared memory (ring, cap,
    # on_chip, split: the f32x3 legs')
    lib.vrod_k1_ring.restype = ci
    lib.vrod_k1_ring.argtypes = []
    lib.vrod_topk_smem.restype = ci
    lib.vrod_topk_smem.argtypes = [ci] * 4
    # The scan from a floor's block at top-k (k)
    lib.vrod_topk_floor_smem.restype = ci
    lib.vrod_topk_floor_smem.argtypes = [ci]
    # (elem, epi, granule, x, aux, valid, bias, q, q_scale, n, row_bytes, b,
    #  blk, width, spb, groups, out, x_map, q_map, q_hi_map, stream)
    lib.vrod_sampled_submax.restype = ci
    lib.vrod_sampled_submax.argtypes = [ci] * 3 + [vp] * 6 + [ci] * 7 \
        + [vp] * 5
    # (out, base, inner, outer, stride, box_outer): one tensor map
    lib.vrod_encode_map.restype = ci
    lib.vrod_encode_map.argtypes = [vp, vp, ci, ctypes.c_long,
                                    ctypes.c_long, ci]
    # (elem, epi, granule, x, aux, mask, q, qs2, margin, n, row_bytes, b, k,
    #  offset, groups, parts, cap, on_chip, ring, sample_tiles, blk_tiles,
    #  iters, skip, 10 scratch/output pointers, stream)
    lib.vrod_fused_theta.restype = ci
    lib.vrod_fused_theta.argtypes = [ci] * 3 + [vp] * 6 + [ci] * 14 \
        + [vp] * 11
    # (granule, x, aux, valid, q, theta0, n, row_bytes, b, k, offset, groups,
    #  parts, cap, on_chip, ring, scratch, out_v, out_i, stream)
    lib.vrod_fused_intgate.restype = ci
    lib.vrod_fused_intgate.argtypes = [ci] + [vp] * 5 + [ci] * 10 \
        + [vp] * 4
    # X9 from a floor: the same without on_chip and ring.
    lib.vrod_fused_intgate_floor.restype = ci
    lib.vrod_fused_intgate_floor.argtypes = [ci] + [vp] * 5 + [ci] * 8 \
        + [vp] * 4
    # The extraction experiments X1-X4, one entry point per mode file and
    # build (csrc/extract.cuh: VROD_EXTRACT_PARAMS; vrod_extract_<mode> the
    # TMA build, vrod_extract_<mode>_copy the copying one,
    # extract_<mode>_copy.cu): (elem, epi, variant, x, aux, mask, q,
    # offset, n, row_bytes, b, k, groups, parts, cap, block_rows, count,
    # on_chip, stage, granule, 8 scratch/output pointers, stream)
    for mode in EXTRACT_MODES:
        for copy in ("", "_copy"):
            fn = getattr(lib, f"vrod_extract_{mode}{copy}")
            fn.restype = ci
            fn.argtypes = [ci] * 3 + [vp] * 5 + [ci] * 12 + [vp] * 9
    # The carry's, the store's and the gated kernels' whole shared memory
    # a block in each build (vrod_extract_<mode>[_copy]_smem): (k, stage,
    # on_chip, split), (cap, on_chip, split) and (cap, on_chip, split);
    # split: the f32x3 legs'
    for mode, n in (("carry", 4), ("store", 3), ("gate", 3)):
        for copy in ("", "_copy"):
            fn = getattr(lib, f"vrod_extract_{mode}{copy}_smem")
            fn.restype = ci
            fn.argtypes = [ci] * n
    _libs[defines] = lib
    return lib
