"""Build and bind the port's CUDA kernels (``csrc/*.cu``).

``nvcc`` compiles the sources into one shared library with a plain C
interface, which ``ctypes`` loads.  The library goes to
``build/raytpu_torch/`` at the repository root, named by a hash of the
sources and flags, so a changed source builds anew and an unchanged one is
reused.  The build happens at first use; nothing here runs at import.
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

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (CSRC / "walk.cu",)
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "raytpu_torch"
# -fmad=false: no a*b+c contracts to an FMA, so the kernels round exactly
# like the plain PyTorch walk they are held against.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I = ctypes.c_void_p, ctypes.c_int
# Rays, tile, cluster tables and sizes, then each entry point's own.
_COMMON = [_P, _P, _P, _P, _P, _I, _I, _P, _P, _P, _P, _I, _I]
_SIGNATURES = {
    # tri_shade, cull, pretest, recull_every, t, code, u, v, tri, rows,
    # iters, tests, ray_tests, stream
    "rt_nearest_hit": _COMMON + [_P, _I, _I, _I] + [_P] * 10,
    # cull, pretest, recull_every, t, code, iters, tests, ray_tests, stream
    "rt_any_hit": _COMMON + [_I, _I, _I] + [_P] * 6,
}

_library = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path() -> Path:
    h = hashlib.sha256()
    for src in SOURCES:
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libraytpu_walk-{h.hexdigest()[:16]}.so"


def build_library():
    """Compile the sources unless the library for them exists.

    Returns ``(path, seconds, log)``: the compiler's output (``-Xptxas -v``
    registers, shared memory and spills per kernel) when it ran, else
    ``""``."""
    path = library_path()
    if path.exists():
        return path, 0.0, ""
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=path.parent)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, SOURCES)],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path, time.perf_counter() - t0, proc.stdout + proc.stderr


def load_library():
    """The kernels' ctypes library, built on first use."""
    global _library
    if _library is None:
        path, _, _ = build_library()
        lib = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.rt_error_string.argtypes = [ctypes.c_int]
        lib.rt_error_string.restype = ctypes.c_char_p
        _library = lib
    return _library
