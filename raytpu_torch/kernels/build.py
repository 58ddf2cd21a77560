"""Build and bind the port's CUDA kernels (``csrc/*.cu``).

``nvcc`` compiles each source in its own process, all at once, and links
the objects into one shared library with a plain C interface, which
``ctypes`` loads.  The library goes to ``build/raytpu_torch/`` at the
repository root, named by a hash of the sources, the shared header and the
flags, so a changed source builds anew and an unchanged one is reused.  The
build happens at first use; nothing here runs at import.
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
SOURCES = (CSRC / "walk.cu", CSRC / "subwalk.cu", CSRC / "mxuwalk.cu")
HEADERS = (CSRC / "walk_common.cuh",)
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "raytpu_torch"
# -fmad=false: no a*b+c contracts to an FMA, so the kernels round exactly
# like the plain PyTorch walk they are held against.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I = ctypes.c_void_p, ctypes.c_int
# Rays, tile, cluster tables and sizes, then each entry point's own.
_COMMON = [_P, _P, _P, _P, _P, _I, _I, _P, _P, _P, _P, _I, _I]
# The prepick walk's: rays, tile, root, aabb, block, sizes; cull, picks.
_PREPICK = [_P, _P, _P, _P, _P, _I, _I, _P, _P, _P, _I, _I, _I, _I]
# The group walk's: rays, tile, root, aabb, block, sizes, sub_aabb,
# sub_plane, subk.
_GROUP = [_P, _P, _P, _P, _P, _I, _I, _P, _P, _P, _I, _I, _P, _P, _I]
# The tensor-core walk's: rays, tile, root, aabb, plane, gblock, sizes.
_MXU = [_P, _P, _P, _P, _P, _I, _I, _P, _P, _P, _P, _I, _I]
_SIGNATURES = {
    # tri_shade, cull, pretest, recull_every, max_trips, t, code, u, v, tri,
    # rows, resolved, iters, tests, ray_tests, stream
    "rt_nearest_hit": _COMMON + [_P, _I, _I, _I, _I] + [_P] * 11,
    # cull, pretest, recull_every, max_trips, t, code, resolved, iters,
    # tests, ray_tests, stream
    "rt_any_hit": _COMMON + [_I, _I, _I, _I] + [_P] * 7,
    # t, code, u, v, tri, resolved, iters, tests, ray_tests, stream
    "rt_prepick_nearest": _PREPICK + [_P] * 10,
    # t, code, resolved, iters, tests, ray_tests, stream
    "rt_prepick_any_hit": _PREPICK + [_P] * 7,
    # tri_shade, cull, pretest, recull_every, max_trips, chunk_k, gate, t,
    # code, u, v, tri, rows, resolved, iters, tests, ray_tests, stream
    "rt_subwalk_nearest": _GROUP + [_P] + [_I] * 6 + [_P] * 11,
    # cull, pretest, recull_every, max_trips, chunk_k, gate, t, code,
    # resolved, iters, tests, ray_tests, stream
    "rt_subwalk_any_hit": _GROUP + [_I] * 6 + [_P] * 7,
    # tri_shade, cull, pretest, recull_every, max_trips, chunk_k, highest,
    # t, code, u, v, tri, rows, resolved, iters, tests, ray_tests, stream
    "rt_mxu_nearest": _MXU + [_P] + [_I] * 6 + [_P] * 11,
    # cull, pretest, recull_every, max_trips, chunk_k, highest, t, code,
    # resolved, iters, tests, ray_tests, stream
    "rt_mxu_any_hit": _MXU + [_I] * 6 + [_P] * 7,
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
    for src in SOURCES + HEADERS:
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libraytpu_walk-{h.hexdigest()[:16]}.so"


def build_library():
    """Compile the sources unless the library for them exists: one ``nvcc``
    per source, started together, then one link.

    Returns ``(path, seconds, log)``: the compilers' output (``-Xptxas -v``
    registers, shared memory and spills per kernel) when they ran, else
    ``""``."""
    path = library_path()
    if path.exists():
        return path, 0.0, ""
    path.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=path.parent) as tmp:
        objs = [Path(tmp) / (src.stem + ".o") for src in SOURCES]
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(SOURCES, objs)]
        logs = [proc.communicate()[0] for proc in procs]
        for src, proc, log in zip(SOURCES, procs, logs):
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed on {src.name} ({proc.returncode}):\n{log}")
        lib = Path(tmp) / path.name
        link = subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
             "-o", str(lib), *map(str, objs)],
            capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                               f"{link.stdout}{link.stderr}")
        os.replace(lib, path)
    return path, time.perf_counter() - t0, "".join(logs)


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
