"""Build and load the CUDA kernels of `csrc/` on first use.

`nvcc` compiles the sources into a shared library with a plain C
interface, loaded with ctypes. `--split-compile=0` lets it optimise the
kernel instances on all host cores at once: one translation unit with
every minimizer_tiles instance builds in about 4 s instead of 8 s on the
H100 host. The library lands in `build/torch_kernels/`
at the root of the checkout, named by a hash of the sources and flags, so
an edited source is rebuilt and an unchanged one is loaded as it is. A
failed build raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
SOURCES = (CSRC / "minimizers.cu",)
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--split-compile=0", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_SIGNATURES = {
    "smt_tile_windows": ([], _I),
    "smt_init": ([_I], _I),
    "smt_minimizer_tiles": ([_I, _P, _LL, _I, _I, _I, _I, _I, _I, _I, _I, _P, _I, _P, _LL, _I,
                             _I, ctypes.c_uint, _P, _P, _I, _P], _I),
    "smt_tile_offsets": ([_I, _P, _I, _P, _P], _I),
    "smt_tile_append": ([_I, _P, _P, _P, _I, _I, _P, _P], _I),
}

_lib = None
build_seconds = None  # wall time of the build (or load) that produced _lib
build_log = ""  # nvcc's output (-Xptxas -v: registers, shared memory, spills)


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built from the sources if needed."""
    global _lib, build_seconds, build_log
    if _lib is not None:
        return _lib
    t0 = time.perf_counter()
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        digest.update(src.read_bytes())
    so = BUILD_DIR / f"libsmt_kernels_{digest.hexdigest()[:16]}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        res = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, SOURCES)],
                             capture_output=True, text=True)
        build_log = res.stdout + res.stderr
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n{build_log}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    _lib = lib
    build_seconds = time.perf_counter() - t0
    return lib
