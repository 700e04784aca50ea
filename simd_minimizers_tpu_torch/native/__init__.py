"""The port's native host helper: k-mer values of 2-bit codes in C++.

The port's own copy of the value extractor of the JAX package's `native/`
(`kmer_values_u64`): one pass over the k codes at each position instead of
NumPy's (m, k) index-matrix gather. `packseq.cpp` is compiled at first use
with `g++ -O3` into `build/torch_native/` at the root of the checkout,
named by a hash of the source and flags, and loaded with ctypes. A failed
build raises: there is no fallback to NumPy.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().with_name("packseq.cpp")
BUILD_DIR = SOURCE.parents[2] / "build" / "torch_native"
FLAGS = ("-O3", "-shared", "-fPIC")

_lib = None


def library() -> ctypes.CDLL:
    """The loaded helper library, built from the source if needed."""
    global _lib
    if _lib is not None:
        return _lib
    digest = hashlib.sha256(" ".join(FLAGS).encode() + SOURCE.read_bytes()).hexdigest()[:16]
    so = BUILD_DIR / f"libsmt_native_{digest}.so"
    if not so.exists():
        gxx = shutil.which("g++")
        if gxx is None:
            raise RuntimeError("g++ not found: the native value extractor cannot be built")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        res = subprocess.run([gxx, *FLAGS, "-o", str(tmp), str(SOURCE)], capture_output=True,
                             text=True)
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed ({res.returncode}):\n{res.stdout}{res.stderr}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    lib.kmer_values_u64.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                                    ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]
    lib.kmer_values_u64.restype = None
    _lib = lib
    return lib


def kmer_values_u64(codes: np.ndarray, positions: np.ndarray, k: int,
                    canonical: bool) -> np.ndarray:
    """np.uint64 values of the k-mers of 2-bit `codes` (uint8, one code a
    byte) at `positions`, first base lowest; with `canonical` the least of
    the forward value and the reverse complement's."""
    if not 1 <= k <= 32:
        raise AssertionError("values_u64 requires 2*k <= 64")
    codes = np.ascontiguousarray(codes, np.uint8)
    positions = np.ascontiguousarray(positions, np.uint32)
    out = np.empty(positions.size, np.uint64)
    if positions.size == 0:
        return out
    if int(positions.max()) + k > codes.size:
        raise ValueError(f"a {k}-mer at position {int(positions.max())} runs past the "
                         f"{codes.size} codes")
    library().kmer_values_u64(codes.ctypes.data, positions.ctypes.data, positions.size, k,
                              int(canonical), out.ctypes.data)
    return out
