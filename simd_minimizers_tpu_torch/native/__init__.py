"""The port's native host helpers: the byte work of FASTA, packing and
k-mer values in C++.

The port's own copy of what it needs of the JAX package's `native/`:
`pack_ascii` (ASCII to 2-bit codes and ambiguity flags), `pack_2bit` (codes
4 to a byte), `fasta_scan` (one pass over a FASTA file's bytes) and
`kmer_values_u64` (one pass over the k codes at each position instead of
NumPy's (m, k) index-matrix gather). `packseq.cpp` is compiled at first
use with `g++ -O3` into `build/torch_native/` at the root of the checkout,
named by a hash of the source and flags, and loaded with ctypes. A failed
build raises: there is no fallback to NumPy (the NumPy forms are kept for
the tests only: `seq/packed.pack_2bit_plain`, `seq/fasta.fasta_scan_plain`).
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
_P, _N, _I64 = ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int64
_SIGNATURES = {
    "pack_ascii": ([_P, _N, _P, _P], None),
    "pack_2bit": ([_P, _N, _P], None),
    "fasta_headers": ([_P, _N], _I64),
    "fasta_scan": ([_P, _N, _P, _P, _P, _I64], _I64),
    "kmer_values_u64": ([_P, _P, _I64, _I64, ctypes.c_int, _P], None),
}


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
            raise RuntimeError("g++ not found: the native host helpers cannot be built")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        res = subprocess.run([gxx, *FLAGS, "-o", str(tmp), str(SOURCE)], capture_output=True,
                             text=True)
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed ({res.returncode}):\n{res.stdout}{res.stderr}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, restype
    _lib = lib
    return lib


def _bytes(a) -> np.ndarray:
    """A flat, contiguous uint8 array of `a`'s values (a wider dtype is
    cast by value, as NumPy casts it)."""
    return np.ascontiguousarray(np.asarray(a).reshape(-1), np.uint8)


def pack_ascii(ascii_arr) -> tuple[np.ndarray, np.ndarray]:
    """(codes, ambiguous) of ASCII bytes, uint8 each: codes (c >> 1) & 3,
    ambiguous 1 for every byte but ACGTacgt."""
    src = _bytes(ascii_arr)
    codes = np.empty(src.size, np.uint8)
    amb = np.empty(src.size, np.uint8)
    if src.size:
        library().pack_ascii(src.ctypes.data, src.size, codes.ctypes.data, amb.ctypes.data)
    return codes, amb


def pack_2bit(codes) -> np.ndarray:
    """2-bit codes (uint8, 0..3) packed 4 to a byte, base i at bits
    2 * (i % 4) of byte i // 4; ceil(n / 4) bytes."""
    src = _bytes(codes)
    out = np.zeros((src.size + 3) // 4, np.uint8)
    if src.size:
        library().pack_2bit(src.ctypes.data, src.size, out.ctypes.data)
    return out


def fasta_scan(buf) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(codes, ambiguous, starts) of a FASTA file's bytes in one pass:
    record i is codes[starts[i]:starts[i + 1]] (uint8 2-bit codes;
    ambiguous the same span of 0/1 flags; starts int64). The record table
    is sized by the header lines, counted first, plus one for sequence
    before the first header. codes and ambiguous are views of buffers of
    the file's size."""
    src = _bytes(buf)
    lib = library()
    max_records = int(lib.fasta_headers(src.ctypes.data, src.size)) + 1
    codes = np.empty(src.size, np.uint8)
    amb = np.empty(src.size, np.uint8)
    starts = np.empty(max_records + 1, np.int64)
    nrec = lib.fasta_scan(src.ctypes.data, src.size, codes.ctypes.data, amb.ctypes.data,
                          starts.ctypes.data, max_records)
    if nrec < 0:
        raise ValueError("too many FASTA records")
    total = int(starts[nrec])
    return codes[:total], amb[:total], starts[:nrec + 1].copy()


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
