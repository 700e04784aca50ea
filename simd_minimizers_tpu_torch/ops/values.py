"""Vectorized kmer-value extraction on the host (the `Output::values_*`
equivalents).

The port's own copy of `simd_minimizers_tpu/ops/values.py`. Value
convention pinned by the reference doc-test (the crate's src/lib.rs:117-129):
first base in the lowest bits, 2 bits per char for DNA; general text
(`&[u8]`) packs 8 bits per char. Canonical values are min(fwd, revcomp)
(the crate's src/lib.rs:598-612); the complement of a code is ``c ^ 2`` (in
the 2-bit space for DNA; applied to the raw byte for text, as canonical
hashing does).

2-bit u64 values, forward and canonical, go to the port's native C++
extractor (`native/`, as the JAX package sends them to its own): one pass
per position instead of an (m, k) index-matrix build. Text and u128 values
stay in vectorized NumPy, materialized as (lo, hi) u64 limb arrays, with
Python-int lists built only on explicit request. Values on the card are
`ops/device_values.py`.
"""

from __future__ import annotations

import numpy as np

from .. import native

# positions are processed in blocks so the (m, length) gather matrix stays
# bounded (~VALUE_CHUNK * 64 bytes) even at genome scale
VALUE_CHUNK = 1 << 22


def _gather_windows(codes: np.ndarray, positions: np.ndarray, length: int) -> np.ndarray:
    idx = positions.astype(np.int64)[:, None] + np.arange(length, dtype=np.int64)[None, :]
    return codes[idx]  # (m, length) uint8


def _chunked(fn, positions: np.ndarray):
    """Apply fn to position blocks; concat (memory-bounded vectorization)."""
    if positions.size <= VALUE_CHUNK:
        return fn(positions)
    parts = [fn(positions[s : s + VALUE_CHUNK])
             for s in range(0, positions.size, VALUE_CHUNK)]
    return np.concatenate(parts, axis=-1)


def _pack_u64(win: np.ndarray, bits: int) -> np.ndarray:
    """Pack (m, length) chars into u64, char i at bits ``bits*i``."""
    length = win.shape[1]
    shifts = (bits * np.arange(length, dtype=np.uint64))[None, :]
    return (win.astype(np.uint64) << shifts).sum(axis=1, dtype=np.uint64)


def kmer_values_u64(codes: np.ndarray, positions: np.ndarray, length: int,
                    bits: int = 2) -> np.ndarray:
    """uint64 packed values of length-`length` kmers at `positions`."""
    assert bits * length <= 64, f"values_u64 requires {bits}*length <= 64"
    if positions.size == 0:
        return np.zeros(0, dtype=np.uint64)
    if bits == 2:
        return native.kmer_values_u64(codes, positions, length, canonical=False)
    return _chunked(
        lambda p: _pack_u64(_gather_windows(codes, p, length), bits), positions)


def revcomp_kmer_values_u64(codes: np.ndarray, positions: np.ndarray, length: int,
                            bits: int = 2) -> np.ndarray:
    assert bits * length <= 64
    if positions.size == 0:
        return np.zeros(0, dtype=np.uint64)
    return _chunked(
        lambda p: _pack_u64((_gather_windows(codes, p, length) ^ np.uint8(2))[:, ::-1], bits),
        positions)


def canonical_kmer_values_u64(codes: np.ndarray, positions: np.ndarray, length: int,
                              bits: int = 2) -> np.ndarray:
    if bits == 2 and positions.size:
        return native.kmer_values_u64(codes, positions, length, canonical=True)
    return np.minimum(
        kmer_values_u64(codes, positions, length, bits),
        revcomp_kmer_values_u64(codes, positions, length, bits),
    )


def _limbs(codes: np.ndarray, positions: np.ndarray, length: int,
           revcomp: bool, bits: int) -> tuple[np.ndarray, np.ndarray]:
    """(lo, hi) u64 limb arrays of packed kmer values (bits*length <= 128)."""
    assert bits * length <= 128, f"values_u128 requires {bits}*length <= 128"
    if positions.size == 0:
        return np.zeros(0, np.uint64), np.zeros(0, np.uint64)

    def block(p):
        win = _gather_windows(codes, p, length)
        if revcomp:
            win = (win ^ np.uint8(2))[:, ::-1]
        lo_len = min(length, 64 // bits)
        lo = _pack_u64(win[:, :lo_len], bits)
        if length > lo_len:
            hi = _pack_u64(win[:, lo_len:], bits)
        else:
            hi = np.zeros_like(lo)
        return np.stack([lo, hi])  # (2, m): rides _chunked's concat on axis -1

    both = _chunked(block, positions)
    return both[0], both[1]


def kmer_values_u128_limbs(codes: np.ndarray, positions: np.ndarray, length: int,
                           bits: int = 2) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized (lo, hi) u64 limbs — the scalable form of values_u128."""
    return _limbs(codes, positions, length, revcomp=False, bits=bits)


def canonical_kmer_values_u128_limbs(
    codes: np.ndarray, positions: np.ndarray, length: int, bits: int = 2
) -> tuple[np.ndarray, np.ndarray]:
    flo, fhi = _limbs(codes, positions, length, revcomp=False, bits=bits)
    rlo, rhi = _limbs(codes, positions, length, revcomp=True, bits=bits)
    # lexicographic (hi, lo) min, fully vectorized
    take_r = (rhi < fhi) | ((rhi == fhi) & (rlo < flo))
    return np.where(take_r, rlo, flo), np.where(take_r, rhi, fhi)


def limbs_to_ints(lo: np.ndarray, hi: np.ndarray) -> list[int]:
    # object-array arithmetic: elementwise in C, no Python-level loop
    return ((hi.astype(object) << 64) | lo.astype(object)).tolist()


def kmer_values_u128(codes: np.ndarray, positions: np.ndarray, length: int,
                     bits: int = 2) -> list[int]:
    return limbs_to_ints(*kmer_values_u128_limbs(codes, positions, length, bits))


def canonical_kmer_values_u128(codes: np.ndarray, positions: np.ndarray, length: int,
                               bits: int = 2) -> list[int]:
    return limbs_to_ints(
        *canonical_kmer_values_u128_limbs(codes, positions, length, bits)
    )
