"""Bit-twiddling constants and helpers of the port's NumPy reference code.

The port's own copy of `simd_minimizers_tpu/utils/bits.py`, trimmed to
what the port uses. All minimizer arithmetic is modular 32-bit (mirroring
the reference crate's u32 hash pipeline, see
the crate's src/sliding_min.rs:104-106 for the top-16-bit comparison
convention). NumPy uint32 arrays wrap naturally.
"""

from __future__ import annotations

import numpy as np

U32 = np.uint32
VAL_MASK = np.uint32(0xFFFF_0000)  # top 16 bits of a hash participate in comparisons

# Sentinel for windows that must be skipped (ambiguous bases), identical to the
# reference (`SKIPPED = u32::MAX - 1`, the crate's src/minimizers.rs:18).
SKIPPED = np.uint32(0xFFFF_FFFE)
INVALID = np.uint32(0xFFFF_FFFF)  # padding marker, like the reference's u32::MAX padding


def rotl32_np(x: np.ndarray, r: int) -> np.ndarray:
    """Rotate-left each uint32 element by the static amount ``r``."""
    r %= 32
    if r == 0:
        return x.astype(U32, copy=False)
    x = x.astype(U32, copy=False)
    return ((x << U32(r)) | (x >> U32(32 - r))).astype(U32)


def splitmix64(x: int) -> int:
    """SplitMix64 finalizer; used to derive seeded hash tables."""
    mask = (1 << 64) - 1
    x = (x + 0x9E3779B97F4A7C15) & mask
    z = x
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & mask
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & mask
    return z ^ (z >> 31)
