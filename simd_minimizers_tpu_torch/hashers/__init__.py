"""K-mer hashers: the seq-hash equivalent layer of the port.

The port's own copy of `simd_minimizers_tpu/hashers/__init__.py`; a CPU
test (tests/test_torch_hashers.py) holds every hasher and the NT table
equal to the JAX package's. The reference delegates hashing to the
(unvendored) `seq-hash` crate (the crate's src/lib.rs:164-165). Its
required interface is pinned by usage (SURVEY.md §2.2): 32-bit rolling
hashes, forward and canonical (= fwd XOR hash-of-reverse-complement,
the crate's src/lib.rs:42), seedable, with NtHasher / MulHasher /
AntiLexHasher implementations.

IMPORTANT — reconstruction note.  The `seq-hash` sources are not part of the
reference checkout, so the exact table constants were *reconstructed* from
the golden doc-test vectors pinned in the reference
(the crate's src/lib.rs:92-140):

  - ``minimizer_positions(AsciiSeq(b"ACGTGCTCAGAGACTCAG"), 5, 7) == [4,5,8,13]``
  - ``canonical_minimizer_positions(b"ACGTGCTCAGAGACTCAGAGGA", 5, 7) == [0,7,9,15]``
  - reverse-complement run ``== [2,8,10,17]``

A structured search over hash schemes built from the classic 64-bit ntHash
constants (the ones the reference's own bench uses,
the crate's bench/src/nthash.rs:24-32) found exactly one family
reproducing all three vectors:

  ``h(kmer) = XOR_j rotl32(TABLE[kmer[j]], (j + 23) mod 32)``

with ``TABLE`` = low 32 bits of the classic constants, cyclically shifted in
A<C<G<T alphabetical order.  That scheme is used here.  Every *other*
semantic (top-16-bit comparisons, leftmost/rightmost tie-breaks, strand
rule, dedup) is taken from the readable reference source and is exact.
"""

from __future__ import annotations

import numpy as np

from ..utils.bits import U32, rotl32_np, splitmix64

# Low 32 bits of the classic ntHash constants
# (A,C,G,T = 0x3c8bfbb395c60474, 0x3193c18562a02b4c, 0x20323ed082572324,
#  0x295549f54be24456; the crate's bench/src/nthash.rs:24-32),
# cyclically shifted by one in alphabetical order and indexed by the 2-bit
# code (A=0, C=1, T=2, G=3). Reconstructed from the golden vectors (see
# module docstring).
NT_TABLE = np.array(
    [0x62A02B4C, 0x82572324, 0x95C60474, 0x4BE24456], dtype=np.uint32
)
# Global rotation offset of the scheme: char j of a kmer is rotated by (j+23).
NT_ROT_OFFSET = 23

# MulHash: "multiplies each character value by a pseudo-random constant"
# (the crate's src/lib.rs:71). Same rolling structure as ntHash with
# table[c] = (c+1) * MUL_CONST. The constant matches the reference's bench
# prototype (the crate's bench/src/fxhash.rs:66).
MUL_CONST = np.uint32(1234565323)


def _derive_table(seed: int, n: int = 4) -> np.ndarray:
    return np.array(
        [splitmix64((seed << 8) ^ (c + 1)) & 0xFFFFFFFF for c in range(n)],
        dtype=np.uint32,
    )


class KmerHasher:
    """Base: hashes all k-mers of a code stream to uint32."""

    kind: str = "?"

    def __init__(self, k: int, canonical: bool = False, seed: int | None = None):
        assert k >= 1
        self.k = k
        self.canonical = canonical
        self.seed = seed

    # Subclasses provide the *forward* hash of each kmer of `codes`.
    def _fwd_np(self, codes: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def hash_kmers_np(self, codes: np.ndarray) -> np.ndarray:
        """uint32 hashes of all ``len(codes) - k + 1`` k-mers.

        Canonical hashers return ``H(x) ^ H(revcomp(x))`` which is invariant
        under reverse complement (reference src/lib.rs:42).
        """
        codes = np.asarray(codes, dtype=np.uint8)
        if len(codes) < self.k:
            return np.zeros(0, dtype=np.uint32)
        h = self._fwd_np(codes)
        if self.canonical:
            rc = (codes ^ np.uint8(2))[::-1]
            h = h ^ self._fwd_np(rc)[::-1]
        return h


class NtHasher(KmerHasher):
    kind = "nt"

    def __init__(self, k: int, canonical: bool = False, seed: int | None = None):
        super().__init__(k, canonical, seed)
        self.table = NT_TABLE if seed is None else _derive_table(seed)
        self.rot_offset = NT_ROT_OFFSET

    def _fwd_np(self, codes: np.ndarray) -> np.ndarray:
        k = self.k
        nk = len(codes) - k + 1
        # DNA hashers operate on the 2-bit code space; general text is
        # folded with & 3 (the reference recommends MulHasher for text).
        c = (codes & 3).astype(np.uint8)
        h = np.zeros(nk, dtype=np.uint32)
        for j in range(k):
            h ^= rotl32_np(self.table[c[j : j + nk]], j + self.rot_offset)
        return h


class MulHasher(KmerHasher):
    """Multiply each character by a constant; same rolling structure."""

    kind = "mul"

    def __init__(self, k: int, canonical: bool = False, seed: int | None = None):
        super().__init__(k, canonical, seed)
        self.mul_const = (
            MUL_CONST if seed is None else np.uint32((splitmix64(seed) & 0xFFFFFFFF) | 1)
        )
        self.rot_offset = NT_ROT_OFFSET

    def _fwd_np(self, codes: np.ndarray) -> np.ndarray:
        k = self.k
        nk = len(codes) - k + 1
        vals = ((codes.astype(np.uint32) + U32(1)) * self.mul_const).astype(np.uint32)
        h = np.zeros(nk, dtype=np.uint32)
        for j in range(k):
            h ^= rotl32_np(vals[j : j + nk], j + self.rot_offset)
        return h


class AntiLexHasher(KmerHasher):
    """Order k-mers anti-lexicographically.

    The hash is the bitwise NOT of the kmer's first min(k,16) characters
    packed MSB-first, so that smaller hash == lexicographically larger kmer
    prefix (reconstruction; only used by the reference's tests, see
    the crate's src/test.rs:6).
    """

    kind = "antilex"

    def _fwd_np(self, codes: np.ndarray) -> np.ndarray:
        k = self.k
        nk = len(codes) - k + 1
        c = (codes & 3).astype(np.uint32)
        la = np.zeros(nk, dtype=np.uint32)
        for j in range(min(k, 16)):
            la |= (c[j : j + nk] << U32(30 - 2 * j)).astype(np.uint32)
        return (~la).astype(np.uint32)


def default_hasher(k: int, canonical: bool) -> NtHasher:
    return NtHasher(k, canonical=canonical)
