"""ntHash in the simd-minimizers crate's form: the hash of a k-mer is the
XOR over j of rotl32(T[c_(i+j)], (j + 23) mod 32), with T below indexed by
the 2-bit code (A 0, C 1, T 2, G 3); a canonical hash XORs in the hash of
the reverse complement (the complement of code c is c ^ 2).
"""

from __future__ import annotations

import torch

TABLE = (0x62A02B4C, 0x82572324, 0x95C60474, 0x4BE24456)  # by 2-bit code A, C, T, G
ROT = 23
OPS_PER_KMER = 3  # a rolling hash: rotate, xor out, xor in
PROGRAM_HASHER = "NtHasher"  # the class of the program that computes it
_LOW32 = 0xFFFF_FFFF
_tables = {}


def _rotl32(x: int, r: int) -> int:
    r %= 32
    return ((x << r) | (x >> (32 - r))) & _LOW32 if r else x


def _table(k: int, device) -> torch.Tensor:
    """(2, k, 4) int64: T[c] rotated for char j of a k-mer, and for the
    complement read in reverse."""
    key = (k, str(device))
    if key not in _tables:
        fwd = [[_rotl32(TABLE[c], j + ROT) for c in range(4)] for j in range(k)]
        rc = [[_rotl32(TABLE[c ^ 2], k - 1 - j + ROT) for c in range(4)] for j in range(k)]
        _tables[key] = torch.tensor([fwd, rc], dtype=torch.int64, device=device)
    return _tables[key]


def kmer_hashes(codes: torch.Tensor, k: int, canonical: bool) -> torch.Tensor:
    """(B, L - k + 1) int64 holding the u32 hash of each k-mer of each row
    of the (B, L) int64 code matrix."""
    B, L = codes.shape
    nk = L - k + 1
    tab = _table(k, codes.device)
    h = torch.zeros((B, nk), dtype=torch.int64, device=codes.device)
    for j in range(k):
        h ^= tab[0, j][codes[:, j:j + nk]]
        if canonical:
            # char j of the reverse complement is the complement of char k - 1 - j
            h ^= tab[1, j][codes[:, j:j + nk]]
    return h
