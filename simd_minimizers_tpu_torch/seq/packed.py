"""Sequence containers: the packed-seq equivalent layer of the port.

The port's own copy of `simd_minimizers_tpu/seq/packed.py`, with the same
public surface. It reproduces the behavior of the `packed-seq` crate (v5) as
used by the reference (the crate's src/lib.rs:57-64):

- 2-bit DNA codes ``A=00, C=01, T=10, G=11`` (the crate's src/lib.rs:121-128).
- ``PackedSeqVec``: 4 bases/byte, base ``i`` stored at bits ``2*(i%4)`` of
  byte ``i//4``; supports slicing at non-byte offsets.
- ``AsciiSeq``: ACGT bytes; same 2-bit code stream via ``(c >> 1) & 3``.
- ``GenericSeq``: general ASCII text (``&[u8]`` in the reference), whose
  "codes" are the raw byte values.
- ``PackedNSeqVec``: packed sequence + per-base ambiguity mask (non-ACGT).

``read_kmer`` / ``read_revcomp_kmer`` return Python ints (arbitrary width,
covering the reference's u64/u128 variants), first char in the lowest bits:
2 bits a char for DNA, 8 for ``GenericSeq``; the complement is ``c ^ 2``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .. import native

# ASCII -> 2-bit code table: (c >> 1) & 3 maps A->0, C->1, T->2, G->3
# (both cases). Other characters map pseudo-randomly; ambiguity is tracked
# separately by PackedNSeqVec (as in packed-seq).
_ASCII_TO_CODE = ((np.arange(256, dtype=np.uint8) >> 1) & 3).astype(np.uint8)
_CODE_TO_ASCII = np.frombuffer(b"ACTG", dtype=np.uint8)
_IS_ACGT = np.zeros(256, dtype=bool)
for _c in b"ACGTacgt":
    _IS_ACGT[_c] = True

COMPLEMENT_XOR = 2  # complement of a 2-bit code c is c ^ 2 (A<->T, C<->G)


def complement_codes(codes: np.ndarray) -> np.ndarray:
    return (codes ^ np.uint8(COMPLEMENT_XOR)).astype(np.uint8)


def _kmer_value(codes: np.ndarray, bits: int = 2) -> int:
    """Pack chars into an int, first char in the lowest bits, `bits` per
    char (packed-seq's ``read_kmer``: CAGAG at position 7 of the crate's
    doc-test sequence is 0b11_00_11_00_01)."""
    v = 0
    for i, c in enumerate(codes.tolist()):
        v |= int(c) << (bits * i)
    return v


def _as_bytes(seq: bytes | bytearray | np.ndarray) -> np.ndarray:
    if isinstance(seq, (bytes, bytearray)):
        return np.frombuffer(bytes(seq), dtype=np.uint8)
    return np.asarray(seq, dtype=np.uint8)


def pack_2bit(codes: np.ndarray) -> np.ndarray:
    """Pack 2-bit codes 4 to a byte, base i at bits 2 * (i % 4) of byte
    i // 4: the port's native packer (`native.pack_2bit`, a copy of the JAX
    package's)."""
    return native.pack_2bit(codes)


def pack_2bit_plain(codes: np.ndarray) -> np.ndarray:
    """The NumPy form of `pack_2bit`, which the tests hold it against."""
    codes = np.asarray(codes, dtype=np.uint8)
    pad = (-codes.size) % 4
    if pad:
        codes = np.concatenate([codes, np.zeros(pad, dtype=np.uint8)])
    q = codes.reshape(-1, 4)
    return q[:, 0] | q[:, 1] << 2 | q[:, 2] << 4 | q[:, 3] << 6


class PackedSeq:
    """An immutable 2-bit packed DNA sequence (view or owned).

    ``data`` is a uint8 array of packed bytes; the sequence starts at base
    ``offset`` (0..3 within the first byte is allowed, mirroring packed-seq's
    non-byte-offset slices) and has ``length`` bases.
    """

    is_packed = True
    char_bits = 2

    def __init__(self, data: np.ndarray, offset: int = 0, length: int | None = None):
        assert data.dtype == np.uint8
        self.data = data
        self.offset = int(offset)
        if length is None:
            length = data.size * 4 - self.offset
        self.length = int(length)
        assert self.offset + self.length <= data.size * 4

    def __len__(self) -> int:
        return self.length

    def codes(self) -> np.ndarray:
        """Unpack to a uint8 array of 2-bit codes, shape (len,)."""
        nbytes = (self.offset + self.length + 3) // 4
        b = self.data[:nbytes]
        shifts = np.arange(4, dtype=np.uint8) * 2
        all_codes = ((b[:, None] >> shifts[None, :]) & 3).astype(np.uint8).reshape(-1)
        return all_codes[self.offset : self.offset + self.length]

    def slice(self, start: int, end: int) -> "PackedSeq":
        assert 0 <= start <= end <= self.length
        return PackedSeq(self.data, self.offset + start, end - start)

    def read_kmer(self, length: int, pos: int) -> int:
        return _kmer_value(self.codes()[pos : pos + length])

    def read_revcomp_kmer(self, length: int, pos: int) -> int:
        return _kmer_value(complement_codes(self.codes()[pos : pos + length])[::-1])

    def to_revcomp(self) -> "PackedSeqVec":
        return PackedSeqVec.from_codes(complement_codes(self.codes())[::-1])

    def to_ascii(self) -> bytes:
        return _CODE_TO_ASCII[self.codes()].tobytes()

    def packed_with_offset(self) -> tuple[np.ndarray, int]:
        """Packed bytes covering the sequence plus the in-byte base offset."""
        first = self.offset // 4
        last = (self.offset + self.length + 3) // 4
        return self.data[first:last], self.offset % 4

    def as_slice(self) -> "PackedSeq":
        return self


class PackedSeqVec(PackedSeq):
    """Owned packed sequence (the `PackedSeqVec` equivalent)."""

    @staticmethod
    def from_ascii(seq: bytes | np.ndarray) -> "PackedSeqVec":
        return PackedSeqVec.from_codes(_ASCII_TO_CODE[_as_bytes(seq)])

    @staticmethod
    def from_codes(codes: np.ndarray) -> "PackedSeqVec":
        """Pack 2-bit codes, 4 to a byte (base i at bits 2 * (i % 4))."""
        codes = np.asarray(codes, dtype=np.uint8)
        return PackedSeqVec(pack_2bit(codes), 0, codes.size)

    @staticmethod
    def random(n: int, rng: np.random.Generator | None = None) -> "PackedSeqVec":
        rng = rng or np.random.default_rng()
        return PackedSeqVec.from_codes(rng.integers(0, 4, size=n, dtype=np.uint8))


class AsciiSeq:
    """DNA given as ACGT ASCII bytes (the `AsciiSeq` equivalent)."""

    is_packed = False
    char_bits = 2

    def __init__(self, seq: bytes | np.ndarray):
        self.seq = _as_bytes(seq)

    def __len__(self) -> int:
        return self.seq.size

    def codes(self) -> np.ndarray:
        return _ASCII_TO_CODE[self.seq]

    def slice(self, start: int, end: int) -> "AsciiSeq":
        return AsciiSeq(self.seq[start:end])

    def read_kmer(self, length: int, pos: int) -> int:
        return _kmer_value(self.codes()[pos : pos + length])

    def read_revcomp_kmer(self, length: int, pos: int) -> int:
        return _kmer_value(complement_codes(self.codes()[pos : pos + length])[::-1])

    def to_revcomp(self) -> "AsciiSeq":
        return AsciiSeq(_CODE_TO_ASCII[complement_codes(self.codes())[::-1]])

    def as_slice(self) -> "AsciiSeq":
        return self

    @staticmethod
    def random(n: int, rng: np.random.Generator | None = None) -> "AsciiSeq":
        rng = rng or np.random.default_rng()
        return AsciiSeq(_CODE_TO_ASCII[rng.integers(0, 4, size=n, dtype=np.uint8)])


AsciiSeqVec = AsciiSeq  # owned and view types coincide in Python


class GenericSeq:
    """General ASCII text (`&[u8]` in the reference): codes are raw bytes.

    Hashers fold chars into their scheme's space themselves (NtHasher
    masks with &3; MulHasher uses the raw byte). K-mer values pack 8 bits
    per char; the "complement" of a text char is `c ^ 2`, consistent with
    how canonical hashing treats raw codes across all tiers.
    """

    is_packed = False
    char_bits = 8

    def __init__(self, seq: bytes | np.ndarray):
        self.seq = _as_bytes(seq)

    def __len__(self) -> int:
        return self.seq.size

    def codes(self) -> np.ndarray:
        return self.seq

    def slice(self, start: int, end: int) -> "GenericSeq":
        return GenericSeq(self.seq[start:end])

    def read_kmer(self, length: int, pos: int) -> int:
        return _kmer_value(self.seq[pos : pos + length], 8)

    def read_revcomp_kmer(self, length: int, pos: int) -> int:
        return _kmer_value(complement_codes(self.seq[pos : pos + length])[::-1], 8)

    def as_slice(self) -> "GenericSeq":
        return self


@dataclasses.dataclass
class PackedNSeqVec:
    """Packed sequence plus per-base ambiguity flags (`PackedNSeq`)."""

    seq: PackedSeq
    ambiguous: np.ndarray  # bool array, True where the base was not ACGT

    @staticmethod
    def from_ascii(seq: bytes | np.ndarray) -> "PackedNSeqVec":
        codes, amb = native.pack_ascii(_as_bytes(seq))
        return PackedNSeqVec(PackedSeqVec(pack_2bit(codes), 0, codes.size), amb.view(bool))

    def __len__(self) -> int:
        return len(self.seq)

    def slice(self, start: int, end: int) -> "PackedNSeqVec":
        return PackedNSeqVec(self.seq.slice(start, end), self.ambiguous[start:end])

    def as_slice(self) -> "PackedNSeqVec":
        return self


def as_seq(seq) -> "PackedSeq | AsciiSeq | GenericSeq | PackedNSeqVec":
    """Coerce user input into a sequence object of the port.

    Plain bytes/str/uint8 arrays of pure ACGT/acgt are treated as ASCII DNA;
    any other byte content is general ASCII text (`&[u8]` in the reference,
    the crate's src/lib.rs:57-72), whose "codes" are the raw byte values
    (MulHasher recommended). Wrap in `AsciiSeq` explicitly to force DNA
    folding of arbitrary bytes, or in `GenericSeq` to force text semantics
    for ACGT-only content. Any other type raises TypeError (the JAX
    package's sequences go through `convert.seq_from` first).
    """
    if isinstance(seq, (PackedSeq, AsciiSeq, GenericSeq, PackedNSeqVec)):
        return seq
    if isinstance(seq, str):
        seq = seq.encode()
    if isinstance(seq, (bytes, bytearray, np.ndarray)):
        arr = _as_bytes(seq)
        if bool(_IS_ACGT[arr].all()):
            return AsciiSeq(arr)
        return GenericSeq(arr)
    raise TypeError(f"unsupported sequence type: {type(seq)}")
