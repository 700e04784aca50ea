"""What the port carries across: the hasher's state, the sequence and its
ambiguity mask, as tensors on one `torch.device`; and the two functions
that rebuild the port's hasher and sequence from any object of the same
shape (the JAX package's, for one).

`hasher_tensors` is the counterpart of the JAX package's
`ops/pipeline.hasher_jit_args`: where that hands the kernel the nt table
and the mul constant, this hands it the per-char values the rolling fold
reads, so nt and mul, on 2-bit DNA and on text, are one fold.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from .hashers import AntiLexHasher, KmerHasher, MulHasher, NtHasher
from .seq.packed import AsciiSeq, GenericSeq, PackedNSeqVec, PackedSeq, PackedSeqVec, pack_2bit
from .utils.device import require_cuda

_HASHERS = {cls.kind: cls for cls in (NtHasher, MulHasher, AntiLexHasher)}
TABLE_ENTRIES = {False: 4, True: 256}  # per-char table entries: 2-bit codes, text bytes


def hasher_from(h) -> KmerHasher:
    """The port's hasher equal to `h`: any object with `kind`, `k`,
    `canonical` and `seed` (the port's own hashers come back as they are)."""
    if isinstance(h, KmerHasher):
        return h
    cls = _HASHERS.get(getattr(h, "kind", None))
    if cls is None:
        raise TypeError(f"no hasher of the port for {type(h).__name__} "
                        f"(kind {getattr(h, 'kind', None)!r})")
    return cls(int(h.k), canonical=bool(h.canonical), seed=h.seed)


def seq_from(s):
    """The port's sequence equal to `s`: a `PackedSeq`-like object (packed
    `data`, `offset`, `length`, 2 bits per char) is wrapped without a copy;
    an `nseq`-like one (`seq`, `ambiguous`) becomes a `PackedNSeqVec`; any
    other object with `codes()` and `char_bits` becomes a `PackedSeqVec`
    (2 bits) or a `GenericSeq` (8 bits)."""
    if isinstance(s, (PackedSeq, AsciiSeq, GenericSeq, PackedNSeqVec)):
        return s
    if hasattr(s, "seq") and hasattr(s, "ambiguous"):
        return PackedNSeqVec(seq_from(s.seq), np.asarray(s.ambiguous))
    bits = getattr(s, "char_bits", None)
    if bits == 2 and all(hasattr(s, a) for a in ("data", "offset", "length")):
        return PackedSeq(np.asarray(s.data, dtype=np.uint8), s.offset, s.length)
    if bits == 2 and hasattr(s, "codes"):
        return PackedSeqVec.from_codes(s.codes())
    if bits == 8 and hasattr(s, "codes"):
        return GenericSeq(s.codes())
    raise TypeError(f"no sequence of the port for {type(s).__name__}")


def char_tables(hasher: KmerHasher, text: bool) -> np.ndarray | None:
    """(2, nchars) uint32: the forward value F[c] and the complement value
    R[c] of each char c the fold reads, for 2-bit codes (4) or text bytes
    (256); None for antilex, which folds no table.

    nt: F[c] = T[c & 3], R[c] = T[(c & 3) ^ 2] (text folds with & 3).
    mul: F[c] = (c + 1) M, R[c] = ((c ^ 2) + 1) M, mod 2^32: the complement
    of a text char is c ^ 2 on the raw byte, so R is no permutation of F.
    """
    if hasher.kind == "antilex":
        return None
    c = np.arange(TABLE_ENTRIES[text], dtype=np.uint32)
    if hasher.kind == "nt":
        table = np.asarray(hasher.table, dtype=np.uint32)
        return np.stack([table[c & 3], table[(c & 3) ^ 2]])
    if hasher.kind == "mul":
        m = np.uint32(hasher.mul_const)
        return np.stack([(c + 1) * m, ((c ^ 2) + 1) * m]).astype(np.uint32)
    raise ValueError(f"unknown hasher kind {hasher.kind!r}")


def hasher_tensors(hasher: KmerHasher, device: torch.device | str, text: bool = False):
    """(key, tables): key = (kind, canonical, rot_offset); tables =
    `char_tables` as an int64 (2, nchars) tensor on `device`, or None."""
    key = (hasher.kind, hasher.canonical, getattr(hasher, "rot_offset", 0))
    tables = char_tables(hasher, text)
    if tables is None:
        return key, None
    return key, torch.from_numpy(tables.astype(np.int64)).to(require_cuda(device))


def packed_words(seq, device: torch.device | str) -> torch.Tensor:
    """The sequence as a 2-bit byte stream (4 bases per byte, base i at bits
    2 * (i % 4)) in a uint8 tensor on `device`.

    A `PackedSeq` whose first base is byte-aligned is used as it is (no
    host copy); any other 2-bit sequence is repacked once on the host.
    """
    device = require_cuda(device)
    if isinstance(seq, PackedSeq) and seq.offset % 4 == 0:
        data, _ = seq.packed_with_offset()
    else:
        data = pack_2bit(seq.codes())
    return torch.from_numpy(np.ascontiguousarray(data)).to(device)


def text_bytes(seq: GenericSeq, device: torch.device | str) -> torch.Tensor:
    """The raw bytes of a `GenericSeq` (1 B per char) in a uint8 tensor on
    `device`; a contiguous array crosses without a host copy."""
    device = require_cuda(device)
    data = np.ascontiguousarray(seq.seq, dtype=np.uint8)
    with warnings.catch_warnings():
        # bytes input is read-only; no path of the port writes to it
        warnings.filterwarnings("ignore", message="The given NumPy array is not writable")
        return torch.from_numpy(data).to(device)


def ambiguity_plane(ambiguous, n: int, device: torch.device | str) -> torch.Tensor:
    """A per-base ambiguity mask (`PackedNSeqVec.ambiguous`, or a caller's
    bool or uint8 array of n flags, nonzero = ambiguous) as a 1-bit plane
    in a uint8 tensor on `device`: base i at bit i % 8 of byte i // 8, the
    bits past n zero. The counterpart of the JAX package's packing of the
    ambiguity plane (simd_minimizers_tpu/ops/fused.py `_fused_launch`); an
    eighth of the mask's bytes cross the bus."""
    device = require_cuda(device)
    mask = np.asarray(ambiguous)
    if mask.dtype not in (np.bool_, np.uint8):
        raise TypeError(f"the ambiguity mask must be bool or uint8, got {mask.dtype}")
    if mask.shape != (n,):
        raise ValueError(f"the ambiguity mask has shape {mask.shape}, the sequence {n} bases")
    return torch.from_numpy(np.packbits(mask, bitorder="little")).to(device)
