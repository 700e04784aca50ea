"""FASTA ingestion (the bench crate's needletail path).

The port's own copy of `simd_minimizers_tpu/seq/fasta.py` (`FastaRecord`,
`read_fasta`, `read_human_genome`). `read_fasta` scans the file's bytes
in one C++ pass (`fasta_scan`: the port's native helper, a copy of the
JAX package's): 2-bit codes `(c >> 1) & 3`, ambiguity flags (any byte but
ACGTacgt), and the record starts, with lowercase, IUPAC codes and N, CRLF
line ends, blank lines, a headerless file and an empty record; `.gz`
files are read through gzip. `fasta_scan_plain` is the same scan in
vectorised NumPy passes, which the tests hold the native one against.
"""

from __future__ import annotations

import dataclasses
import gzip

import numpy as np

from .. import native
from .packed import _ASCII_TO_CODE, _IS_ACGT, PackedNSeqVec, PackedSeqVec

_NOT_ACGT = (~_IS_ACGT).astype(np.uint8)
_NL, _CR, _GT = ord("\n"), ord("\r"), ord(">")


@dataclasses.dataclass
class FastaRecord:
    name: str
    codes: np.ndarray  # uint8 2-bit codes
    ambiguous: np.ndarray  # uint8 0/1

    def __len__(self) -> int:
        return self.codes.size

    def to_nseq(self) -> PackedNSeqVec:
        return PackedNSeqVec(PackedSeqVec.from_codes(self.codes), self.ambiguous.astype(bool))


def _record_names(buf: bytes) -> list[str]:
    names = []
    i = 0
    while True:
        j = buf.find(b">", i)
        if j < 0:
            break
        e = buf.find(b"\n", j)
        if e < 0:
            e = len(buf)
        names.append(buf[j + 1 : e].split(b"\r")[0].split(b" ")[0].decode("ascii", "replace"))
        i = e
    return names


def fasta_scan(buf: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(codes, ambiguous, starts) of a FASTA file's bytes, in one native
    pass (`native.fasta_scan`; as `fasta_scan_plain` gives them)."""
    return native.fasta_scan(buf)


def fasta_scan_plain(buf: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(codes, ambiguous, starts) of a FASTA file's bytes: record i is
    codes[starts[i]:starts[i + 1]] (uint8 2-bit codes; ambiguous the same
    span of 0/1 flags). A line that starts with '>' opens a record; other
    lines, less one carriage return before their newline, are sequence;
    sequence before the first header opens an implicit record 0."""
    n = buf.size
    nl = np.flatnonzero(buf == _NL)
    line_start = np.concatenate([[0], nl + 1])
    line_end = np.concatenate([nl, [n]])  # exclusive: the newline or the end
    keep = line_end > line_start  # a line of at least one byte
    line_start, line_end = line_start[keep], line_end[keep]
    header = buf[line_start] == _GT
    data_end = line_end - (buf[line_end - 1] == _CR)
    seq_len = np.where(header, 0, data_end - line_start)

    # sequence bytes: not a newline, not the carriage return of a line end,
    # not in a header line
    is_seq = buf != _NL
    is_seq[line_end[(buf[line_end - 1] == _CR)] - 1] = False
    hs, he = line_start[header], line_end[header]
    if hs.size:
        hlen = he - hs
        first = np.repeat(hs - np.concatenate([[0], np.cumsum(hlen)[:-1]]), hlen)
        is_seq[first + np.arange(hlen.sum())] = False
    data = buf[is_seq]
    codes = _ASCII_TO_CODE[data]
    amb = _NOT_ACGT[data]

    before = np.concatenate([[0], np.cumsum(seq_len)])  # sequence bytes before each line
    starts = before[:-1][header]
    first_header = np.flatnonzero(header)[0] if header.any() else header.size
    if before[first_header] > 0:  # sequence before any header
        starts = np.concatenate([[0], starts])
    return codes, amb, np.concatenate([starts, [data.size]]).astype(np.int64)


def read_fasta(path: str) -> list[FastaRecord]:
    """Parse a FASTA (.fa / .fa.gz) file into records."""
    opener = gzip.open if path.endswith((".gz", ".bgz")) else open
    with opener(path, "rb") as f:
        raw = f.read()
    names = _record_names(raw)
    codes, amb, starts = fasta_scan(np.frombuffer(raw, np.uint8))
    nrec = starts.size - 1
    recs = []
    for i in range(nrec):
        s, e = int(starts[i]), int(starts[i + 1])
        recs.append(FastaRecord(names[i] if i < len(names) else f"seq{i}",
                                codes[s:e], amb[s:e]))
    return recs


def read_human_genome(path: str = "human-genome.fa") -> list[FastaRecord]:
    """CHM13 T2T ingestion helper (the reference bench's helper): the
    records of `path`."""
    import os

    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{path} not found; download CHM13 (see the reference's README) or pass its path")
    return read_fasta(path)
