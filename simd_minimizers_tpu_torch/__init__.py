"""simd_minimizers_tpu_torch — the PyTorch/CUDA port of simd_minimizers_tpu.

Forward and canonical minimizers, super-k-mers, closed and open syncmers
and skip-ambiguous windows of 2-bit DNA and of general text, with the nt,
mul and antilex hashers, through a hand-written Hopper kernel on a CUDA
device and its plain PyTorch version on the CPU. Bit-identical to the JAX
package and its NumPy oracle; it imports nothing of the JAX package (its
hashers, sequences, oracle and values are its own copies).

Quick start::

    import simd_minimizers_tpu_torch as smt

    ps = smt.PackedSeqVec.from_ascii(b"ACGTGCTCAGAGACTCAGAGGA")
    smt.canonical_minimizer_positions(ps, 5, 7, device="cuda")  # -> [0, 7, 9, 15]
    out = smt.canonical_minimizers(21, 11).run(ps, device="cpu")
    nseq = smt.PackedNSeqVec.from_ascii(b"ACGTNACGT...")
    smt.canonical_minimizers(5, 7).run_skip_ambiguous_windows(nseq, device="cpu")
    smt.minimizers(7, 5).hasher(smt.MulHasher(7)).run(b"any text", device="cpu")
"""

from .api import (
    Builder,
    Output,
    canonical_closed_syncmers,
    canonical_minimizer_positions,
    canonical_minimizers,
    canonical_open_syncmers,
    closed_syncmers,
    minimizer_positions,
    minimizers,
    one_minimizer,
    open_syncmers,
)
from .hashers import AntiLexHasher, KmerHasher, MulHasher, NtHasher
from .seq.packed import (
    AsciiSeq,
    AsciiSeqVec,
    GenericSeq,
    PackedNSeqVec,
    PackedSeq,
    PackedSeqVec,
    as_seq,
)

__all__ = [
    "Builder",
    "Output",
    "minimizers",
    "canonical_minimizers",
    "closed_syncmers",
    "canonical_closed_syncmers",
    "open_syncmers",
    "canonical_open_syncmers",
    "minimizer_positions",
    "canonical_minimizer_positions",
    "one_minimizer",
    "KmerHasher",
    "NtHasher",
    "MulHasher",
    "AntiLexHasher",
    "PackedSeq",
    "PackedSeqVec",
    "PackedNSeqVec",
    "AsciiSeq",
    "AsciiSeqVec",
    "GenericSeq",
    "as_seq",
]
