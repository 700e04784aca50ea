"""simd_minimizers_tpu_torch — the PyTorch/CUDA port of simd_minimizers_tpu.

Forward and canonical minimizers, super-k-mers, closed and open syncmers
and skip-ambiguous windows of 2-bit DNA with the nt hasher, through a
hand-written Hopper kernel on a CUDA device and its plain PyTorch version
on the CPU. Bit-identical to the JAX package and its NumPy oracle.

Quick start::

    import simd_minimizers_tpu_torch as smt

    ps = smt.PackedSeqVec.from_ascii(b"ACGTGCTCAGAGACTCAGAGGA")
    smt.canonical_minimizer_positions(ps, 5, 7, device="cuda")  # -> [0, 7, 9, 15]
    out = smt.canonical_minimizers(21, 11).run(ps, device="cpu")
    nseq = smt.PackedNSeqVec.from_ascii(b"ACGTNACGT...")
    smt.canonical_minimizers(5, 7).run_skip_ambiguous_windows(nseq, device="cpu")
"""

from simd_minimizers_tpu.hashers import KmerHasher, NtHasher
from simd_minimizers_tpu.seq.packed import AsciiSeq, PackedNSeqVec, PackedSeq, PackedSeqVec

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
    open_syncmers,
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
    "KmerHasher",
    "NtHasher",
    "PackedSeq",
    "PackedSeqVec",
    "PackedNSeqVec",
    "AsciiSeq",
]
