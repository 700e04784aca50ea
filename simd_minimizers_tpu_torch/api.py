"""Public builder API of the port.

Counterpart of `simd_minimizers_tpu/api.py`, the same builder shape,

    out = canonical_minimizers(k, w).super_kmers().run(seq, device="cuda")
    out.positions, out.superkmer_indices, out.values_u64()
    minimizers(k, w).hasher(MulHasher(k)).run(GenericSeq(text), device="cuda")
    canonical_minimizers(k, w).run_skip_ambiguous_windows(nseq, device="cuda")

    rid, pos = minimizers(k, w).run_batch(reads, device="cuda")

with `Output` and `Builder` of the port's own. `Builder.run` sends the
sequence (2-bit packed, or the raw bytes of text; up to 2^32 chars) and
its ambiguity mask, as a 1-bit plane, to `device`, runs the port's backend
(the Hopper kernel on a CUDA device, its plain version on the CPU) and
brings the result back through pinned host memory. `run_batch` sketches
many reads in one launch per length bucket (`ops/batch.py`). `run_scalar`
and `one_minimizer` are the NumPy oracle (`ops/oracle.py`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import convert
from .hashers import KmerHasher, NtHasher
from .ops import backend, device_values, fused, oracle, pipeline, values
from .seq.packed import (_ASCII_TO_CODE, _IS_ACGT, AsciiSeq, GenericSeq, PackedNSeqVec,
                         PackedSeq, as_seq)
from .utils.profiling import span, stage

_SYNCMER_NONE, _SYNCMER_CLOSED, _SYNCMER_OPEN = 0, 1, 2


@dataclasses.dataclass
class Output:
    """Result of a builder run (the `Output` equivalent).

    `length` is k for minimizers and k+w-1 for syncmers (the crate's
    src/lib.rs:439-447).

    k-mer values of 2-bit sequences are computed where the positions were:
    after a run on a CUDA device `values_u64`, `values_u128_limbs` and
    `values_u128` launch the `kmer_values` kernel on that card
    (`ops/device_values.py`, at every m) and bring the limbs back through
    pinned memory; after a CPU run or `run_scalar` they are the host's (the
    native extractor for u64, NumPy for u128). Text stays on the host. The
    JAX package picks the device by a probe of the link instead; at the
    card's pinned bus (53-55 GB/s down, PERF.md section 5) the download
    costs about 0.15 ns a value against the host's tens of ns, so such a
    probe could only pick the card. Both routes are bit-equal.
    """

    length: int
    seq: object
    positions: np.ndarray
    superkmer_indices: np.ndarray | None = None
    canonical: bool = False
    _device: torch.device | None = dataclasses.field(default=None, repr=False)

    def _codes(self) -> np.ndarray:
        return self.seq.codes()

    @property
    def _bits(self) -> int:
        # 2 bits/char for DNA, 8 for general text (GenericSeq)
        return getattr(self.seq, "char_bits", 2)

    def _on_card(self, max_length: int) -> bool:
        """Whether values of at most max_length chars come from the card."""
        return (self._device is not None and self._device.type == "cuda"
                and self._bits == 2 and self.length <= max_length)

    def _card_values(self, fn):
        """fn (a driver of ops/device_values) on the run's card: the sequence
        uploaded as convert.packed_words uploads it, the positions from the
        host arrays the run returned."""
        return fn(convert.packed_words(self.seq, self._device), self.positions, self.length,
                  canonical=self.canonical)

    def values_u64(self) -> np.ndarray:
        if self._on_card(32):
            return self._card_values(device_values.kmer_values_u64)
        fn = values.canonical_kmer_values_u64 if self.canonical else values.kmer_values_u64
        return fn(self._codes(), self.positions, self.length, self._bits)

    def values_u128(self) -> list[int]:
        if self._on_card(64):
            return values.limbs_to_ints(*self._card_values(device_values.kmer_values_u128_limbs))
        fn = values.canonical_kmer_values_u128 if self.canonical else values.kmer_values_u128
        return fn(self._codes(), self.positions, self.length, self._bits)

    def values_u128_limbs(self) -> tuple[np.ndarray, np.ndarray]:
        """(lo, hi) u64 limb arrays — vectorized u128s for sketch-scale use."""
        if self._on_card(64):
            return self._card_values(device_values.kmer_values_u128_limbs)
        fn = (values.canonical_kmer_values_u128_limbs if self.canonical
              else values.kmer_values_u128_limbs)
        return fn(self._codes(), self.positions, self.length, self._bits)

    def pos_and_values_u64(self) -> tuple[np.ndarray, np.ndarray]:
        return self.positions, self.values_u64()

    def pos_and_values_u128(self) -> tuple[np.ndarray, list[int]]:
        return self.positions, self.values_u128()


@dataclasses.dataclass
class Builder:
    """Type-state builder (the reference's const generics become fields)."""

    k: int
    w: int
    canonical: bool
    syncmer: int = _SYNCMER_NONE
    _hasher: KmerHasher | None = None
    _super_kmers: bool = False

    def hasher(self, hasher: KmerHasher) -> "Builder":
        if not isinstance(hasher, KmerHasher):
            raise TypeError(f"{type(hasher).__name__} is not a hasher of the port "
                            "(convert.hasher_from rebuilds one)")
        return dataclasses.replace(self, _hasher=hasher)

    def super_kmers(self) -> "Builder":
        assert self.syncmer == _SYNCMER_NONE, "super-kmers are incompatible with syncmers"
        return dataclasses.replace(self, _super_kmers=True)

    def _resolved_hasher(self) -> KmerHasher:
        return self._hasher or NtHasher(self.k, canonical=self.canonical)

    @property
    def _out_length(self) -> int:
        return self.k + self.w - 1 if self.syncmer != _SYNCMER_NONE else self.k

    @property
    def _mode(self) -> str:
        if self.syncmer == _SYNCMER_OPEN:
            return pipeline.MODE_OPEN_SYNCMERS
        if self.syncmer == _SYNCMER_CLOSED:
            return pipeline.MODE_CLOSED_SYNCMERS
        return pipeline.MODE_SUPERKMERS if self._super_kmers else pipeline.MODE_MINIMIZERS

    def run(self, seq, ambiguous: np.ndarray | None = None,
            device: torch.device | str = "cuda") -> Output:
        """Positions (window indices for syncmers, with the first-window
        indices for super-k-mers) of `seq` on `device`. Windows holding a
        char that the per-char mask `ambiguous` flags are skipped.

        `seq` is a sequence of the port (`PackedSeq`, `AsciiSeq` or
        `GenericSeq`), or bytes, str or a uint8 array (`as_seq`); any other
        type raises TypeError (`convert.seq_from` rebuilds one).
        """
        mode = self._mode
        # the reference cannot express it: rejected as the JAX builder does
        pipeline.assert_no_superkmer_ambiguity(mode, ambiguous is not None)
        seq = as_seq(seq)
        text = isinstance(seq, GenericSeq)
        n = len(seq)
        fused.check_sequence_length(n)  # before anything crosses the bus
        if text:
            chars = convert.text_bytes(seq, device)
        elif isinstance(seq, (PackedSeq, AsciiSeq)):
            chars = convert.packed_words(seq, device)
        else:
            raise TypeError(f"Builder.run takes a PackedSeq, AsciiSeq or GenericSeq, not "
                            f"{type(seq).__name__} (run_skip_ambiguous_windows takes a "
                            "PackedNSeqVec)")
        amb = None if ambiguous is None else convert.ambiguity_plane(ambiguous, n, device)
        res = backend.sketch(chars, n, self.k, self.w, self._resolved_hasher(), mode, amb, text)
        if mode == pipeline.MODE_SUPERKMERS:
            pos, idx = convert.Download(res).result()
            return Output(self._out_length, seq, pos, idx, self.canonical, chars.device)
        positions = convert.Download(res).result()
        return Output(self._out_length, seq, positions, canonical=self.canonical,
                      _device=chars.device)

    def run_scalar(self, seq, ambiguous: np.ndarray | None = None) -> Output:
        """NumPy-oracle run (the reference's scalar path; for testing)."""
        seq = as_seq(seq)
        codes = seq.codes()
        sel = oracle.selected_stream(codes, self.k, self.w, self._resolved_hasher(),
                                     ambiguous=ambiguous)
        if self.syncmer != _SYNCMER_NONE:
            pos = oracle.collect_syncmers(sel, self.w, self.syncmer == _SYNCMER_OPEN)
            return Output(self._out_length, seq, pos, canonical=self.canonical)
        if self._super_kmers:
            pos, idx = oracle.collect_and_dedup_with_index(sel)
            return Output(self._out_length, seq, pos, idx, canonical=self.canonical)
        pos = oracle.collect_and_dedup(sel, skip_sentinel=ambiguous is not None)
        return Output(self._out_length, seq, pos, canonical=self.canonical)

    def run_once(self, seq, device: torch.device | str = "cuda") -> np.ndarray:
        return self.run(seq, device=device).positions

    def run_scalar_once(self, seq) -> np.ndarray:
        return self.run_scalar(seq).positions

    def run_skip_ambiguous_windows(self, nseq: PackedNSeqVec,
                                   device: torch.device | str = "cuda") -> Output:
        """Canonical minimizers of `nseq.seq` that skip every window holding
        a non-ACGT base of `nseq` (the reference's skip-ambiguous entry)."""
        if not self.canonical:
            raise AssertionError("skip-ambiguous is defined for canonical builders")
        return self.run(nseq.seq, ambiguous=nseq.ambiguous, device=device)

    def run_skip_ambiguous_windows_once(self, nseq: PackedNSeqVec,
                                        device: torch.device | str = "cuda") -> np.ndarray:
        return self.run_skip_ambiguous_windows(nseq, device=device).positions

    def run_batch(self, reads, ambiguous=None, device: torch.device | str = "cuda"):
        """Sketch a batch of reads in one launch per length bucket on
        `device` (ops/batch.sketch_batch).

        reads: a list of sequences (any type `as_seq` takes), or a (B, L)
        uint8 matrix whose rows are such byte strings. `ambiguous`: one
        mask per read, or None. Returns (read_ids, positions[, super-k-mer
        indices]), np.uint32, ordered by read, positions local to each read.
        Reads shorter than l = k + w - 1 have no windows and are dropped
        from the output entirely (their ids never appear).
        """
        with span("run_batch"):
            # the reference cannot express it: rejected as the JAX builder does
            pipeline.assert_no_superkmer_ambiguity(self._mode, ambiguous is not None)
            with stage("fold reads to codes"):
                if isinstance(reads, np.ndarray) and reads.ndim == 2:
                    # as_seq row by row, vectorized: ACGT rows are DNA, others text
                    rows = np.asarray(reads, dtype=np.uint8)
                    acgt = _IS_ACGT[rows].all(axis=1)
                    codes = np.where(acgt[:, None], _ASCII_TO_CODE[rows], rows)
                    dna = bool(acgt.all())
                else:
                    seqs = [as_seq(r) for r in reads]
                    codes = [s.codes() for s in seqs]
                    # the seq types decide DNA vs general text exactly: no O(n) probe
                    dna = not any(isinstance(s, GenericSeq) for s in seqs)
            return backend.sketch_batch(codes, self.k, self.w, self._resolved_hasher(), self._mode,
                                        ambiguous, dna=dna, device=device)


def minimizers(k: int, w: int) -> Builder:
    return Builder(k, w, canonical=False)


def canonical_minimizers(k: int, w: int) -> Builder:
    return Builder(k, w, canonical=True)


def closed_syncmers(k: int, w: int) -> Builder:
    return Builder(k, w, canonical=False, syncmer=_SYNCMER_CLOSED)


def canonical_closed_syncmers(k: int, w: int) -> Builder:
    return Builder(k, w, canonical=True, syncmer=_SYNCMER_CLOSED)


def open_syncmers(k: int, w: int) -> Builder:
    return Builder(k, w, canonical=False, syncmer=_SYNCMER_OPEN)


def canonical_open_syncmers(k: int, w: int) -> Builder:
    return Builder(k, w, canonical=True, syncmer=_SYNCMER_OPEN)


def one_minimizer(window_seq, hasher: KmerHasher) -> int:
    """Minimizer position of a single window (the crate's
    src/minimizers.rs:22-28): the NumPy oracle on the host, no card."""
    return oracle.one_minimizer(as_seq(window_seq).codes(), hasher)


def minimizer_positions(seq, k: int, w: int, device: torch.device | str = "cuda") -> np.ndarray:
    """All deduplicated minimizer positions."""
    return minimizers(k, w).run_once(seq, device=device)


def canonical_minimizer_positions(seq, k: int, w: int,
                                  device: torch.device | str = "cuda") -> np.ndarray:
    """Canonical minimizer positions; l = w + k - 1 must be odd."""
    return canonical_minimizers(k, w).run_once(seq, device=device)
