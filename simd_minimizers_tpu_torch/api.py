"""Public builder API of the port.

Counterpart of `simd_minimizers_tpu/api.py`: the same builder shape,

    out = canonical_minimizers(k, w).super_kmers().run(seq, device="cuda")
    out.positions, out.superkmer_indices, out.values_u64()
    canonical_minimizers(k, w).run_skip_ambiguous_windows(nseq, device="cuda")

`Builder.run` sends the sequence (and its ambiguity mask, as a 1-bit
plane) to `device` and runs the port's backend (the Hopper kernel on a
CUDA device, its plain version on the CPU). `run_scalar` is the
reference's NumPy oracle, inherited unchanged.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from simd_minimizers_tpu import api as _ref
from simd_minimizers_tpu.seq.packed import PackedNSeqVec, as_seq

from . import convert
from .ops import backend, pipeline


@dataclasses.dataclass
class Output(_ref.Output):
    """The reference's `Output`; k-mer values are assembled on the host
    (device values are ROADMAP A6)."""

    def _use_device_values(self, max_length: int) -> bool:
        return False


@dataclasses.dataclass
class Builder(_ref.Builder):
    """The reference's builder with the port's `run`."""

    def run(self, seq, ambiguous: np.ndarray | None = None,
            device: torch.device | str = "cuda") -> Output:
        """Positions (window indices for syncmers, with the first-window
        indices for super-k-mers) of `seq` on `device`. Windows holding a
        base that the per-base mask `ambiguous` flags are skipped."""
        if self.syncmer != _ref._SYNCMER_NONE:
            mode = (pipeline.MODE_OPEN_SYNCMERS if self.syncmer == _ref._SYNCMER_OPEN
                    else pipeline.MODE_CLOSED_SYNCMERS)
        elif self._super_kmers:
            mode = pipeline.MODE_SUPERKMERS
            # the reference cannot express it: rejected as the JAX builder does
            pipeline.assert_no_superkmer_ambiguity(mode, ambiguous is not None)
        else:
            mode = pipeline.MODE_MINIMIZERS
        seq = as_seq(seq)
        if getattr(seq, "char_bits", None) != 2:
            raise NotImplementedError(
                f"{type(seq).__name__} input is not ported yet: general text is ROADMAP A3")
        n = len(seq)
        words = convert.packed_words(seq, device)
        amb = None if ambiguous is None else convert.ambiguity_plane(ambiguous, n, device)
        res = backend.sketch(words, n, self.k, self.w, self._resolved_hasher(), mode, amb)
        # positions and indices are < 2^31: the uint32 views copy nothing
        if mode == pipeline.MODE_SUPERKMERS:
            pos, idx = (t.cpu().numpy().view(np.uint32) for t in res)
            return Output(self._out_length, seq, pos, idx, canonical=self.canonical)
        positions = res.cpu().numpy().view(np.uint32)
        return Output(self._out_length, seq, positions, canonical=self.canonical)

    def run_once(self, seq, device: torch.device | str = "cuda") -> np.ndarray:
        return self.run(seq, device=device).positions

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

    def run_batch(self, reads, ambiguous=None):
        raise NotImplementedError("batched reads are not ported yet (ROADMAP A5)")


def minimizers(k: int, w: int) -> Builder:
    return Builder(k, w, canonical=False)


def canonical_minimizers(k: int, w: int) -> Builder:
    return Builder(k, w, canonical=True)


def closed_syncmers(k: int, w: int) -> Builder:
    return Builder(k, w, canonical=False, syncmer=_ref._SYNCMER_CLOSED)


def canonical_closed_syncmers(k: int, w: int) -> Builder:
    return Builder(k, w, canonical=True, syncmer=_ref._SYNCMER_CLOSED)


def open_syncmers(k: int, w: int) -> Builder:
    return Builder(k, w, canonical=False, syncmer=_ref._SYNCMER_OPEN)


def canonical_open_syncmers(k: int, w: int) -> Builder:
    return Builder(k, w, canonical=True, syncmer=_ref._SYNCMER_OPEN)


def minimizer_positions(seq, k: int, w: int, device: torch.device | str = "cuda") -> np.ndarray:
    """All deduplicated minimizer positions."""
    return minimizers(k, w).run_once(seq, device=device)


def canonical_minimizer_positions(seq, k: int, w: int,
                                  device: torch.device | str = "cuda") -> np.ndarray:
    """Canonical minimizer positions; l = w + k - 1 must be odd."""
    return canonical_minimizers(k, w).run_once(seq, device=device)
