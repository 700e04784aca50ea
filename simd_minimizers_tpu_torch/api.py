"""Public builder API of the port.

Counterpart of `simd_minimizers_tpu/api.py`: the same builder shape,

    out = canonical_minimizers(k, w).run(seq, device="cuda")
    out.positions, out.values_u64()

`Builder.run` sends the sequence to `device` and runs the port's backend
(the Hopper kernel on a CUDA device, its plain version on the CPU).
`run_scalar` is the reference's NumPy oracle, inherited unchanged.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from simd_minimizers_tpu import api as _ref
from simd_minimizers_tpu.seq.packed import as_seq

from . import convert
from .ops import backend


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
        if ambiguous is not None:
            raise NotImplementedError("skip-ambiguous windows are not ported yet (ROADMAP A3)")
        if self.syncmer != _ref._SYNCMER_NONE:
            raise NotImplementedError("syncmers are not ported yet (ROADMAP A3)")
        if self._super_kmers:
            raise NotImplementedError("super-k-mers are not ported yet (ROADMAP A3)")
        seq = as_seq(seq)
        if getattr(seq, "char_bits", None) != 2:
            raise NotImplementedError(
                f"{type(seq).__name__} input is not ported yet: general text is ROADMAP A3")
        words = convert.packed_words(seq, device)
        pos = backend.sketch(words, len(seq), self.k, self.w, self._resolved_hasher())
        positions = pos.cpu().numpy().view(np.uint32)  # positions are < 2^31: no copy
        return Output(self._out_length, seq, positions, canonical=self.canonical)

    def run_once(self, seq, device: torch.device | str = "cuda") -> np.ndarray:
        return self.run(seq, device=device).positions

    def run_batch(self, reads, ambiguous=None):
        raise NotImplementedError("batched reads are not ported yet (ROADMAP A5)")


def minimizers(k: int, w: int) -> Builder:
    return Builder(k, w, canonical=False)


def canonical_minimizers(k: int, w: int) -> Builder:
    return Builder(k, w, canonical=True)


def minimizer_positions(seq, k: int, w: int, device: torch.device | str = "cuda") -> np.ndarray:
    """All deduplicated minimizer positions."""
    return minimizers(k, w).run_once(seq, device=device)


def canonical_minimizer_positions(seq, k: int, w: int,
                                  device: torch.device | str = "cuda") -> np.ndarray:
    """Canonical minimizer positions; l = w + k - 1 must be odd."""
    return canonical_minimizers(k, w).run_once(seq, device=device)
