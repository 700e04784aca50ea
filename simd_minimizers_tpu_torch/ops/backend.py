"""Backend dispatch on the device of the input.

Counterpart of `simd_minimizers_tpu/ops/backend.sketch`: the kernel wrapper
(`ops/fused.fused_sketch`) sends a CUDA tensor to the Hopper kernels and a
CPU tensor to their plain versions (`ops/pipeline.py`). There is no other
route: what the kernels do not cover raises `NotImplementedError`, on both
devices, naming the ROADMAP item that will port it: hashers here, input
length and geometry in the wrapper. Parameters the reference rejects raise
the JAX package's AssertionError.
"""

from __future__ import annotations

import torch

from simd_minimizers_tpu.hashers import KmerHasher

from .. import convert
from . import fused, pipeline


def check_supported(k: int, hasher: KmerHasher, mode: str) -> None:
    """Raise for an unknown mode or a hasher outside the port's slice."""
    if mode not in pipeline.MODES:
        raise ValueError(f"unknown mode {mode!r}")
    if hasher.kind != "nt":
        raise NotImplementedError(f"the {hasher.kind!r} hasher is not ported yet (ROADMAP A3)")
    if hasher.k != k:
        raise ValueError(f"hasher k={hasher.k} differs from k={k}")


def sketch(words: torch.Tensor, n: int, k: int, w: int, hasher: KmerHasher,
           mode: str = pipeline.MODE_MINIMIZERS, ambiguous: torch.Tensor | None = None):
    """int32 positions (window indices for syncmers), on words.device, of
    the first n bases of the 2-bit byte stream `words` (convert.packed_words),
    skipping the windows that hold a base flagged in the 1-bit plane
    `ambiguous` (convert.ambiguity_plane); for super-k-mers (positions,
    first-window indices)."""
    check_supported(k, hasher, mode)
    # the JAX package's checks and exception (simd_minimizers_tpu/ops/backend.py
    # sketch); super-k-mers with a mask fail the same way in the wrapper
    if mode == pipeline.MODE_OPEN_SYNCMERS and w % 2 == 0:
        raise AssertionError("open syncmers require odd w")
    if hasher.canonical and (k + w - 1) % 2 == 0:
        raise AssertionError(f"window length l={k + w - 1} must be odd to determine strand")
    key, table, _ = convert.hasher_tensors(hasher, words.device)
    _, canonical, rot_offset = key
    return fused.fused_sketch(words, n, k, w, table, rot_offset, canonical, mode, ambiguous)
