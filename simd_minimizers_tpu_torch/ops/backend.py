"""Backend dispatch on the device of the input.

Counterpart of `simd_minimizers_tpu/ops/backend.sketch`: the kernel wrapper
(`ops/fused.fused_sketch`) sends a CUDA tensor to the Hopper kernels and a
CPU tensor to their plain versions (`ops/pipeline.py`). There is no other
route: what the kernels do not cover raises `NotImplementedError`, on both
devices, naming the ROADMAP item that will port it: modes and hashers
here, input length and geometry in the wrapper.
"""

from __future__ import annotations

import torch

from simd_minimizers_tpu.hashers import KmerHasher

from .. import convert
from . import fused, pipeline


def check_supported(k: int, hasher: KmerHasher, mode: str) -> None:
    """Raise for a mode or hasher outside the port's slice."""
    if mode != pipeline.MODE_MINIMIZERS:
        raise NotImplementedError(f"mode {mode!r} is not ported yet (ROADMAP A3)")
    if hasher.kind != "nt":
        raise NotImplementedError(f"the {hasher.kind!r} hasher is not ported yet (ROADMAP A3)")
    if hasher.k != k:
        raise ValueError(f"hasher k={hasher.k} differs from k={k}")


def sketch(words: torch.Tensor, n: int, k: int, w: int, hasher: KmerHasher,
           mode: str = pipeline.MODE_MINIMIZERS) -> torch.Tensor:
    """int32 minimizer positions, on words.device, of the first n bases of
    the 2-bit byte stream `words` (convert.packed_words)."""
    check_supported(k, hasher, mode)
    key, table, _ = convert.hasher_tensors(hasher, words.device)
    _, canonical, rot_offset = key
    return fused.fused_sketch(words, n, k, w, table, rot_offset, canonical)
