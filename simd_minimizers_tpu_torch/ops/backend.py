"""Backend dispatch on the device of the input.

Counterpart of `simd_minimizers_tpu/ops/backend.sketch`: the kernel wrapper
(`ops/fused.fused_sketch`) sends a CUDA tensor to the Hopper kernels and a
CPU tensor to their plain versions (`ops/pipeline.py`). There is no other
route: what the kernels do not cover (input length, geometry) raises
`NotImplementedError` in the wrapper, on both devices, naming the ROADMAP
item that will port it. Parameters the reference rejects raise the JAX
package's AssertionError.
"""

from __future__ import annotations

import torch

from .. import convert
from ..hashers import KmerHasher
from . import fused, pipeline


def check_supported(k: int, hasher: KmerHasher, mode: str) -> None:
    """Raise for an unknown mode, a hasher that is not the port's, or a
    hasher of another k."""
    if mode not in pipeline.MODES:
        raise ValueError(f"unknown mode {mode!r}")
    if not isinstance(hasher, KmerHasher):
        raise TypeError(f"{type(hasher).__name__} is not a hasher of the port "
                        "(convert.hasher_from rebuilds one)")
    if hasher.k != k:
        raise ValueError(f"hasher k={hasher.k} differs from k={k}")


def sketch(chars: torch.Tensor, n: int, k: int, w: int, hasher: KmerHasher,
           mode: str = pipeline.MODE_MINIMIZERS, ambiguous: torch.Tensor | None = None,
           text: bool = False):
    """int32 positions (window indices for syncmers), on chars.device, of
    the first n chars of `chars`: the 2-bit byte stream of
    convert.packed_words, or with `text` the bytes of convert.text_bytes;
    skipping the windows that hold a char flagged in the 1-bit plane
    `ambiguous` (convert.ambiguity_plane); for super-k-mers (positions,
    first-window indices)."""
    check_supported(k, hasher, mode)
    # the JAX package's checks and exception (simd_minimizers_tpu/ops/backend.py
    # sketch); super-k-mers with a mask fail the same way in the wrapper
    if mode == pipeline.MODE_OPEN_SYNCMERS and w % 2 == 0:
        raise AssertionError("open syncmers require odd w")
    if hasher.canonical and (k + w - 1) % 2 == 0:
        raise AssertionError(f"window length l={k + w - 1} must be odd to determine strand")
    (kind, canonical, rot_offset), tables = convert.hasher_tensors(hasher, chars.device, text)
    return fused.fused_sketch(chars, n, k, w, tables, rot_offset, canonical, mode, ambiguous,
                              text=text, kind=kind)
