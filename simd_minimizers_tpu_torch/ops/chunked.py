"""The bounded-memory CPU route: long sequences in chunks of windows.

Counterpart of `simd_minimizers_tpu/ops/chunked.py` and of the JAX
package's routing to it (`ops/backend.py` PIPELINE_CHUNK_WINDOWS). The plain
version of the kernels builds a launch's whole lane matrix at once, about
100 bytes a char at its peak, so on a CPU tensor a sequence of more than
PIPELINE_CHUNK_WINDOWS windows streams through the span driver
(`fused.sketch_long`) in spans that own that many windows each (a multiple
of the kernel's TILE, so every span starts on a byte of the 2-bit stream
and of the 1-bit plane). Each span recomputes the window before its first,
as the card's tiles do, and the seam merge drops a span's first value where
the dedup would: the JAX package's one-u32 seam. The result is bit-equal to
one launch. CUDA tensors keep the card's spans (`fused.SPAN_CHARS`).
"""

from __future__ import annotations

import torch

from . import fused, pipeline

# beyond this many windows a CPU sequence streams in chunks (the JAX package's)
PIPELINE_CHUNK_WINDOWS = 1 << 24


def span_chars(l: int, chunk_windows: int | None = None) -> int:
    """Chars of a CPU span that owns `chunk_windows` windows (default
    PIPELINE_CHUNK_WINDOWS, a positive multiple of fused.TILE) of width l."""
    chunk_windows = PIPELINE_CHUNK_WINDOWS if chunk_windows is None else chunk_windows
    if chunk_windows <= 0 or chunk_windows % fused.TILE:
        raise ValueError(f"chunk_windows={chunk_windows} is not a positive multiple of "
                         f"{fused.TILE} windows")
    return chunk_windows + l - 1


def sketch(chars: torch.Tensor, n: int, k: int, w: int, hasher,
           mode: str = pipeline.MODE_MINIMIZERS, ambiguous: torch.Tensor | None = None, *,
           text: bool = False, byte_codes: bool = False, chunk_windows: int | None = None):
    """`fused.sketch_long` of the first n chars of `chars` (and the 1-bit
    plane `ambiguous`) in spans of `chunk_windows` windows (`span_chars`):
    int32 positions, or (positions, super-k-mer indices), holding u32 bits,
    on chars.device."""
    return fused.sketch_long(chars, n, k, w, hasher, mode, ambiguous, text=text,
                             byte_codes=byte_codes, span_chars=span_chars(k + w - 1,
                                                                          chunk_windows))
