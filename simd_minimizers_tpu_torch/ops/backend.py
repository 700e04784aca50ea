"""Backend dispatch on the device of the input.

Counterpart of `simd_minimizers_tpu/ops/backend.py` (`sketch`,
`sketch_records`, `sketch_batch`): the kernel wrappers (`ops/fused.py`)
send a CUDA tensor to the Hopper kernels and a CPU tensor to their plain
versions (`ops/pipeline.py`). There is no other route: what the kernels do
not cover (geometry) raises `NotImplementedError` in the wrapper, on both
devices, naming the ROADMAP item that will port it. Parameters the
reference rejects raise the JAX package's AssertionError.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import convert
from ..hashers import KmerHasher
from ..utils.profiling import span, stage
from . import batch, chunked, fused, pipeline

# sequences of this many chars or more stream through spans (fused.sketch_long)
LONG_SEQUENCE_CHARS = 1 << 30
# sketch_records routes >= this many small records (each of at most
# batch_max_bp chars) through the batch engine: one launch per stride
# bucket for the whole set instead of a launch and a download per record
RECORDS_BATCH_MIN_COUNT = 8


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


def _check_parameters(k: int, w: int, hasher: KmerHasher, mode: str) -> None:
    """check_supported, then the JAX package's checks and exception
    (simd_minimizers_tpu/ops/backend.py sketch)."""
    check_supported(k, hasher, mode)
    if mode == pipeline.MODE_OPEN_SYNCMERS and w % 2 == 0:
        raise AssertionError("open syncmers require odd w")
    if hasher.canonical and (k + w - 1) % 2 == 0:
        raise AssertionError(f"window length l={k + w - 1} must be odd to determine strand")


def sketch(chars: torch.Tensor, n: int, k: int, w: int, hasher: KmerHasher,
           mode: str = pipeline.MODE_MINIMIZERS, ambiguous: torch.Tensor | None = None,
           text: bool = False):
    """int32 positions (window indices for syncmers; u32 bits), on
    chars.device, of the first n chars of `chars`: the 2-bit byte stream of
    convert.packed_words, or with `text` the bytes of convert.text_bytes;
    skipping the windows that hold a char flagged in the 1-bit plane
    `ambiguous` (convert.ambiguity_plane); for super-k-mers (positions,
    first-window indices), with or without a plane. On a CUDA tensor,
    sequences of 2^30 chars or more stream through `fused.sketch_long` in
    2^29-char spans; on a CPU tensor, sequences of more than
    chunked.PIPELINE_CHUNK_WINDOWS windows stream in spans of that many
    windows (`chunked.sketch`), which bounds the plain version's memory."""
    with span("sketch"):
        _check_parameters(k, w, hasher, mode)
        if chars.device.type == "cpu" and n - (k + w - 1) + 1 > chunked.PIPELINE_CHUNK_WINDOWS:
            return chunked.sketch(chars, n, k, w, hasher, mode, ambiguous, text=text)
        if n >= LONG_SEQUENCE_CHARS:
            return fused.sketch_long(chars, n, k, w, hasher, mode, ambiguous, text=text)
        (kind, canonical, rot_offset), tables = convert.hasher_tensors(hasher, chars.device, text)
        with span("kernels"):
            return fused.fused_sketch(chars, n, k, w, tables, rot_offset, canonical, mode,
                                      ambiguous, text=text, kind=kind)


def sketch_records(records, k: int, w: int, hasher: KmerHasher,
                   mode: str = pipeline.MODE_MINIMIZERS, ambiguous=None,
                   dna: bool | None = None, *, device: torch.device | str = "cuda",
                   batch_max_bp: int = 1 << 20, wave_bytes: int = 4 << 30):
    """Sketch many independent sequences of uint8 codes (2-bit codes if
    `dna`, text bytes if not; None probes); a list of per-record results
    (np.uint32 positions, or (positions, super-k-mer indices); empty for a
    record shorter than one window), bit-identical to sketching each record
    alone. `ambiguous` is an optional per-record list of masks (None
    entries allowed).

    At least RECORDS_BATCH_MIN_COUNT records of l to `batch_max_bp` chars go
    through the batch engine (one launch per stride bucket); the others
    through `fused.sketch_records` (span launches in waves of `wave_bytes`).
    The keywords are the JAX package's environment knobs
    SMTPU_RECORDS_BATCH_MAX_BP and SMTPU_RECORDS_WAVE_BYTES, with their
    defaults.
    """
    with span("sketch_records"):
        l = k + w - 1
        amb = fused.record_masks(records, ambiguous, mode)
        _check_parameters(k, w, hasher, mode)
        span_kw = {"dna": dna, "device": device, "span_chars": fused.SPAN_CHARS,
                   "wave_bytes": wave_bytes}
        small = [i for i, r in enumerate(records) if l <= len(r) <= batch_max_bp]
        if len(small) < RECORDS_BATCH_MIN_COUNT:
            return fused.sketch_records_checked(records, k, w, hasher, mode, amb, **span_kw)
        out = [None] * len(records)
        small_set = set(small)
        big = [i for i in range(len(records)) if i not in small_set]
        if big:
            for i, res in zip(big, fused.sketch_records_checked(
                    [records[i] for i in big], k, w, hasher, mode, [amb[i] for i in big],
                    **span_kw)):
                out[i] = res
        sub_amb = None
        if any(amb[i] is not None for i in small):
            # the batch engine wants a dense list (no None entries)
            sub_amb = [amb[i] if amb[i] is not None else np.zeros(len(records[i]), np.uint8)
                       for i in small]
        rid, *planes = batch.sketch_batch([records[i] for i in small], k, w, hasher, mode, sub_amb,
                                          dna=dna, device=device)
        with stage("split by record"):
            bounds = np.cumsum(np.bincount(rid, minlength=len(small)))[:-1]
            splits = [np.split(p, bounds) for p in planes]
            for j, i in enumerate(small):
                out[i] = tuple(s[j] for s in splits) if len(splits) > 1 else splits[0][j]
        empty = np.zeros(0, np.uint32)
        for i in range(len(records)):
            if out[i] is None:  # records shorter than one window
                out[i] = (empty, empty) if mode == pipeline.MODE_SUPERKMERS else empty
        return out


def sketch_batch(reads, k: int, w: int, hasher: KmerHasher,
                 mode: str = pipeline.MODE_MINIMIZERS, ambiguous=None,
                 dna: bool | None = None, *, device: torch.device | str = "cuda"):
    """Batched reads: (read_ids, positions[, super-k-mer indices]), np.uint32,
    ordered by read; one launch per stride bucket (ops/batch.py),
    bit-identical to sketching each read alone."""
    check_supported(k, hasher, mode)
    return batch.sketch_batch(reads, k, w, hasher, mode, ambiguous, dna=dna, device=device)
