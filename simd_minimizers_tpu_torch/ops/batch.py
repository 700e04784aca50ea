"""Batched reads: flat slot packing with ambiguous padding.

The port's copy of `simd_minimizers_tpu/ops/batch.py` (`MAX_LAUNCH_CHARS`,
`_stride_bucket`, `_fill_slots`, `sketch_batch`). Reads are laid end to
end at a per-batch `stride` (read i owns chars [i * stride, i * stride +
len)), and every padding char is flagged in the launch's 1-bit ambiguity
plane: windows that touch padding are SKIPPED, so reads never interact, the
dedup restarts after each SKIPPED gap, and a value's read is `src //
stride`. All reads of a stride bucket go through one launch of the kernel
(`ops/fused.py`, one code per byte, the plane built on the device from the
lengths by `convert.padding_plane`) in every mode, super-k-mers included.
Strides are bucketed to a 3-bit mantissa, so padding wastes under 12.5%.

The read attribution runs on the device too; one stable sort orders the
values by read, and they come down to the host once.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import convert
from ..utils.device import require_cuda
from ..utils.profiling import span, stage
from . import fused, pipeline

# max chars per launch (the kernel takes fewer than 2^31)
MAX_LAUNCH_CHARS = 1 << 30
BACKENDS = ("fused", "pipeline")


def _stride_bucket(x: int) -> int:
    """Smallest value >= x of the form m * 2^e with 8 <= m < 16."""
    if x <= 8:
        return 8
    e = x.bit_length() - 4
    return ((x + (1 << e) - 1) >> e) << e


def _fill_slots(reads, ambs, stride: int):
    """(codes, amb) flat uint8 buffers of len(reads) * stride chars: read i
    at [i * stride, i * stride + len), zeros elsewhere; amb holds the reads'
    own flags (None without `ambs`). `reads` is a list of arrays or a (B, L)
    matrix."""
    B = len(reads)
    codes = np.zeros(B * stride, np.uint8)
    amb = None if ambs is None else np.zeros(B * stride, np.uint8)
    cview = codes.reshape(B, stride)
    aview = None if amb is None else amb.reshape(B, stride)
    lens = [reads.shape[1]] * B if isinstance(reads, np.ndarray) else [len(r) for r in reads]
    L0 = lens[0] if B else 0
    if B and all(ln == L0 for ln in lens):  # uniform length: vectorized fill
        cview[:, :L0] = np.asarray(reads, dtype=np.uint8).reshape(B, L0)
        if aview is not None:
            aview[:, :L0] = np.asarray(ambs, dtype=np.uint8).reshape(B, L0)
    else:
        for i, rd in enumerate(reads):
            cview[i, : lens[i]] = rd
            if aview is not None:
                aview[i, : lens[i]] = ambs[i]
    return codes, amb


def launches(reads, ambiguous, l: int, device: torch.device):
    """The batch's launches, one per stride bucket (split at
    MAX_LAUNCH_CHARS): (read ids, stride, chars, n, plane) with the slots'
    chars on `device` (one per byte) and the padding plane. `reads` is a
    list of uint8 arrays or a (B, L) matrix; `ambiguous` a list of masks or
    None."""
    matrix = reads if isinstance(reads, np.ndarray) else None
    with span("stride buckets"):
        lens = (np.full(len(reads), reads.shape[1], np.int64) if matrix is not None
                else np.fromiter((len(rd) for rd in reads), np.int64, len(reads)))
        uniq, inverse = np.unique(lens, return_inverse=True)
        # eligible reads (len >= l) by stride bucket; stride > len so at
        # least one ambiguous padding char separates consecutive reads
        strides = np.asarray([_stride_bucket(int(x) + 1) if x >= l else 0 for x in uniq],
                             np.int64)[inverse]
    for stride in sorted(set(strides.tolist()) - {0}):
        idxs = np.flatnonzero(strides == stride)
        per_launch = max(MAX_LAUNCH_CHARS // stride, 1)
        for s0 in range(0, len(idxs), per_launch):
            sub = idxs[s0 : s0 + per_launch]
            with span("stride buckets"):
                sub_reads = matrix[sub] if matrix is not None else [reads[i] for i in sub]
                sub_amb = [ambiguous[i] for i in sub] if ambiguous is not None else None
            with stage("slot fill"):
                codes, amb = _fill_slots(sub_reads, sub_amb, stride)
            with stage("upload and padding plane"):
                plane = convert.padding_plane(
                    lens[sub], stride, device,
                    None if amb is None else convert.code_bytes(amb, device))
                chars = convert.code_bytes(codes, device)
            yield sub, stride, chars, len(sub) * stride, plane


def sketch_batch(reads, k: int, w: int, hasher, mode: str = pipeline.MODE_MINIMIZERS,
                 ambiguous=None, *, dna: bool | None = None,
                 device: torch.device | str = "cuda", backend: str = "fused"):
    """Sketch a batch of reads; one launch per stride bucket.

    reads: list of per-read uint8 code arrays (2-bit DNA codes if `dna`,
    raw text bytes if not; None probes them), or a (B, L) uint8 matrix of
    equal-length reads. `backend` "fused" runs the kernels on a CUDA
    `device` and their plain versions on the CPU; "pipeline" runs the plain
    pipeline (`pipeline.run_pipeline`) on the same launches.

    Returns (read_ids, positions) with positions local to each read;
    (read_ids, positions, window_indices) for super-k-mers; syncmer modes
    return (read_ids, window_indices); np.uint32, ordered by read, then
    position, bit-identical to running every read on its own. Reads shorter
    than l = k + w - 1 have no values.
    """
    l = k + w - 1
    if mode == pipeline.MODE_OPEN_SYNCMERS and w % 2 == 0:
        raise AssertionError("open syncmers require odd w")
    if hasher.canonical and l % 2 == 0:
        raise AssertionError(f"window length l={l} must be odd to determine strand")
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    device = require_cuda(device)
    with span("record probe"):
        if isinstance(reads, np.ndarray) and reads.ndim == 2:
            reads = np.asarray(reads, dtype=np.uint8)
        else:
            reads = [np.asarray(r, dtype=np.uint8).ravel() for r in reads]
        if ambiguous is not None:
            ambiguous = [np.asarray(a, dtype=np.uint8).ravel() for a in ambiguous]
        if dna is None:
            dna = convert.is_dna(reads) if isinstance(reads, np.ndarray) else all(
                convert.is_dna(rd) for rd in reads)
    text = not dna
    (kind, canonical, rot), tables = convert.hasher_tensors(hasher, device, text)
    run = fused.fused_sketch if backend == "fused" else pipeline.run_pipeline
    superkmers = mode == pipeline.MODE_SUPERKMERS
    parts = []  # (read ids, positions[, window indices]) per launch, on the device
    for sub, stride, chars, n, plane in launches(reads, ambiguous, l, device):
        with stage("kernels"):
            res = run(chars, n, k, w, tables, rot, canonical, mode, plane, text=text, kind=kind,
                      byte_codes=not text)
        with stage("read attribution and order"):
            out, idx = res if superkmers else (res, None)
            slot = (idx if superkmers else out).long() // stride
            part = [convert.upload(sub, device, "read ids")[slot], out.long() - slot * stride]
            if superkmers:
                part.append(idx.long() - slot * stride)
            parts.append(part)

    planes = 3 if superkmers else 2
    if not parts:
        empty = np.zeros(0, np.uint32)
        return (empty,) * planes
    with stage("read attribution and order"):
        cols = [torch.cat([p[c] for p in parts]) for c in range(planes)]
        if len(parts) > 1:
            order = torch.sort(cols[0], stable=True).indices
            cols = [c[order] for c in cols]
        cols = tuple(c.to(torch.int32) for c in cols)
    return convert.Download(cols).result()
