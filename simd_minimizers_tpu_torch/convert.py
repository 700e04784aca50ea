"""What the port carries across from the reference: the hasher's state, the
2-bit sequence and its ambiguity mask, as tensors on one `torch.device`.

`hasher_tensors` is the counterpart of `simd_minimizers_tpu.ops.pipeline.
hasher_jit_args` (which lives in a JAX module, so the port keeps its own
copy). The NT table itself has one home, `simd_minimizers_tpu.hashers`;
a seeded `NtHasher`'s table is data and crosses over the same way.
"""

from __future__ import annotations

import numpy as np
import torch

from simd_minimizers_tpu import native
from simd_minimizers_tpu.hashers import KmerHasher
from simd_minimizers_tpu.seq.packed import PackedSeq

from .utils.device import require_cuda


def hasher_tensors(hasher: KmerHasher, device: torch.device | str):
    """(key, table, mul_const): key = (kind, canonical, rot_offset); table =
    the four u32 entries as an int64 tensor on `device`; mul_const the
    hasher's multiplier (0 where it has none)."""
    key = (hasher.kind, hasher.canonical, getattr(hasher, "rot_offset", 0))
    table = np.asarray(getattr(hasher, "table", np.zeros(4, np.uint32)), np.uint32)
    mul_const = int(getattr(hasher, "mul_const", 0))
    return key, torch.tensor(table.astype(np.int64), device=device), mul_const


def packed_words(seq, device: torch.device | str) -> torch.Tensor:
    """The sequence as a 2-bit byte stream (4 bases per byte, base i at bits
    2 * (i % 4)) in a uint8 tensor on `device`.

    A `PackedSeq` whose first base is byte-aligned is used as it is (no
    host copy); any other 2-bit sequence is repacked once on the host.
    """
    device = require_cuda(device)
    if isinstance(seq, PackedSeq) and seq.offset % 4 == 0:
        data, _ = seq.packed_with_offset()
    else:
        data = native.pack_2bit(seq.codes())
    return torch.from_numpy(np.ascontiguousarray(data)).to(device)


def ambiguity_plane(ambiguous, n: int, device: torch.device | str) -> torch.Tensor:
    """A per-base ambiguity mask (`PackedNSeqVec.ambiguous`, or a caller's
    bool or uint8 array of n flags, nonzero = ambiguous) as a 1-bit plane
    in a uint8 tensor on `device`: base i at bit i % 8 of byte i // 8, the
    bits past n zero. The counterpart of the JAX package's packing of the
    ambiguity plane (simd_minimizers_tpu/ops/fused.py `_fused_launch`); an
    eighth of the mask's bytes cross the bus."""
    device = require_cuda(device)
    mask = np.asarray(ambiguous)
    if mask.dtype not in (np.bool_, np.uint8):
        raise TypeError(f"the ambiguity mask must be bool or uint8, got {mask.dtype}")
    if mask.shape != (n,):
        raise ValueError(f"the ambiguity mask has shape {mask.shape}, the sequence {n} bases")
    return torch.from_numpy(np.packbits(mask, bitorder="little")).to(device)
