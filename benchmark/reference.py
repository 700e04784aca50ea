"""The plain reference that decides `correct`, and what its parts share.

A configuration's `mode` names its reference, `benchmark/references/<mode>.py`,
whose `make(config, control)` returns an object with
- `sequence(codes, ambiguous)`: the answer of one sequence of 2-bit codes
  (1-D uint8) with an optional 1-D bool mask of ambiguous chars;
- `rows(codes, lens)`: (row ids, answers) of each row of a (B, L) code
  matrix alone (the first `lens[i]` codes of row i);
- `least_work(windows, chars, answers, packed=, masked=)`: (operations,
  bytes) that the function needs at least, for the yardstick.
A configuration's `hasher` names its plain k-mer hash,
`benchmark/hashes/<hasher>.py`. `control=True` breaks one guarantee the
configuration states: the control, which must come out not correct.

The references are plain PyTorch, on any device, in blocks that fit, and
import nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch

import plugins

_LOW32 = 0xFFFF_FFFF


def make(config: dict, control: bool = False):
    return plugins.load("references", config["mode"]).make(config, control)


def ascii_codes(ascii_bytes: torch.Tensor) -> torch.Tensor:
    """2-bit codes of ACGT bytes (upper or lower case): bits 1-2 of the byte."""
    return (ascii_bytes >> 1) & 3


def unpack_2bit(packed: torch.Tensor, n: int) -> torch.Tensor:
    """The first n codes of a 2-bit byte stream (base i at bits 2 (i % 4) of
    byte i // 4) as uint8."""
    shifts = torch.arange(0, 8, 2, dtype=torch.uint8, device=packed.device)
    return ((packed[:, None] >> shifts) & 3).reshape(-1)[:n]


def as_int64(values, device) -> torch.Tensor:
    """A program's positions (u32 bits in a uint32 or int32 array or
    tensor) as an int64 tensor on `device`, to compare with the reference."""
    if isinstance(values, np.ndarray):
        values = torch.from_numpy(np.ascontiguousarray(values).view(np.int32))
    return values.to(device).long() & _LOW32


def same(value, want) -> bool:
    """Whether a program's answer (u32 values, or a tuple of planes) equals
    the reference's (int64 tensors), bit for bit."""
    if isinstance(want, tuple):
        return (isinstance(value, tuple) and len(value) == len(want)
                and all(same(v, x) for v, x in zip(value, want)))
    if isinstance(value, tuple):
        return False
    got = as_int64(value, want.device)
    return got.shape == want.shape and bool(torch.equal(got, want))
