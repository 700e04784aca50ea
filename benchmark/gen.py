"""What the input generators share. A traffic file's `inputs` names its
generator, `benchmark/inputs/<inputs>.py`, which reads the file's
parameters and makes the inputs from the run's seed:

- `make(traffic, seed, device) -> Inputs`;
- `expected(inputs, keys, ref, device)`: (key, the reference's answer) for
  each key of a part, one at a time;
- `small(traffic)`: the parameters that shrink the inputs to a size the
  CPU tests hold.

Sizes come from the traffic file and its `shape_seed`, so every run seed
gets the same set of sizes (the same work) in another order; the seed
draws the bases, the places of the N runs and the order. Bases are drawn on
`device` with a `torch.Generator` in a few large calls, then moved to where
the traffic file's `place` says they are when the program is called.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

import plugins


@dataclasses.dataclass
class Inputs:
    """A traffic's inputs. `parts` are what a call is checked by (records,
    read batches, pool sequences); `order` the pool's visiting order."""

    kind: str  # the generator's name
    place: str
    lengths: list  # bases of each part
    parts: list  # the program's input, one item per part
    masks: list | None = None  # per record bool masks (host), or None
    order: np.ndarray | None = None


def seed64(seed: int) -> int:
    """The seed as an unsigned 64-bit number (any whole number is taken)."""
    return seed & ((1 << 64) - 1)


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed64(seed))


def split(flat: np.ndarray, lens: list) -> list:
    """`flat` cut into consecutive views of the lengths `lens`."""
    bounds = np.cumsum([0] + lens)
    return [flat[a:b] for a, b in zip(bounds[:-1], bounds[1:])]


def make(traffic: dict, seed: int, device) -> Inputs:
    """The inputs of `traffic` for `seed`, made on `device` by the generator
    the traffic names."""
    return plugins.load("inputs", traffic["inputs"]).make(traffic, seed, device)


def expected(inputs: Inputs, keys, ref, device):
    return plugins.load("inputs", inputs.kind).expected(inputs, keys, ref, device)
