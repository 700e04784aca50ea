"""What an entry of the program is to the harness. A traffic file's `entry`
names `benchmark/entries/<entry>.py`, whose class `Entry` (a subclass of
`Entry` below) is built once in set-up from the configuration and the
traffic's inputs.

`call(i)` makes the i-th call of the window and returns its result on the
host (or on the card, synchronised); `bases(i)` and `windows(i)` count
its input, `count(result)` its answers; `parts(result)` gives (key,
answer) for each part of it that is checked against the reference (keys as
the inputs' generator gives them); `free()` drops the program's state
before the reference runs. Everything of the program is imported inside
the entries, once the harness has looked for a card.
"""

from __future__ import annotations

import plugins


class Entry:
    packed = False  # the input is a 2-bit packed stream (its decode is work)

    def __init__(self, config, inputs, device):
        self.config, self.inputs, self.device = config, inputs, device
        self.l = config["k"] + config["w"] - 1

    def hasher(self):
        """The program's hasher of the configuration."""
        import simd_minimizers_tpu_torch as smt

        cls = getattr(smt, plugins.load("hashes", self.config["hasher"]).PROGRAM_HASHER)
        return cls(self.config["k"], canonical=self.config["canonical"])

    def warm_calls(self) -> int:
        """Calls of set-up: the window holds one result while it makes the next."""
        return 2

    def free(self) -> None:
        """Drop the program's objects (the inputs stay for the reference)."""

    def call(self, i):
        raise NotImplementedError

    def bases(self, i) -> int:
        raise NotImplementedError

    def windows(self, i) -> int:
        raise NotImplementedError

    def count(self, result) -> int:
        raise NotImplementedError

    def parts(self, result) -> list:
        raise NotImplementedError
