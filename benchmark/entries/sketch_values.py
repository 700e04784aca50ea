"""`ops.backend.sketch(chars, n, k, w, hasher, mode, values=True)` on each
record's 2-bit stream already on the card: SSHash's parse, the positions
and first-window indices of the super-k-mers with each minimizer's
canonical u64 value, all left on the card; a call sketches every record,
then waits for the card. A part is a record; its answer is the four
planes the reference gives, the values' two halves as views of their
words (keeping a part copies nothing)."""

from __future__ import annotations

import torch

import plugins


def halves(values: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(low, high) 32 bits of int64 values holding u64 bits, as strided
    int32 views (the card and the CPU are little-endian)."""
    words = values.view(torch.int32)
    return words[0::2], words[1::2]


class Entry(plugins.load("entries", "sketch").Entry):
    def call(self, i):
        c = self.config
        out = [self.backend.sketch(chars, n, c["k"], c["w"], self.program_hasher, c["mode"],
                                   values=True)
               for chars, n in zip(self.inputs.parts, self.inputs.lengths)]
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return out

    def count(self, result) -> int:
        return sum(int(planes[0].numel()) for planes in result)

    def parts(self, result) -> list:
        return [(r, (*planes[:-1], *halves(planes[-1]))) for r, planes in enumerate(result)]
