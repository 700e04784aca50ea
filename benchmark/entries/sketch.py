"""`ops.backend.sketch(chars, n, k, w, hasher, mode)` on each record's 2-bit
stream already on the card, the call `Builder.run` makes after its upload:
positions stay on the card; a call sketches every record, then waits for
the card."""

from __future__ import annotations

import torch

import plugins


class Entry(plugins.load("entries", "sketch_records").Entry):
    packed = True

    def call(self, i):
        c = self.config
        out = [self.backend.sketch(chars, n, c["k"], c["w"], self.program_hasher, c["mode"])
               for chars, n in zip(self.inputs.parts, self.inputs.lengths)]
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return out
