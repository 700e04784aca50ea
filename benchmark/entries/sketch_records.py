"""`ops.backend.sketch_records(codes, k, w, hasher, mode, ambiguous=masks,
dna=True, device=...)`, the call `sketch_fasta` makes: one call sketches
every record, positions back in host memory."""

from __future__ import annotations

import torch

import entry


class Entry(entry.Entry):
    def __init__(self, config, inputs, device):
        super().__init__(config, inputs, device)
        from simd_minimizers_tpu_torch.ops import backend

        self.backend, self.program_hasher = backend, self.hasher()

    def call(self, i):
        c = self.config
        return self.backend.sketch_records(self.inputs.parts, c["k"], c["w"], self.program_hasher,
                                           c["mode"], ambiguous=self.inputs.masks, dna=True,
                                           device=self.device)

    def bases(self, i) -> int:
        return sum(self.inputs.lengths)

    def windows(self, i) -> int:
        return sum(max(n - self.l + 1, 0) for n in self.inputs.lengths)

    def count(self, result) -> int:
        return sum(int(p.numel() if isinstance(p, torch.Tensor) else p.size) for p in result)

    def parts(self, result) -> list:
        return list(enumerate(result))
