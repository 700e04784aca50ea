"""`ops.device_sketcher.ShortSeqSketcher(k, w, hasher, mode).sketch(codes)`:
host codes in, host positions out; call i takes the pool's sequence
order[i mod count]. Set-up sketches each sequence of the pool once."""

from __future__ import annotations

import entry


class Entry(entry.Entry):
    def __init__(self, config, inputs, device):
        super().__init__(config, inputs, device)
        from simd_minimizers_tpu_torch.ops.device_sketcher import ShortSeqSketcher

        self.sketcher = ShortSeqSketcher(config["k"], config["w"], self.hasher(), config["mode"],
                                         device=device)

    def warm_calls(self) -> int:
        return len(self.inputs.parts)

    def free(self) -> None:
        self.sketcher = None

    def _index(self, i) -> int:
        return int(self.inputs.order[i % len(self.inputs.order)])

    def call(self, i):
        j = self._index(i)
        return j, self.sketcher.sketch(self.inputs.parts[j])

    def bases(self, i) -> int:
        return self.inputs.lengths[self._index(i)]

    def windows(self, i) -> int:
        return max(self.bases(i) - self.l + 1, 0)

    def count(self, result) -> int:
        return int(result[1].size)

    def parts(self, result) -> list:
        return [result]
