"""`Builder.run_batch(reads, device=...)` of a batch of reads (a (B, L)
ASCII matrix, or a list of reads): (read ids, positions) back in host
memory. Call i takes batch i mod the number of batches."""

from __future__ import annotations

import numpy as np

import entry


class Entry(entry.Entry):
    def __init__(self, config, inputs, device):
        super().__init__(config, inputs, device)
        import simd_minimizers_tpu_torch as smt

        if config["mode"] != "minimizers":
            raise ValueError(f"run_batch drives minimizers, not {config['mode']!r}")
        self.builder = smt.Builder(config["k"], config["w"],
                                   canonical=config["canonical"]).hasher(self.hasher())

    def _batch(self, i) -> int:
        return i % len(self.inputs.parts)

    def call(self, i):
        b = self._batch(i)
        return b, self.builder.run_batch(self.inputs.parts[b], device=self.device)

    def bases(self, i) -> int:
        return self.inputs.lengths[self._batch(i)]

    def windows(self, i) -> int:
        batch = self.inputs.parts[self._batch(i)]
        if isinstance(batch, np.ndarray):
            return batch.shape[0] * max(batch.shape[1] - self.l + 1, 0)
        return sum(max(r.size - self.l + 1, 0) for r in batch)

    def count(self, result) -> int:
        return int(result[1][1].size)

    def parts(self, result) -> list:
        return [result]
