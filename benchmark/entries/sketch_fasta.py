"""`python -m simd_minimizers_tpu_torch.sketch_fasta <fasta> --k --w
[--canonical] [--skip-ambiguous] --values --out <npz> --device <device>`
in process (`sketch_fasta.main`): the parse, `sketch_records`, each
record's values and the compressed .npz write, calls back to back. Call i
writes the .npz of its parity beside the FASTA, so the result a call
returns outlives the next call. A part is a record; its answer is its
positions and their values read back from the .npz, the values (u64) as
their low and high 32-bit words."""

from __future__ import annotations

import os
import zipfile

import numpy as np

import entry


class Entry(entry.Entry):
    def __init__(self, config, inputs, device):
        super().__init__(config, inputs, device)
        from simd_minimizers_tpu_torch import sketch_fasta

        if config["mode"] != "minimizers":
            raise ValueError(f"sketch_fasta writes minimizers here, not {config['mode']!r}")
        self.main = sketch_fasta.main
        self.argv = [inputs.path, "--k", str(config["k"]), "--w", str(config["w"]), "--values",
                     "--device", str(device)]
        self.argv += ["--canonical"] * config["canonical"]
        self.argv += ["--skip-ambiguous"] * (inputs.masks is not None)

    def warm_calls(self) -> int:
        """One: a call leaves its answer in a file and frees what it held on
        the card, so a second warm call meets no shape the first did not."""
        return 1

    def free(self) -> None:
        self.inputs.remove()

    def call(self, i):
        out = os.path.join(os.path.dirname(self.inputs.path), f"sketch-{i % 2}.npz")
        rc = self.main([*self.argv, "--out", out])
        if rc:
            raise RuntimeError(f"sketch_fasta exited {rc}")
        return out

    def _key(self, r: int) -> str:
        return f"{self.inputs.names[r]}/positions"

    def bases(self, i) -> int:
        return sum(self.inputs.lengths)

    def windows(self, i) -> int:
        return sum(max(n - self.l + 1, 0) for n in self.inputs.lengths)

    def count(self, result) -> int:
        """Positions in the .npz, from the arrays' headers alone."""
        n = 0
        with zipfile.ZipFile(result) as z:
            for r in range(len(self.inputs.parts)):
                with z.open(self._key(r) + ".npy") as f:
                    version = np.lib.format.read_magic(f)
                    shape, _, _ = (np.lib.format.read_array_header_1_0(f) if version == (1, 0)
                                   else np.lib.format.read_array_header_2_0(f))
                n += int(np.prod(shape))
        return n

    def parts(self, result) -> list:
        with np.load(result) as z:
            return [(r, self._answer(z, name)) for r, name in enumerate(self.inputs.names)]

    @staticmethod
    def _answer(z, name: str) -> tuple:
        words = z[f"{name}/values"].view(np.uint32)  # little-endian: the low word first
        return z[f"{name}/positions"], words[0::2], words[1::2]
