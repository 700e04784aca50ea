"""Read sets: `batches` batches of `count` reads of `alphabet` bytes, in
host memory as FASTQ holds them (`place` `host_ascii`). With `bp` one
number, a batch is a (count, bp) uint8 matrix; with `bp` [lo, hi], a list
of uint8 arrays whose lengths, uniform in [lo, hi], come from the shape
seed (the same lengths on every seed). A part is a batch; its answer is
(read ids, positions).
"""

from __future__ import annotations

import numpy as np
import torch

import gen
import reference


def _lengths(spec: dict, shape_seed: int) -> list | None:
    if isinstance(spec["bp"], int):
        return None
    shape = np.random.default_rng(shape_seed)
    return [[int(x) for x in shape.integers(spec["bp"][0], spec["bp"][1] + 1, spec["count"])]
            for _ in range(spec["batches"])]


def make(traffic: dict, seed: int, device) -> gen.Inputs:
    spec = traffic["reads"]
    if traffic["place"] != "host_ascii":
        raise ValueError(f"reads cannot be placed {traffic['place']!r}")
    g = gen.generator(seed, device)
    alphabet = torch.tensor(list(spec["alphabet"].encode()), dtype=torch.uint8, device=device)
    lens = _lengths(spec, traffic["shape_seed"])
    parts = []
    for b in range(spec["batches"]):
        n = spec["count"] * spec["bp"] if lens is None else sum(lens[b])
        flat = alphabet[torch.randint(0, len(alphabet), (n,), generator=g, device=device)]
        flat = flat.cpu().numpy()
        parts.append(flat.reshape(spec["count"], spec["bp"]) if lens is None
                     else gen.split(flat, lens[b]))
    return gen.Inputs("reads", traffic["place"], [batch_bases(p) for p in parts], parts)


def batch_bases(batch) -> int:
    return batch.size if isinstance(batch, np.ndarray) else sum(r.size for r in batch)


def read_lengths(batch) -> list:
    """The length of each read of a batch."""
    if isinstance(batch, np.ndarray):
        return [batch.shape[1]] * batch.shape[0]
    return [r.size for r in batch]


def expected(inputs: gen.Inputs, keys, ref, device):
    for b in sorted(keys):
        batch = inputs.parts[b]
        if isinstance(batch, np.ndarray):
            mat, lens = torch.from_numpy(batch), None
        else:
            lens = torch.tensor(read_lengths(batch))
            mat = torch.zeros((len(batch), int(lens.max())), dtype=torch.uint8)
            for row, r in enumerate(batch):
                mat[row, :r.size] = torch.from_numpy(r)
            lens = lens.to(device)
        yield b, ref.rows(reference.ascii_codes(mat.to(device)), lens)


def small(traffic: dict) -> dict:
    spec = traffic["reads"]
    bp = spec["bp"] if isinstance(spec["bp"], int) else [min(spec["bp"][0], 20),
                                                         min(spec["bp"][1], 3_000)]
    return {"reads": {**spec, "count": 3_000 if isinstance(bp, int) else 200, "bp": bp,
                      "batches": 2}}
