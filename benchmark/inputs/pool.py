"""A pool of short sequences: `count` sequences of 2-bit codes in host
memory (`place` `host_codes`), lengths log-uniform in `bp` from the shape
seed, visited in a seed-drawn order. A part is a sequence; its answer is
its positions.
"""

from __future__ import annotations

import numpy as np
import torch

import gen


def make(traffic: dict, seed: int, device) -> gen.Inputs:
    spec = traffic["pool"]
    if traffic["place"] != "host_codes" or spec["lengths"] != "log_uniform":
        raise ValueError(f"a pool of {spec['lengths']} lengths cannot be placed "
                         f"{traffic['place']!r}")
    rng = np.random.default_rng(gen.seed64(seed))
    shape = np.random.default_rng(traffic["shape_seed"])
    lo, hi = np.log(spec["bp"][0]), np.log(spec["bp"][1])
    lens = [int(x) for x in np.rint(np.exp(shape.uniform(lo, hi, spec["count"])))]
    flat = torch.randint(0, 4, (sum(lens),), dtype=torch.uint8, generator=gen.generator(seed, device),
                         device=device).cpu().numpy()
    return gen.Inputs("pool", traffic["place"], lens, gen.split(flat, lens),
                      order=rng.permutation(spec["count"]))


def expected(inputs: gen.Inputs, keys, ref, device):
    keys = sorted(keys)
    lens = torch.tensor([inputs.lengths[j] for j in keys])
    mat = torch.zeros((len(keys), int(lens.max())), dtype=torch.uint8)
    for row, j in enumerate(keys):
        mat[row, :lens[row]] = torch.from_numpy(inputs.parts[j])
    rid, pos = ref.rows(mat.to(device), lens.to(device))
    bounds = torch.searchsorted(rid, torch.arange(len(keys) + 1, device=rid.device)).tolist()
    for row, j in enumerate(keys):
        yield j, pos[bounds[row]:bounds[row + 1]]


def small(traffic: dict) -> dict:
    spec = traffic["pool"]
    return {"pool": {**spec, "count": 200, "bp": [spec["bp"][0], min(spec["bp"][1], 4_000)]}}
