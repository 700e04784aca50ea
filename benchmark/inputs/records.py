"""Genomes: one sequence per record. The traffic's `records` at the lengths
listed, then `contigs.count` contigs of `contigs.bp` bases (lengths from
the shape seed) in a seed-drawn order; with `n_runs`, a bool mask per
record, runs of N shaped like an assembled chromosome (`per_1e8_bp` runs
per 1e8 bases, at least one a record, each of `bp` bases; isolated Ns at
`isolated_rate`).

`place`: `host_codes`, uint8 2-bit codes, one per byte, in host memory, as
a FASTA reader yields them; `card_packed`, a 2-bit byte stream (4 bases a
byte, base i at bits 2 (i % 4) of byte i // 4) per record, on the card.
A part is a record; its answer is its positions.
"""

from __future__ import annotations

import numpy as np
import torch

import gen
import reference


def record_lengths(traffic: dict, rng: np.random.Generator) -> list:
    """The listed records' lengths, then the contigs' in the order `rng`
    draws. Contig lengths come from the traffic's shape seed."""
    lens = [int(x) for _, x in traffic["records"]]
    c = traffic["contigs"]
    if c["count"]:
        shape = np.random.default_rng(traffic["shape_seed"])
        contigs = shape.integers(c["bp"][0], c["bp"][1] + 1, c["count"])
        lens += [int(contigs[i]) for i in rng.permutation(c["count"])]
    return lens


def n_masks(lens: list, spec: dict, traffic: dict, rng: np.random.Generator,
            g: torch.Generator, device) -> list:
    """Per-record bool masks (host numpy views of one array): `per_1e8_bp`
    runs of N per 1e8 bases, at least one a record, their lengths from the
    shape seed and their places from the run's seed; isolated Ns at
    `isolated_rate`, as many per record whatever the seed."""
    shape = np.random.default_rng(traffic["shape_seed"] + 1)
    flags = torch.zeros(sum(lens), dtype=torch.bool, device=device)
    start = 0
    for n in lens:
        runs = max(1, round(spec["per_1e8_bp"] * n / 1e8))
        run_bp = shape.integers(spec["bp"][0], spec["bp"][1] + 1, runs)
        for a, m in zip(rng.integers(0, n, runs), run_bp):
            flags[start + int(a):start + min(int(a) + int(m), n)] = True
        isolated = round(n * spec["isolated_rate"])
        if isolated:
            flags[start + torch.randint(0, n, (isolated,), generator=g, device=device)] = True
        start += n
    return gen.split(flags.cpu().numpy(), lens)


def make(traffic: dict, seed: int, device) -> gen.Inputs:
    rng = np.random.default_rng(gen.seed64(seed))
    g = gen.generator(seed, device)
    place = traffic["place"]
    lens = record_lengths(traffic, rng)
    if place == "host_codes":
        flat = torch.randint(0, 4, (sum(lens),), dtype=torch.uint8, generator=g,
                             device=device).cpu().numpy()
        parts = gen.split(flat, lens)
    elif place == "card_packed":
        parts = [torch.randint(0, 256, (-(-n // 4),), dtype=torch.uint8, generator=g,
                               device=device) for n in lens]
    else:
        raise ValueError(f"records cannot be placed {place!r}")
    masks = None
    if traffic.get("n_runs"):
        masks = n_masks(lens, traffic["n_runs"], traffic, rng, g, device)
    return gen.Inputs("records", place, lens, parts, masks)


def expected(inputs: gen.Inputs, keys, ref, device):
    for r in sorted(keys):
        if inputs.place == "card_packed":
            codes, amb = reference.unpack_2bit(inputs.parts[r], inputs.lengths[r]), None
        else:
            codes = torch.from_numpy(inputs.parts[r]).to(device)
            amb = None if inputs.masks is None else torch.from_numpy(inputs.masks[r]).to(device)
        yield r, ref.sequence(codes, amb)


def small(traffic: dict) -> dict:
    return {"records": [[n, min(x, 200_000 + i)] for i, (n, x) in enumerate(traffic["records"][:2])],
            "contigs": {"count": min(traffic["contigs"]["count"], 9), "bp": [1_000, 4_000]}}
