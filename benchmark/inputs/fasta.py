"""A genome as a FASTA file (`place` `host_fasta`): the records of
`inputs/records.py` (the traffic's `records` and contigs, its `n_runs`
masks), written at set-up as an uppercase FASTA of 60-base lines with an N
at every masked base, into a directory of its own under TMPDIR, which goes
with the inputs (`FastaInputs.remove`, or when they are collected). A part
is a record: the 2-bit codes a FASTA reader yields for it (an N reads as
code 3, bits 1-2 of its byte) and its mask. Its answer is what the command
line writes with `--values`: its positions (the configuration's
reference), and the u64 value of the k-mer at each, canonical where the
configuration is (`references/superkmers.values_u64`), as its low and high
32 bits.
"""

import dataclasses
import os
import tempfile

import numpy as np
import torch

import gen
import plugins
import reference

LINE = 60  # bases a line
_ASCII = np.frombuffer(b"ACTG", np.uint8)  # by 2-bit code: bits 1-2 of each byte


@dataclasses.dataclass
class FastaInputs(gen.Inputs):
    names: list = dataclasses.field(default_factory=list)  # each record's FASTA name
    path: str = ""  # the FASTA file
    tmp: tempfile.TemporaryDirectory | None = None  # the directory that holds it

    def remove(self) -> None:
        """Remove the file and whatever else its directory holds."""
        if self.tmp is not None:
            self.tmp.cleanup()


def fasta_lines(codes: np.ndarray, mask: np.ndarray | None) -> bytes:
    """A record's sequence lines: its bases as uppercase ACGT, N where
    masked, LINE to a line, each line ended by a newline."""
    seq = _ASCII[codes]
    if mask is not None:
        seq[mask] = ord("N")
    full = seq.size // LINE
    lines = np.full((full, LINE + 1), ord("\n"), np.uint8)
    lines[:, :LINE] = seq[:full * LINE].reshape(full, LINE)
    rest = seq[full * LINE:]
    return lines.tobytes() + (rest.tobytes() + b"\n" if rest.size else b"")


def make(traffic: dict, seed: int, device) -> FastaInputs:
    if traffic["place"] != "host_fasta":
        raise ValueError(f"a FASTA cannot be placed {traffic['place']!r}")
    recs = plugins.load("inputs", "records").make({**traffic, "place": "host_codes"}, seed, device)
    names = [name for name, _ in traffic["records"]]
    names += [f"contig{i}" for i in range(len(recs.parts) - len(names))]
    n_code = int(reference.ascii_codes(torch.tensor(ord("N"), dtype=torch.uint8)))
    masks = recs.masks or [None] * len(recs.parts)
    tmp = tempfile.TemporaryDirectory(prefix="fasta-cli-")
    path = os.path.join(tmp.name, "genome.fa")
    with open(path, "wb") as f:
        for name, codes, mask in zip(names, recs.parts, masks):
            if mask is not None:
                codes[mask] = n_code  # what the reader yields for an N
            f.write(f">{name}\n".encode() + fasta_lines(codes, mask))
    return FastaInputs("fasta", traffic["place"], recs.lengths, recs.parts, recs.masks,
                       names=names, path=path, tmp=tmp)


def expected(inputs: FastaInputs, keys, ref, device):
    skm = plugins.load("references", "superkmers")
    for r, pos in plugins.load("inputs", "records").expected(inputs, keys, ref, device):
        codes = torch.from_numpy(inputs.parts[r]).to(device)
        yield r, (pos, *skm.halves(skm.values_u64(codes, pos, ref.k, ref.canonical)))


def small(traffic: dict) -> dict:
    return plugins.load("inputs", "records").small(traffic)
