"""FASTA: the port's vectorised `seq.fasta` reader == the JAX package's
`read_fasta` and its `native.fasta_scan` (the C++ scanner and the NumPy
fallback) on lowercase, IUPAC and N, CRLF, blank lines, a headerless file,
an empty record and `.gz`; and `python -m simd_minimizers_tpu_torch.sketch_fasta
--device cpu` == the JAX package's `backend.sketch_records` on the same
records, in the `.npz` layout of examples/sketch_fasta.py.
"""

import gzip
import os
import subprocess
import sys

import numpy as np
import pytest

from simd_minimizers_tpu import native
from simd_minimizers_tpu.hashers import NtHasher
from simd_minimizers_tpu.ops import backend as jbackend
from simd_minimizers_tpu.ops import pipeline as jpipeline
from simd_minimizers_tpu.ops import values as jvalues
from simd_minimizers_tpu.seq import fasta as jfasta
from simd_minimizers_tpu_torch.seq import fasta

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CASES = {
    "two records, CRLF, lowercase, IUPAC": (
        b">chr1 some description\r\nACGTacgtNNRY\r\nGGGG\n>chr2\nTTTT\nACGT\n"),
    "empty": b"",
    "header only": b">only header\n",
    "no final newline": b">a\nACGT",
    "empty record, blank line": b">a\n\n>b\nAC\n",
    "headerless": b"ACGT\nAC\n",
    "headerless, then a header": b"ACGTN\n\n>x y\nacgtn\r\n\r\n>z\n",
    "blank lines and CR-only lines": b"\n\n>r1\n\r\nAC\n\nGT\r\n\n>r2\r\nnnnn\n\n",
    "interior CR and symbols": b">s\nAC\rGT*-.\nWSKMBDHV\n",
}


def _random_fasta(rng, nrec=5, width=60):
    """Records with 60-char lines, N runs and lowercase stretches."""
    acgtn = np.frombuffer(b"ACGTN", np.uint8)
    out = []
    for i in range(nrec):
        n = int(rng.integers(0, 5000))
        seq = acgtn[rng.integers(0, 4, n)]
        for start in rng.integers(0, max(n, 1), 3):
            seq[start:start + int(rng.integers(1, 200))] = ord("N")
        for start in rng.integers(0, max(n, 1), 2):
            seq[start:start + int(rng.integers(1, 500))] |= 0x20
        lines = [seq[j:j + width].tobytes() for j in range(0, n, width)]
        out.append(b">rec%d desc\n" % i + b"\n".join(lines) + b"\n")
    return b"".join(out)


def _assert_scan_equal(raw):
    buf = np.frombuffer(raw, np.uint8)
    got = fasta.fasta_scan(buf)
    want = native.fasta_scan(buf)
    for g, p in zip(got, want, strict=True):
        np.testing.assert_array_equal(g, p)


def _assert_records_equal(got, want):
    assert [(r.name, len(r)) for r in got] == [(r.name, len(r)) for r in want]
    for g, p in zip(got, want):
        np.testing.assert_array_equal(g.codes, p.codes)
        np.testing.assert_array_equal(g.ambiguous, p.ambiguous)
        assert g.codes.dtype == g.ambiguous.dtype == np.uint8


@pytest.mark.parametrize("case", sorted(CASES))
def test_read_fasta_vs_jax(case, tmp_path):
    raw = CASES[case]
    _assert_scan_equal(raw)
    for name, data in (("toy.fa", raw), ("toy.fa.gz", gzip.compress(raw))):
        p = tmp_path / name
        p.write_bytes(data)
        _assert_records_equal(fasta.read_fasta(str(p)), jfasta.read_fasta(str(p)))


def test_read_fasta_random_vs_jax_and_fallback(tmp_path, monkeypatch):
    """Random records (60-char lines, N runs, lowercase), with LF and CRLF,
    against the C++ scanner and the JAX package's NumPy fallback."""
    rng = np.random.default_rng(21)
    raws = [_random_fasta(rng), _random_fasta(rng).replace(b"\n", b"\r\n")]
    raws += [CASES[c] for c in sorted(CASES)]
    for raw in raws:
        _assert_scan_equal(raw)
    monkeypatch.setattr(native, "_build_and_load", lambda: None)
    for raw in raws:
        _assert_scan_equal(raw)
    p = tmp_path / "r.fa"
    p.write_bytes(raws[1])
    recs = fasta.read_fasta(str(p))
    _assert_records_equal(recs, jfasta.read_fasta(str(p)))
    nseq = recs[0].to_nseq()
    np.testing.assert_array_equal(nseq.seq.codes(), recs[0].codes)
    np.testing.assert_array_equal(nseq.ambiguous, recs[0].ambiguous.astype(bool))


def test_read_human_genome_missing(tmp_path):
    with pytest.raises(FileNotFoundError):
        fasta.read_human_genome(str(tmp_path / "absent.fa"))


@pytest.mark.parametrize("args", [["--canonical", "--skip-ambiguous"],
                                  ["--values"], ["--syncmers", "closed", "--canonical"]])
def test_sketch_fasta_cli_vs_jax(args, tmp_path):
    rng = np.random.default_rng(len(args))
    p = tmp_path / "g.fa"
    p.write_bytes(_random_fasta(rng, nrec=12))
    out = tmp_path / "s.npz"
    res = subprocess.run([sys.executable, "-m", "simd_minimizers_tpu_torch.sketch_fasta",
                          str(p), "--k", "15", "--w", "9", "--out", str(out), "--device", "cpu",
                          *args], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "parsed 12 records" in res.stderr and "sketched" in res.stderr
    recs = jfasta.read_fasta(str(p))
    canonical = "--canonical" in args
    mode = (jpipeline.MODE_CLOSED_SYNCMERS if "--syncmers" in args
            else jpipeline.MODE_MINIMIZERS)
    amb = [r.ambiguous for r in recs] if "--skip-ambiguous" in args else None
    want = jbackend.sketch_records([r.codes for r in recs], 15, 9, NtHasher(15, canonical),
                                   mode=mode, ambiguous=amb, dna=True)
    got = np.load(out)
    keys = [f"{r.name}/positions" for r in recs]
    if "--values" in args:
        keys += [f"{r.name}/values" for r in recs]
    assert sorted(got.files) == sorted(keys)
    for r, pos in zip(recs, want):
        np.testing.assert_array_equal(got[f"{r.name}/positions"], pos)
        if "--values" in args:
            np.testing.assert_array_equal(got[f"{r.name}/values"],
                                          jvalues.kmer_values_u64(r.codes, pos, 15))
