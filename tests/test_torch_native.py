"""The port's native host helpers (`simd_minimizers_tpu_torch/native`):
`pack_ascii`, `pack_2bit` and `fasta_scan` bit-equal to the JAX package's
`native` functions and to the port's NumPy forms (`seq/packed.pack_2bit_plain`,
`seq/fasta.fasta_scan_plain`), on the edge cases of tests/test_native_fasta.py
(CRLF, blank lines, headerless, empty record, lowercase / IUPAC, `.gz`) and
n = 0..3 mod 4; `read_fasta` equal to the JAX package's; a failed build
raises. Integer outputs: tolerance 0.
"""

from __future__ import annotations

import gzip
import json

import numpy as np
import pytest

from simd_minimizers_tpu import native as jnative
from simd_minimizers_tpu.seq import fasta as jfasta
from simd_minimizers_tpu.seq.packed import PackedNSeqVec as JPackedNSeqVec
import simd_minimizers_tpu_torch as smt
from simd_minimizers_tpu_torch import native
from simd_minimizers_tpu_torch.seq import fasta, packed

RNG = np.random.default_rng(0x9A7)

FASTA_CASES = {
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
    "a '>' inside a sequence line": b">a\nAC>GT\n>b\n>\nTT\n",
    "final CR without a newline": b">a\nACGT\r",
    "only newlines": b"\n\n\n",
    "empty records in a row": b">a\n>b\n>c\nA\n>d\n",
}


def _random_fasta(rng, nrec, width=60, crlf=False):
    acgtn = np.frombuffer(b"ACGTNRYacgtn", np.uint8)
    out = []
    for i in range(nrec):
        n = int(rng.integers(0, 3000))
        seq = acgtn[rng.integers(0, acgtn.size, n)]
        lines = [seq[j:j + width].tobytes() for j in range(0, n, width)]
        out.append(b">rec%d desc\n" % i + b"\n".join(lines) + b"\n")
    raw = b"".join(out)
    return raw.replace(b"\n", b"\r\n") if crlf else raw


@pytest.mark.parametrize("n", [0, 1, 2, 3, 4, 5, 6, 7, 8, 1000, 1001, 1002, 1003])
def test_pack_ascii(n):
    """(codes, ambiguous) of every byte value == the JAX package's and the
    tables of seq/packed.py."""
    raw = RNG.integers(0, 256, n, dtype=np.uint8)
    raw[: min(n, 8)] = np.frombuffer(b"ACGTacgt", np.uint8)[: min(n, 8)]
    codes, amb = native.pack_ascii(raw)
    jcodes, jamb = jnative.pack_ascii(raw)
    assert codes.dtype == amb.dtype == np.uint8
    np.testing.assert_array_equal(codes, jcodes)
    np.testing.assert_array_equal(amb, jamb)
    np.testing.assert_array_equal(codes, packed._ASCII_TO_CODE[raw])
    np.testing.assert_array_equal(amb.astype(bool), ~packed._IS_ACGT[raw])


@pytest.mark.parametrize("n", [0, 1, 2, 3, 4, 5, 6, 7, 8, 4093, 4094, 4095, 4096, 100_003])
def test_pack_2bit(n):
    """n = 0..3 mod 4: equal to the JAX package's packer and the NumPy form."""
    codes = RNG.integers(0, 4, n, dtype=np.uint8)
    got = native.pack_2bit(codes)
    assert got.dtype == np.uint8 and got.size == (n + 3) // 4
    np.testing.assert_array_equal(got, jnative.pack_2bit(codes))
    np.testing.assert_array_equal(got, packed.pack_2bit_plain(codes))
    np.testing.assert_array_equal(packed.pack_2bit(codes), got)
    np.testing.assert_array_equal(smt.PackedSeqVec.from_codes(codes).codes(), codes)


def test_wide_and_strided_inputs_are_cast_by_value():
    """A wider dtype or a strided view is read by value, not as raw bytes."""
    codes = RNG.integers(0, 4, 2001, dtype=np.uint8)
    for arr in (codes.astype(np.int64), np.repeat(codes, 2)[::2], codes.astype(np.uint16)):
        np.testing.assert_array_equal(native.pack_2bit(arr), native.pack_2bit(codes))
    raw = np.frombuffer(b"ACGTNacgtn", np.uint8)
    for arr in (raw.astype(np.int32), np.repeat(raw, 3)[::3]):
        for g, p in zip(native.pack_ascii(arr), native.pack_ascii(raw)):
            np.testing.assert_array_equal(g, p)
    buf = np.frombuffer(FASTA_CASES["two records, CRLF, lowercase, IUPAC"], np.uint8)
    for g, p in zip(native.fasta_scan(buf.astype(np.int64)), native.fasta_scan(buf)):
        np.testing.assert_array_equal(g, p)


def _assert_scans_equal(raw: bytes):
    buf = np.frombuffer(raw, np.uint8)
    got = native.fasta_scan(buf)
    assert [a.dtype for a in got] == [np.uint8, np.uint8, np.int64]
    for want in (jnative.fasta_scan(buf), fasta.fasta_scan_plain(buf), fasta.fasta_scan(buf)):
        for g, p in zip(got, want, strict=True):
            np.testing.assert_array_equal(g, p)


@pytest.mark.parametrize("case", sorted(FASTA_CASES))
def test_fasta_scan_cases(case, tmp_path):
    """Each edge case: the native scan == the JAX package's native scan and
    the port's NumPy scan; read_fasta (plain and .gz) == the JAX package's."""
    raw = FASTA_CASES[case]
    _assert_scans_equal(raw)
    for name, data in (("e.fa", raw), ("e.fa.gz", gzip.compress(raw))):
        p = tmp_path / name
        p.write_bytes(data)
        got, want = fasta.read_fasta(str(p)), jfasta.read_fasta(str(p))
        assert [(r.name, len(r)) for r in got] == [(r.name, len(r)) for r in want]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.codes, w.codes)
            np.testing.assert_array_equal(g.ambiguous, w.ambiguous)


@pytest.mark.parametrize("crlf", [False, True])
def test_fasta_scan_random(crlf, tmp_path):
    """Random records with IUPAC and lowercase, LF and CRLF: the scans agree
    and read_fasta equals the JAX package's on the same file."""
    raw = _random_fasta(np.random.default_rng(int(crlf)), 40, crlf=crlf)
    _assert_scans_equal(raw)
    p = tmp_path / "r.fa"
    p.write_bytes(raw)
    got, want = fasta.read_fasta(str(p)), jfasta.read_fasta(str(p))
    assert [r.name for r in got] == [r.name for r in want] and len(got) == 40
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.codes, w.codes)
        np.testing.assert_array_equal(g.ambiguous, w.ambiguous)


def test_fasta_record_table_sized_by_headers():
    """The record table follows the header count, not a fixed size: 3 * 10^5
    one-base records (the NumPy scan agrees)."""
    raw = b">r\nA\n" * 300_000
    codes, amb, starts = native.fasta_scan(np.frombuffer(raw, np.uint8))
    assert starts.size == 300_001 and codes.size == 300_000
    np.testing.assert_array_equal(starts, np.arange(300_001))
    np.testing.assert_array_equal(starts, fasta.fasta_scan_plain(np.frombuffer(raw, np.uint8))[2])


def test_packed_nseq_from_ascii():
    """PackedNSeqVec.from_ascii (one native pack_ascii) == the JAX package's."""
    raw = np.frombuffer(b"ACGTNacgtnRYKM*-", np.uint8)[RNG.integers(0, 16, 1003)]
    got, want = smt.PackedNSeqVec.from_ascii(raw.tobytes()), JPackedNSeqVec.from_ascii(raw)
    assert got.ambiguous.dtype == np.bool_ and len(got) == len(want) == 1003
    np.testing.assert_array_equal(got.ambiguous, want.ambiguous)
    np.testing.assert_array_equal(got.seq.codes(), want.seq.codes())
    np.testing.assert_array_equal(got.seq.data, want.seq.data)


def test_missing_compiler_raises(tmp_path, monkeypatch):
    """Without g++ the helpers raise; there is no NumPy fallback."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native.shutil, "which", lambda _: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.pack_2bit(np.zeros(8, np.uint8))
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        fasta.fasta_scan(np.frombuffer(b">a\nAC\n", np.uint8))


def test_failed_build_raises(tmp_path, monkeypatch):
    """A source that does not compile raises with the compiler's message."""
    bad = tmp_path / "packseq.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "SOURCE", bad)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.pack_ascii(np.zeros(4, np.uint8))
    assert not list((tmp_path / "build").glob("*.so"))


def test_fasta_ingest_tool_reads_back_what_it_wrote(tmp_path, capsys):
    """`tools/fasta_ingest` (the NumPy-against-native ingestion measurement):
    both routes give back every record as written, and the JAX package's
    read_fasta reads the file it writes the same."""
    from simd_minimizers_tpu_torch.tools import fasta_ingest

    assert fasta_ingest.main(["--records", "contig0,contig3", "--routes", "numpy,native",
                              "--dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    summary = json.loads(out[-1])
    assert summary["ok"] and summary["records"] == 2 and summary["bp"] > 20_000
    assert [r["route"] for r in summary["runs"]] == ["numpy", "native"]
    assert all(r["bp"] == summary["bp"] and r["records"] == 2 for r in summary["runs"])
    assert summary["runs"][0]["sha256"] == summary["runs"][1]["sha256"]
    assert not list(tmp_path.iterdir())  # the file is removed
    path = tmp_path / "g.fa"
    recs = fasta_ingest.genome_records(0)[-3:]
    bp, digest = fasta_ingest.write_fasta(path, recs, 0)
    got, want = fasta.read_fasta(str(path)), jfasta.read_fasta(str(path))
    assert [r.name for r in got] == [r.name for r in want] == [n for n, _ in recs]
    assert sum(len(r) for r in got) == bp
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.codes, w.codes)
        np.testing.assert_array_equal(g.ambiguous, w.ambiguous)
