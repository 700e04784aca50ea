"""The golden vectors of tests/test_golden.py (the reference crate's
doc-tests, the crate's src/lib.rs:92-140, and BASELINE.md) through the
port: its builders on the CPU (the kernels' plain versions), its oracle
(`run_scalar`), and its k-mer values. Integer outputs: tolerance 0.
"""

from __future__ import annotations

import pytest

import simd_minimizers_tpu_torch as smt

S_FWD = b"ACGTGCTCAGAGACTCAG"
S_CANON = b"ACGTGCTCAGAGACTCAGAGGA"


@pytest.mark.parametrize("make", [smt.AsciiSeq, smt.PackedSeqVec.from_ascii])
def test_golden_fwd_positions(make):
    seq = make(S_FWD)
    assert smt.minimizer_positions(seq, 5, 7, device="cpu").tolist() == [4, 5, 8, 13]
    assert smt.minimizers(5, 7).run_scalar_once(seq).tolist() == [4, 5, 8, 13]


def test_golden_canonical_positions():
    ps = smt.PackedSeqVec.from_ascii(S_CANON)
    assert smt.canonical_minimizer_positions(ps, 5, 7, device="cpu").tolist() == [0, 7, 9, 15]
    assert smt.canonical_minimizers(5, 7).run_scalar_once(ps).tolist() == [0, 7, 9, 15]


def test_golden_canonical_values_u64():
    ps = smt.PackedSeqVec.from_ascii(S_CANON)
    want = [0b10_11_01_00_01, 0b11_00_11_00_01, 0b01_00_11_00_11, 0b11_00_11_00_01]
    out = smt.canonical_minimizers(5, 7).run(ps, device="cpu")
    assert [min(ps.read_kmer(5, int(p)), ps.read_revcomp_kmer(5, int(p)))
            for p in out.positions] == want
    assert out.values_u64().tolist() == want
    assert smt.canonical_minimizers(5, 7).run_scalar(ps).values_u64().tolist() == want


def test_golden_canonical_rc_positions_and_values():
    ps = smt.PackedSeqVec.from_ascii(S_CANON)
    rc = ps.to_revcomp()
    b = smt.canonical_minimizers(5, 7)
    rc_out, fwd_out = b.run(rc, device="cpu"), b.run(ps, device="cpu")
    assert rc_out.positions.tolist() == [2, 8, 10, 17]
    n, k = len(S_CANON), 5
    for f, r in zip(fwd_out.positions.tolist(), rc_out.positions.tolist()[::-1]):
        assert f + r == n - k
    assert fwd_out.values_u64().tolist() == rc_out.values_u64().tolist()[::-1]
