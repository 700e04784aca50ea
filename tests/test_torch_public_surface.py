"""The port's public surface, the counterpart of tests/test_public_surface.py:
every name of `simd_minimizers_tpu_torch.__all__` exists, the JAX package's
exports all have a counterpart, and every sequence method and
`one_minimizer` agrees with the JAX package's on seeded numpy inputs
(2-bit DNA and text, k from 1 to 64, k-mers at both ends of the sequence).
Everything here runs on the host: no card is needed.
"""

import numpy as np
import pytest

import simd_minimizers_tpu as sm
import simd_minimizers_tpu_torch as smt
from simd_minimizers_tpu.seq import packed as jpacked
from simd_minimizers_tpu_torch import convert
from simd_minimizers_tpu_torch.seq import packed

KS = [1, 5, 31, 32, 33, 64]
N = 200  # chars of each seeded sequence


def test_all_exports_exist():
    for name in smt.__all__:
        assert hasattr(smt, name), name
    assert len(set(smt.__all__)) == len(smt.__all__)


@pytest.mark.parametrize("name", [n for n in sm.__all__])
def test_every_jax_export_has_a_counterpart(name):
    assert name in smt.__all__ and hasattr(smt, name), name


def test_builder_and_output_surface():
    for ctor in (smt.minimizers, smt.canonical_minimizers, smt.closed_syncmers,
                 smt.canonical_closed_syncmers, smt.open_syncmers,
                 smt.canonical_open_syncmers):
        b = ctor(5, 7)
        for meth in ("hasher", "run", "run_once", "run_scalar",
                     "run_scalar_once", "run_skip_ambiguous_windows",
                     "run_skip_ambiguous_windows_once", "run_batch"):
            assert callable(getattr(b, meth)), (ctor.__name__, meth)
    assert callable(smt.minimizers(5, 7).super_kmers)
    out = smt.canonical_minimizers(5, 7).super_kmers().run(
        smt.PackedSeqVec.from_ascii(b"ACGTGCTCAGAGACTCAGAGGA"), device="cpu")
    for meth in ("values_u64", "values_u128", "values_u128_limbs",
                 "pos_and_values_u64", "pos_and_values_u128"):
        assert callable(getattr(out, meth)), meth
    assert out.positions is not None and out.superkmer_indices is not None


def test_seq_type_surface():
    ps = smt.PackedSeqVec.from_ascii(b"ACGTACGTACGT")
    for meth in ("codes", "slice", "read_kmer", "read_revcomp_kmer",
                 "to_revcomp", "to_ascii", "as_slice"):
        assert callable(getattr(ps, meth)), meth
    a = smt.AsciiSeqVec(b"ACGT")
    for meth in ("codes", "slice", "read_kmer", "read_revcomp_kmer", "to_revcomp",
                 "as_slice", "random"):
        assert callable(getattr(a, meth)), meth
    g = smt.GenericSeq(b"hello")
    for meth in ("codes", "slice", "read_kmer", "read_revcomp_kmer", "as_slice"):
        assert callable(getattr(g, meth)), meth
    assert smt.AsciiSeqVec is smt.AsciiSeq
    assert isinstance(smt.as_seq(b"hello world!"), smt.GenericSeq)
    assert isinstance(smt.as_seq(b"ACGT"), smt.AsciiSeq)  # the JAX package's rule
    assert isinstance(smt.as_seq("acgt"), smt.AsciiSeq)
    n = smt.PackedNSeqVec.from_ascii(b"ACGNNNTACGT")
    assert n.ambiguous.sum() == 3 and n.as_slice() is n
    with pytest.raises(TypeError):
        smt.as_seq(3.5)


def test_hashers_seedable():
    for cls in (smt.NtHasher, smt.MulHasher, smt.AntiLexHasher):
        h = cls(5, canonical=True, seed=1)
        v = h.hash_kmers_np(np.zeros(10, np.uint8))
        assert v.dtype == np.uint32 and v.size == 6


def _pair(kind: str, seed: int):
    """(port sequence, JAX sequence) of the same seeded N chars: packed DNA,
    an unaligned slice of it, ASCII DNA, or printable text."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, N + 3, dtype=np.uint8)
    if kind == "packed":
        return smt.PackedSeqVec.from_codes(codes[:N]), jpacked.PackedSeqVec.from_codes(codes[:N])
    if kind == "packed slice":
        return (smt.PackedSeqVec.from_codes(codes).slice(3, N + 3),
                jpacked.PackedSeqVec.from_codes(codes).slice(3, N + 3))
    if kind == "ascii":
        raw = np.frombuffer(b"ACGTacgt", np.uint8)[rng.integers(0, 8, N)]
        return smt.AsciiSeq(raw), jpacked.AsciiSeq(raw)
    raw = rng.integers(32, 127, N, dtype=np.uint8)
    return smt.GenericSeq(raw), jpacked.GenericSeq(raw)


KINDS = ["packed", "packed slice", "ascii", "text"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("k", KS)
def test_read_kmer_vs_jax(kind, k):
    """read_kmer and read_revcomp_kmer at the first, a middle and the last
    position of the sequence: the same Python ints as the JAX package's."""
    ours, theirs = _pair(kind, k)
    for pos in (0, 1, N // 2, N - k - 1, N - k):
        assert ours.read_kmer(k, pos) == theirs.read_kmer(k, pos), pos
        assert ours.read_revcomp_kmer(k, pos) == theirs.read_revcomp_kmer(k, pos), pos
    bits = 8 if kind == "text" else 2
    assert ours.read_kmer(k, N - k) < 1 << (bits * k)


@pytest.mark.parametrize("kind", ["packed", "packed slice", "ascii"])
def test_to_revcomp_and_ascii_vs_jax(kind):
    """to_revcomp once equals the JAX package's and twice gives the codes
    back; PackedSeq.to_ascii equals the JAX package's."""
    ours, theirs = _pair(kind, 7)
    rc, jrc = ours.to_revcomp(), theirs.to_revcomp()
    assert type(rc).__name__ == type(jrc).__name__
    np.testing.assert_array_equal(rc.codes(), jrc.codes())
    np.testing.assert_array_equal(rc.to_revcomp().codes(), ours.codes())
    if kind != "ascii":
        assert ours.to_ascii() == theirs.to_ascii()
        assert rc.to_revcomp().to_ascii() == ours.to_ascii()
    else:
        np.testing.assert_array_equal(rc.seq, jrc.seq)
    for k in (5, 33):
        assert rc.read_kmer(k, 0) == ours.read_revcomp_kmer(k, N - k)


@pytest.mark.parametrize("kind", KINDS)
def test_as_slice_is_itself(kind):
    ours, _ = _pair(kind, 3)
    assert ours.as_slice() is ours


def test_ascii_random_vs_jax():
    """AsciiSeq.random with one seed: the same bytes as the JAX package's."""
    a = smt.AsciiSeq.random(1000, np.random.default_rng(5))
    b = jpacked.AsciiSeq.random(1000, np.random.default_rng(5))
    np.testing.assert_array_equal(a.seq, b.seq)
    assert set(a.seq.tolist()) <= set(b"ACGT")


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("w", [1, 7, 11])
@pytest.mark.parametrize("cls", ["NtHasher", "MulHasher", "AntiLexHasher"])
@pytest.mark.parametrize("text", [False, True])
def test_one_minimizer_vs_jax(k, w, cls, text):
    """One window of k + w - 1 chars, from the start and from the end of a
    seeded sequence, given as bytes: the same position as the JAX
    package's one_minimizer with its own hasher."""
    rng = np.random.default_rng(k * 31 + w)
    raw = (rng.integers(32, 127, N, dtype=np.uint8) if text
           else np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, N)])
    l = k + w - 1
    jh = getattr(sm, cls)(k, canonical=False)
    h = convert.hasher_from(jh)
    for window in (raw[:l].tobytes(), raw[-l:].tobytes()):
        assert smt.one_minimizer(window, h) == sm.one_minimizer(window, jh)
        assert 0 <= smt.one_minimizer(window, h) < w


def test_as_seq_matches_jax_rule():
    for raw in (b"ACGT", b"acgtACGT", b"ACGN", b"hello world", "ACGT", np.frombuffer(b"TTA", np.uint8)):
        assert type(smt.as_seq(raw)).__name__ == type(jpacked.as_seq(raw)).__name__
    seq = smt.PackedSeqVec.from_ascii(b"ACGT")
    assert smt.as_seq(seq) is seq and packed.as_seq(seq) is seq
