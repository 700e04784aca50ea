"""The port's slice as a whole: `Builder.run(device="cpu")` == the JAX
package's `Builder.run` == its NumPy oracle (`run_scalar`).

Integer outputs: tolerance 0. The kernel path of the same builder is
checked on a card by tests/test_torch_cuda.py and chip_smoke.py.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

import simd_minimizers_tpu as sm
import simd_minimizers_tpu_torch as smt
from simd_minimizers_tpu.hashers import AntiLexHasher, MulHasher, NtHasher
from simd_minimizers_tpu.seq.packed import AsciiSeq, GenericSeq, PackedNSeqVec, PackedSeqVec

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLD = b"ACGTGCTCAGAGACTCAGAGGA"


def test_golden_vectors():
    ps = PackedSeqVec.from_ascii(GOLD)
    assert list(smt.canonical_minimizer_positions(ps, 5, 7, device="cpu")) == [0, 7, 9, 15]
    assert list(smt.minimizer_positions(AsciiSeq(b"ACGTGCTCAGAGACTCAG"), 5, 7,
                                        device="cpu")) == [4, 5, 8, 13]
    assert list(smt.canonical_minimizer_positions(ps.to_revcomp(), 5, 7,
                                                  device="cpu")) == [2, 8, 10, 17]
    out = smt.canonical_minimizers(5, 7).run(ps, device="cpu")
    assert out.values_u64()[0] == 721
    ref = sm.canonical_minimizers(5, 7).run(ps)
    np.testing.assert_array_equal(out.positions, ref.positions)
    np.testing.assert_array_equal(out.values_u64(), ref.values_u64())
    np.testing.assert_array_equal(out.values_u128_limbs()[0], ref.values_u128_limbs()[0])


@pytest.mark.parametrize("n", [40, 4097, 30_000])
@pytest.mark.parametrize("canonical", [False, True])
def test_run_vs_jax_and_scalar(n, canonical):
    seq = PackedSeqVec.random(n, np.random.default_rng(n))
    k, w = 21, 11
    got = smt.Builder(k, w, canonical).run(seq, device="cpu")
    assert isinstance(got, smt.Output) and got.positions.dtype == np.uint32
    assert got.length == k and got.canonical == canonical
    ref = sm.Builder(k, w, canonical)
    np.testing.assert_array_equal(got.positions, ref.run(seq).positions)
    np.testing.assert_array_equal(got.positions, ref.run_scalar(seq).positions)


@pytest.mark.parametrize("start,end", [(3, 20_003), (1, 999), (2, 33), (4, 12_000)])
def test_packed_slice_offsets(start, end):
    """A PackedSeq view that starts inside a byte is repacked; an aligned
    one is used as it is. Both agree with the reference."""
    base = PackedSeqVec.random(20_010, np.random.default_rng(start))
    seq = base.slice(start, end)
    for b in (smt.canonical_minimizers(5, 7), smt.minimizers(21, 11)):
        got = b.run_once(seq, device="cpu")
        ref = sm.Builder(b.k, b.w, b.canonical)
        np.testing.assert_array_equal(got, ref.run_once(seq))
        np.testing.assert_array_equal(got, ref.run_scalar_once(seq))


def test_ascii_and_bytes_input():
    rng = np.random.default_rng(9)
    raw = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 5000)].tobytes()
    for seq in (AsciiSeq(raw), raw, raw.decode()):
        got = smt.canonical_minimizers(21, 11).run_once(seq, device="cpu")
        np.testing.assert_array_equal(got, sm.canonical_minimizers(21, 11).run_once(seq))


def test_seeded_hasher_through_builder():
    seq = PackedSeqVec.random(8000, np.random.default_rng(4))
    h = NtHasher(21, canonical=True, seed=42)
    got = smt.canonical_minimizers(21, 11).hasher(h).run_once(seq, device="cpu")
    ref = sm.canonical_minimizers(21, 11).hasher(h)
    np.testing.assert_array_equal(got, ref.run_once(seq))
    np.testing.assert_array_equal(got, ref.run_scalar_once(seq))


def _raises(fn, exc=NotImplementedError, match="ROADMAP"):
    with pytest.raises(exc, match=match):
        fn()


def test_out_of_slice_modes_raise():
    """Text, the mul and antilex hashers, batches and w beyond the kernel's
    geometry are not ported and raise; super-k-mers, syncmers and
    skip-ambiguous windows, refused until they were ported, now run on the
    CPU and agree with the oracle."""
    ps = PackedSeqVec.from_ascii(GOLD * 4)
    b = smt.canonical_minimizers(5, 7).super_kmers()
    out, want = b.run(ps, device="cpu"), b.run_scalar(ps)
    np.testing.assert_array_equal(out.positions, want.positions)
    np.testing.assert_array_equal(out.superkmer_indices, want.superkmer_indices)
    for syncmer in (1, 2):
        b = smt.Builder(5, 7, False, syncmer=syncmer)
        np.testing.assert_array_equal(b.run_once(ps, device="cpu"), b.run_scalar_once(ps))
    nseq = PackedNSeqVec.from_ascii(GOLD.replace(b"T", b"N", 1))
    b = smt.canonical_minimizers(5, 7)
    np.testing.assert_array_equal(b.run_skip_ambiguous_windows_once(nseq, device="cpu"),
                                  b.run_scalar(nseq.seq, ambiguous=nseq.ambiguous).positions)
    _raises(lambda: smt.minimizers(5, 7).run(b"any text at all!", device="cpu"))
    _raises(lambda: smt.minimizers(5, 7).run(GenericSeq(GOLD), device="cpu"))
    for h in (MulHasher(5), AntiLexHasher(5)):
        _raises(lambda: smt.minimizers(5, 7).hasher(h).run(ps, device="cpu"))
    _raises(lambda: smt.minimizers(5, 7).run_batch([GOLD, GOLD]))
    _raises(lambda: smt.minimizers(5, 100_000).run(ps, device="cpu"))


def test_even_l_canonical_raises():
    # the JAX builder's exception, raised by the same check
    ps = PackedSeqVec.from_ascii(GOLD)
    _raises(lambda: smt.canonical_minimizers(5, 6).run(ps, device="cpu"), AssertionError, "odd")
    _raises(lambda: sm.canonical_minimizers(5, 6).run(ps), AssertionError, "odd")


@pytest.mark.parametrize("k,w,n", [(5, 7, 200), (21, 11, 9000)])
def test_run_skip_ambiguous_windows_on_cpu(k, w, n):
    """The port's own entry point takes a device (the inherited one ran on
    the default CUDA device) and equals the JAX builder's."""
    rng = np.random.default_rng(n)
    raw = np.frombuffer(b"ACGTN", np.uint8)[rng.choice(5, n, p=[.24, .24, .24, .24, .04])]
    nseq = PackedNSeqVec.from_ascii(raw.tobytes())
    b, ref = smt.canonical_minimizers(k, w), sm.canonical_minimizers(k, w)
    out = b.run_skip_ambiguous_windows(nseq, device="cpu")
    want = ref.run_skip_ambiguous_windows(nseq)
    assert isinstance(out, smt.Output) and out.seq is nseq.seq
    np.testing.assert_array_equal(out.positions, want.positions)
    np.testing.assert_array_equal(out.values_u64(), want.values_u64())
    np.testing.assert_array_equal(b.run_skip_ambiguous_windows_once(nseq, device="cpu"),
                                  ref.run_skip_ambiguous_windows_once(nseq))
    with pytest.raises(AssertionError, match="canonical"):
        smt.minimizers(k, w).run_skip_ambiguous_windows(nseq, device="cpu")


def test_superkmers_with_ambiguity_raise():
    """Super-k-mers with an ambiguity mask: the reference cannot express it,
    and both packages refuse exactly this combination with AssertionError."""
    ps = PackedSeqVec.from_ascii(GOLD * 4)
    amb = np.zeros(len(ps), bool)
    amb[5] = True
    for pkg in (smt, sm):
        run = pkg.canonical_minimizers(5, 7).super_kmers().run
        kw = {"device": "cpu"} if pkg is smt else {}
        with pytest.raises(AssertionError, match="cannot be combined with an ambiguity mask"):
            run(ps, ambiguous=amb, **kw)
    from simd_minimizers_tpu_torch import convert
    from simd_minimizers_tpu_torch.ops import backend, pipeline

    words = convert.packed_words(ps, "cpu")
    plane = convert.ambiguity_plane(amb, len(ps), "cpu")
    h = NtHasher(5, canonical=True)
    with pytest.raises(AssertionError, match="cannot be combined with an ambiguity mask"):
        backend.sketch(words, len(ps), 5, 7, h, pipeline.MODE_SUPERKMERS, plane)
    # the same mask with every other mode, and super-k-mers without it, run
    for mode in (pipeline.MODE_MINIMIZERS, pipeline.MODE_CLOSED_SYNCMERS,
                 pipeline.MODE_OPEN_SYNCMERS):
        backend.sketch(words, len(ps), 5, 7, h, mode, plane)
    backend.sketch(words, len(ps), 5, 7, h, pipeline.MODE_SUPERKMERS)


def test_run_scalar_is_the_oracle():
    ps = PackedSeqVec.from_ascii(GOLD)
    assert list(smt.canonical_minimizers(5, 7).run_scalar_once(ps)) == [0, 7, 9, 15]


def test_imports_without_jax():
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import simd_minimizers_tpu_torch as smt\n"
        "from simd_minimizers_tpu_torch.ops import backend, fused, pipeline, _build\n"
        "from simd_minimizers_tpu_torch.utils import device, profiling\n"
        "ps = smt.PackedSeqVec.from_ascii(b'ACGTGCTCAGAGACTCAGAGGA')\n"
        "assert list(smt.canonical_minimizer_positions(ps, 5, 7, device='cpu')) == [0, 7, 9, 15]\n"
        "out = smt.canonical_minimizers(5, 7).super_kmers().run(ps, device='cpu')\n"
        "assert list(out.positions) == [0, 7, 9, 15] and out.superkmer_indices.size == 4\n"
        "nseq = smt.PackedNSeqVec.from_ascii(b'ACGTGCTCAGAGANTCAGAGGA')\n"
        "b = smt.canonical_minimizers(5, 7)\n"
        "assert list(b.run_skip_ambiguous_windows_once(nseq, device='cpu')) == list(\n"
        "    b.run_scalar(nseq.seq, ambiguous=nseq.ambiguous).positions)\n"
        "assert sys.modules['jax'] is None\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
