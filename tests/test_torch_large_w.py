"""Large w through the port on the CPU: `backend.sketch(..., device cpu)`
== the JAX package's `backend.sketch` (its XLA pipeline on the CPU) == the
NumPy oracle, at w from 1,200 to 43,001 (the old shared-memory gate stopped
at 21,721 canonical and 42,376 forward), both strands, 2-bit DNA and text,
the nt, mul and antilex hashers, every mode, with a mask.

On a CPU tensor the wrapper runs the kernel's plain version; the large-w
route of the kernel itself runs only on a card (tests/test_torch_cuda.py,
chip_smoke.py). Integer outputs: tolerance 0. Each case has two tiles and
a few windows more (n = 2 * TILE + 17 + l - 1), so the oracle's O(n w)
windows stay cheap.
"""

import numpy as np
import pytest
import torch

import simd_minimizers_tpu_torch as smt
from simd_minimizers_tpu.hashers import AntiLexHasher, MulHasher, NtHasher
from simd_minimizers_tpu.ops import backend as jbackend
from simd_minimizers_tpu.ops import oracle
from simd_minimizers_tpu_torch import convert
from simd_minimizers_tpu_torch.ops import backend, fused, pipeline

MIN, SKM = pipeline.MODE_MINIMIZERS, pipeline.MODE_SUPERKMERS
CLOSED, OPEN = pipeline.MODE_CLOSED_SYNCMERS, pipeline.MODE_OPEN_SYNCMERS

# (k, w, canonical, text, hasher class); canonical needs an odd l = k + w - 1
CASES = [
    (21, 1200, False, False, NtHasher), (22, 1200, True, False, NtHasher),
    (21, 1200, False, True, MulHasher),
    (21, 21_723, False, False, NtHasher), (21, 21_723, True, False, NtHasher),
    (21, 21_723, True, False, AntiLexHasher),
    (21, 32_767, False, False, NtHasher), (21, 32_767, True, False, NtHasher),
    (21, 32_767, False, True, MulHasher), (21, 32_767, True, True, MulHasher),
    (21, 43_001, False, False, NtHasher), (21, 43_001, True, False, MulHasher),
]


def _inputs(k, w, text, seed):
    """(codes, mask): two tiles of windows and some more; the mask flags
    a few isolated chars and a run across the second tile's start."""
    l = k + w - 1
    n = 2 * fused.TILE + 17 + l - 1
    rng = np.random.default_rng(seed)
    codes = rng.integers(32 if text else 0, 127 if text else 4, n, dtype=np.uint8)
    mask = (rng.random(n) < 3e-5).astype(np.uint8)
    mask[fused.TILE + l - 40:fused.TILE + l - 30] = 1
    return codes, mask


def _port(codes, k, w, jh, mode, mask, text):
    chars = (convert.text_bytes(smt.GenericSeq(codes), "cpu") if text
             else convert.packed_words(smt.PackedSeqVec.from_codes(codes), "cpu"))
    plane = None if mask is None else convert.ambiguity_plane(mask, codes.size, "cpu")
    got = backend.sketch(chars, codes.size, k, w, convert.hasher_from(jh), mode, plane, text)
    return tuple(g.numpy().view(np.uint32) for g in (got if mode == SKM else (got,)))


def _oracle(codes, k, w, jh, mode, mask):
    sel = oracle.selected_stream(codes, k, w, jh, ambiguous=mask)
    if mode == SKM:
        return oracle.collect_and_dedup_with_index(sel)
    if mode in (CLOSED, OPEN):
        return (oracle.collect_syncmers(sel, w, mode == OPEN),)
    return (oracle.collect_and_dedup(sel, skip_sentinel=mask is not None),)


@pytest.mark.parametrize("k,w,canonical,text,cls", CASES)
def test_large_w_vs_jax_and_oracle(k, w, canonical, text, cls):
    """Every mode against the oracle; minimizers with a mask against the JAX
    package's backend.sketch too. The CPU path launches no kernel."""
    jh = cls(k, canonical=canonical)
    codes, mask = _inputs(k, w, text, w + k)
    assert fused.fused_supported(k, w, canonical, MIN, True, text, jh.kind)
    before = dict(fused.LAUNCHES)
    modes = [(MIN, None), (SKM, None), (CLOSED, None), (MIN, mask)]
    if w % 2:
        modes.append((OPEN, mask))
    for mode, m in modes:
        got = _port(codes, k, w, jh, mode, m, text)
        for g, want in zip(got, _oracle(codes, k, w, jh, mode, m), strict=True):
            np.testing.assert_array_equal(g, want, err_msg=f"{mode}, mask {m is not None}")
    assert fused.LAUNCHES == before
    got = _port(codes, k, w, jh, MIN, mask, text)[0]
    np.testing.assert_array_equal(got, jbackend.sketch(codes, k, w, jh, mode=MIN,
                                                       ambiguous_np=mask, dna=not text))


@pytest.mark.parametrize("mode", [MIN, SKM, CLOSED, OPEN])
def test_every_mode_vs_jax_at_w_32767(mode):
    """Canonical nt DNA at the reference's largest w (w < 2^15), every
    mode, against the JAX package's backend.sketch; super-k-mers with a
    mask below the entry points too, as the JAX package runs them there."""
    k, w = 21, 32_767
    jh = NtHasher(k, canonical=True)
    codes, mask = _inputs(k, w, False, 7)
    for m in (None, mask):
        got = _port(codes, k, w, jh, mode, m, False)
        want = jbackend.sketch(codes, k, w, jh, mode=mode, ambiguous_np=m)
        for g, p in zip(got, want if mode == SKM else (want,), strict=True):
            np.testing.assert_array_equal(g, p)


@pytest.mark.parametrize("canonical", [False, True])
def test_builder_run_at_large_w(canonical):
    """The public builders at w = 32,767 on the CPU: Builder.run (a mask
    too), run_skip_ambiguous_windows and run_batch, against the JAX
    builders and the oracle."""
    import simd_minimizers_tpu as sm
    from simd_minimizers_tpu.seq.packed import PackedNSeqVec, PackedSeqVec

    k, w = 21, 32_767
    codes, mask = _inputs(k, w, False, 11)
    jseq = PackedSeqVec.from_codes(codes)
    seq = convert.seq_from(jseq)
    b, jb = smt.Builder(k, w, canonical), sm.Builder(k, w, canonical)
    np.testing.assert_array_equal(b.run(seq, device="cpu").positions, jb.run(jseq).positions)
    np.testing.assert_array_equal(b.run(seq, ambiguous=mask, device="cpu").positions,
                                  jb.run_scalar(jseq, ambiguous=mask).positions)
    if canonical:
        nseq = PackedNSeqVec(jseq, mask.astype(bool))
        np.testing.assert_array_equal(
            b.run_skip_ambiguous_windows_once(convert.seq_from(nseq), device="cpu"),
            jb.run_skip_ambiguous_windows_once(nseq))
    reads = [np.frombuffer(b"ACTG", np.uint8)[codes[:n]].tobytes()
             for n in (k + w - 1, 40_000, 30)]
    for g, p in zip(b.run_batch(reads, device="cpu"), jb.run_batch(reads), strict=True):
        np.testing.assert_array_equal(g, p)


def test_past_the_column_key_raises():
    """TILE + w > 2^16 stays refused on both devices (16-bit column keys),
    naming the ROADMAP item; TILE + w = 2^16 runs."""
    k = 21
    w = (1 << 16) - fused.TILE
    codes = np.random.default_rng(3).integers(0, 4, k + w + 50, dtype=np.uint8)
    words = torch.from_numpy(smt.PackedSeqVec.from_codes(codes).data)
    h = smt.NtHasher(k)
    got = backend.sketch(words, codes.size, k, w, h)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  oracle.collect_and_dedup(oracle.selected_stream(
                                      codes, k, w, NtHasher(k))))
    with pytest.raises(NotImplementedError, match="ROADMAP A12"):
        backend.sketch(words, codes.size, k, w + 1, h)
