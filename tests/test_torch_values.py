"""k-mer values in the port against the JAX package, on the CPU.

- `device_values.kmer_values_limbs_plain` (the plain version of the
  `kmer_values` kernel) against the JAX package's `values_limbs_jnp` and its
  `device_values.kmer_values_u64` / `kmer_values_u128_limbs`, on the 2-bit
  byte stream and on code bytes;
- the port's host paths (the native extractor for 2-bit u64, NumPy for
  u128 and text) against the JAX package's `ops/values.py`;
- boundary positions (0 and n - k), m = 0, unaligned `PackedSeq` slices,
  unsorted and duplicated positions;
- `Output`'s routing: host values after a CPU run or `run_scalar`, the
  card's drivers after a CUDA run (the card replaced by the CPU here, so
  the plain version runs), and the JAX package's assertions.

Integer outputs: every comparison is exact. On the card the kernel is held
against the plain version (tests/test_torch_cuda.py, chip_smoke.py).
"""

import numpy as np
import pytest
import torch

import simd_minimizers_tpu as jsm
import simd_minimizers_tpu_torch as smt
from simd_minimizers_tpu import native as jnative
from simd_minimizers_tpu.ops import device_values as jdv
from simd_minimizers_tpu.ops import values as jvalues
from simd_minimizers_tpu.seq.packed import GenericSeq as JGenericSeq
from simd_minimizers_tpu.seq.packed import PackedSeqVec as JPackedSeqVec
from simd_minimizers_tpu_torch import api, convert, native
from simd_minimizers_tpu_torch.ops import device_values, values

KS = [1, 2, 5, 15, 16, 17, 21, 31, 32, 33, 48, 63, 64]
N = 3000


def _codes(seed: int, n: int = N) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 4, n, dtype=np.uint8)


def _positions(n: int, k: int, seed: int, m: int = 400) -> np.ndarray:
    """Sorted random u32 positions of whole k-mers, with both ends."""
    pos = np.random.default_rng(seed).integers(0, n - k + 1, m).astype(np.uint32)
    pos[:2] = (0, n - k)
    return np.sort(pos)


def _chars(codes: np.ndarray, byte_codes: bool) -> torch.Tensor:
    if byte_codes:
        return convert.code_bytes(codes, "cpu")
    return convert.packed_words(smt.PackedSeqVec.from_codes(codes), "cpu")


def _pos_tensor(pos: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(pos.view(np.int32))


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("byte_codes", [False, True])
def test_plain_limbs_vs_jax(k, canonical, byte_codes):
    """The plain version's (m, L) limbs equal values_limbs_jnp's, and the
    drivers' u64 / u128 limbs equal the JAX package's device drivers."""
    codes = _codes(k)
    pos = _positions(N, k, k + 1)
    chars = _chars(codes, byte_codes)
    words = jdv.pack_words_np(codes)
    got = device_values.kmer_values_limbs_plain(chars, _pos_tensor(pos), k, canonical,
                                                byte_codes)
    assert got.dtype == torch.int32 and got.shape == (pos.size, device_values.limb_count(k))
    want = np.asarray(jdv.values_limbs_jnp(words, pos, k, canonical))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    # the drivers route a CPU tensor to the same plain version
    np.testing.assert_array_equal(
        device_values.kmer_values_limbs(chars, _pos_tensor(pos), k, canonical, byte_codes), got)
    lo, hi = device_values.kmer_values_u128_limbs(chars, pos, k, canonical, byte_codes)
    wlo, whi = jdv.kmer_values_u128_limbs(codes, pos, k, canonical)
    np.testing.assert_array_equal(lo, wlo)
    np.testing.assert_array_equal(hi, whi)
    if k <= 32:
        got64 = device_values.kmer_values_u64(chars, pos, k, canonical, byte_codes)
        assert got64.dtype == np.uint64
        np.testing.assert_array_equal(got64, jdv.kmer_values_u64(codes, pos, k, canonical))


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("canonical", [False, True])
def test_host_values_vs_jax(k, canonical):
    """Native u64 (k <= 32) and NumPy u128 limbs and ints of 2-bit codes
    equal the JAX package's ops/values.py; the native extractor equals the
    JAX package's."""
    codes = _codes(100 + k)
    pos = _positions(N, k, k + 2)
    u128 = values.canonical_kmer_values_u128_limbs if canonical else values.kmer_values_u128_limbs
    ju128 = (jvalues.canonical_kmer_values_u128_limbs if canonical
             else jvalues.kmer_values_u128_limbs)
    for g, w in zip(u128(codes, pos, k), ju128(codes, pos, k), strict=True):
        np.testing.assert_array_equal(g, w)
    ints = values.canonical_kmer_values_u128 if canonical else values.kmer_values_u128
    jints = jvalues.canonical_kmer_values_u128 if canonical else jvalues.kmer_values_u128
    assert ints(codes, pos[:50], k) == jints(codes, pos[:50], k)
    if k <= 32:
        u64 = values.canonical_kmer_values_u64 if canonical else values.kmer_values_u64
        ju64 = jvalues.canonical_kmer_values_u64 if canonical else jvalues.kmer_values_u64
        got = u64(codes, pos, k)
        np.testing.assert_array_equal(got, ju64(codes, pos, k))
        np.testing.assert_array_equal(native.kmer_values_u64(codes, pos, k, canonical), got)
        np.testing.assert_array_equal(jnative.kmer_values_u64(codes, pos, k, canonical), got)


@pytest.mark.parametrize("k", [1, 2, 5, 8, 15, 16])
@pytest.mark.parametrize("canonical", [False, True])
def test_text_values_vs_jax(k, canonical):
    """Text (8 bits a char) stays in NumPy: u64 up to k = 8, u128 to 16."""
    text = np.random.default_rng(k).integers(32, 127, N, dtype=np.uint8)
    pos = _positions(N, k, k)
    if k <= 8:
        u64 = values.canonical_kmer_values_u64 if canonical else values.kmer_values_u64
        ju64 = jvalues.canonical_kmer_values_u64 if canonical else jvalues.kmer_values_u64
        np.testing.assert_array_equal(u64(text, pos, k, 8), ju64(text, pos, k, 8))
    u128 = values.canonical_kmer_values_u128_limbs if canonical else values.kmer_values_u128_limbs
    ju128 = (jvalues.canonical_kmer_values_u128_limbs if canonical
             else jvalues.kmer_values_u128_limbs)
    for g, w in zip(u128(text, pos, k, 8), ju128(text, pos, k, 8), strict=True):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("k", [15, 21, 33, 64])  # L = 1, 2, 3, 4
@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("byte_codes", [False, True])
def test_plain_limbs_positions_in_any_order_vs_jax(k, canonical, byte_codes):
    """The plain version on unsorted positions with duplicates (a run of
    one position, repeats far apart, both ends, past the buffer) equals
    values_limbs_jnp row by row, whatever the order."""
    rng = np.random.default_rng(7 * k + 2 * canonical + byte_codes)
    codes = _codes(k + 50)
    some = rng.integers(0, N - k + 1, 300)
    pos = np.concatenate([some, some[:60], np.repeat(some[60:63], 5), [N - k] * 3, [0, 0],
                          [N - k + 1, N - 1]]).astype(np.uint32)
    rng.shuffle(pos)
    assert (np.diff(pos.astype(np.int64)) < 0).any() and np.unique(pos).size < pos.size
    got = device_values.kmer_values_limbs_plain(_chars(codes, byte_codes), _pos_tensor(pos), k,
                                                canonical, byte_codes)
    want = np.asarray(jdv.values_limbs_jnp(jdv.pack_words_np(codes), pos, k, canonical))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    order = np.argsort(pos, kind="stable")  # the same rows as the sorted positions'
    np.testing.assert_array_equal(
        device_values.kmer_values_limbs_plain(_chars(codes, byte_codes), _pos_tensor(pos[order]),
                                              k, canonical, byte_codes).numpy().view(np.uint32),
        want[order])


@pytest.mark.parametrize("k", [5, 16, 21, 32, 33, 64])
def test_no_positions(k):
    """m = 0: empty results of the right shape and type, on every path."""
    codes = _codes(k)
    none = np.zeros(0, np.uint32)
    for byte_codes in (False, True):
        chars = _chars(codes, byte_codes)
        limbs = device_values.kmer_values_limbs(chars, _pos_tensor(none), k, True, byte_codes)
        assert limbs.shape == (0, device_values.limb_count(k)) and limbs.dtype == torch.int32
        lo, hi = device_values.kmer_values_u128_limbs(chars, none, k, True, byte_codes)
        assert lo.size == hi.size == 0 and lo.dtype == hi.dtype == np.uint64
        if k <= 32:
            v = device_values.kmer_values_u64(chars, none, k, False, byte_codes)
            assert v.size == 0 and v.dtype == np.uint64
    if k <= 32:
        for canonical in (False, True):
            assert native.kmer_values_u64(codes, none, k, canonical).dtype == np.uint64
            assert values.canonical_kmer_values_u64(codes, none, k).size == 0


@pytest.mark.parametrize("offset", [1, 2, 3, 4, 7])
@pytest.mark.parametrize("k", [5, 21, 33, 64])
def test_unaligned_slices(offset, k):
    """A PackedSeq slice at any base offset (repacked for the card's stream,
    zero-copy when byte-aligned) gives the values of its own codes, on the
    plain version and in Output after a CPU run, as in the JAX package."""
    codes = _codes(offset * 7 + k, 2000)
    end = 2000 - offset // 2
    seq = smt.PackedSeqVec.from_codes(codes).slice(offset, end)
    sub = codes[offset:end]
    pos = _positions(sub.size, k, offset)
    for canonical in (False, True):
        got = device_values.kmer_values_u128_limbs(convert.packed_words(seq, "cpu"), pos, k,
                                                   canonical)
        want = (jvalues.canonical_kmer_values_u128_limbs if canonical
                else jvalues.kmer_values_u128_limbs)(sub, pos, k)
        for g, w in zip(got, want, strict=True):
            np.testing.assert_array_equal(g, w)
    w = 11 if k % 2 else 12  # l odd for the canonical builder
    jseq = JPackedSeqVec.from_codes(codes).slice(offset, end)
    out = smt.canonical_minimizers(k, w).run(seq, device="cpu")
    jout = jsm.canonical_minimizers(k, w).run(jseq)
    np.testing.assert_array_equal(out.positions, jout.positions)
    for g, j in zip(out.values_u128_limbs(), jout.values_u128_limbs(), strict=True):
        np.testing.assert_array_equal(g, j)
    if k <= 32:
        np.testing.assert_array_equal(out.values_u64(), jout.values_u64())


def _builders(k, w):
    return [(smt.minimizers(k, w), jsm.minimizers(k, w)),
            (smt.canonical_minimizers(k, w), jsm.canonical_minimizers(k, w)),
            (smt.closed_syncmers(k, w), jsm.closed_syncmers(k, w))]


@pytest.mark.parametrize("k,w", [(5, 7), (21, 11), (31, 3), (33, 11), (48, 8)])
def test_output_after_a_cpu_run(k, w, monkeypatch):
    """After a CPU run (and run_scalar) every value comes from the host:
    u64 of DNA from the native extractor, and nothing reaches the card's
    drivers; the values equal the JAX package's Output."""
    native_calls = []
    real = native.kmer_values_u64

    def counted(*args, **kw):
        native_calls.append(args[2])
        return real(*args, **kw)

    def no_card(*args, **kw):
        raise AssertionError("a CPU run's values reached the card's driver")

    monkeypatch.setattr(native, "kmer_values_u64", counted)
    monkeypatch.setattr(device_values, "kmer_values_limbs", no_card)
    codes = _codes(k * w, 4000)
    seq, jseq = smt.PackedSeqVec.from_codes(codes), JPackedSeqVec.from_codes(codes)
    for b, jb in _builders(k, w):
        for out in (b.run(seq, device="cpu"), b.run_scalar(seq)):
            jout = jb.run(jseq)
            np.testing.assert_array_equal(out.positions, jout.positions)
            for g, j in zip(out.values_u128_limbs(), jout.values_u128_limbs(), strict=True):
                np.testing.assert_array_equal(g, j)
            assert out.values_u128()[:20] == jout.values_u128()[:20]
            if out.length <= 32:
                native_calls.clear()
                np.testing.assert_array_equal(out.values_u64(), jout.values_u64())
                assert native_calls == [out.length]


@pytest.mark.parametrize("k,w", [(5, 7), (21, 11), (33, 11), (64, 12)])
def test_output_after_a_card_run_takes_the_card_route(k, w, monkeypatch):
    """After a CUDA run, values of DNA go to ops/device_values with the
    run's device and the upload of convert.packed_words; text stays on the
    host. The card is replaced by the CPU here (the plain version runs):
    the values equal the host's."""
    uploads = []
    real = convert.packed_words

    def upload(seq, device):
        uploads.append(torch.device(device).type)
        return real(seq, "cpu")

    monkeypatch.setattr(convert, "packed_words", upload)
    codes = _codes(k + w, 3000)
    seq = smt.PackedSeqVec.from_codes(codes)
    card = torch.device("cuda")
    for b, _ in _builders(k, w):
        host = b.run(seq, device="cpu")
        out = api.Output(host.length, host.seq, host.positions, canonical=host.canonical,
                         _device=card)
        uploads.clear()
        limbs = out.values_u128_limbs() if out.length <= 64 else None
        if limbs is None:
            with pytest.raises(AssertionError):
                out.values_u128_limbs()
            continue
        for g, h in zip(limbs, host.values_u128_limbs(), strict=True):
            np.testing.assert_array_equal(g, h)
        assert out.values_u128() == host.values_u128()
        if out.length <= 32:
            np.testing.assert_array_equal(out.values_u64(), host.values_u64())
        assert uploads and set(uploads) == {"cuda"}
    text = np.random.default_rng(k).integers(32, 127, 500, dtype=np.uint8)
    host = smt.minimizers(min(k, 8), w).hasher(smt.MulHasher(min(k, 8))).run(text, device="cpu")
    out = api.Output(host.length, host.seq, host.positions, _device=card)
    uploads.clear()
    np.testing.assert_array_equal(out.values_u64(), host.values_u64())
    assert not uploads


def test_assertions_as_in_jax():
    """The JAX package's assertions: values_u64 past k = 32 and u128 past
    k = 64 raise AssertionError, in the port's host, card and Output paths."""
    codes = _codes(0)
    pos = np.array([0, 5], np.uint32)
    chars = _chars(codes, False)
    with pytest.raises(AssertionError, match="values_u64 requires"):
        device_values.kmer_values_u64(chars, pos, 33)
    with pytest.raises(AssertionError, match="values_u64 requires"):
        jdv.kmer_values_u64(codes, pos, 33)
    with pytest.raises(AssertionError, match="k <= 64"):
        device_values.kmer_values_u128_limbs(chars, pos, 65)
    with pytest.raises(AssertionError, match="k <= 64"):
        jdv.kmer_values_u128_limbs(codes, pos, 65)
    with pytest.raises(AssertionError, match="values_u64 requires"):
        native.kmer_values_u64(codes, pos, 33, False)
    seq, jseq = smt.PackedSeqVec.from_codes(codes), JPackedSeqVec.from_codes(codes)
    for b, jb in ((smt.minimizers(33, 5), jsm.minimizers(33, 5)),
                  (smt.closed_syncmers(40, 30), jsm.closed_syncmers(40, 30))):
        out, jout = b.run(seq, device="cpu"), jb.run(jseq)
        with pytest.raises(AssertionError):
            jout.values_u64()
        with pytest.raises(AssertionError):
            out.values_u64()
        if out.length > 64:
            with pytest.raises(AssertionError):
                jout.values_u128_limbs()
            with pytest.raises(AssertionError):
                out.values_u128_limbs()
    text = JGenericSeq(np.frombuffer(b"Call me Ishmael. Some years ago", np.uint8))
    out = smt.minimizers(9, 3).hasher(smt.MulHasher(9)).run(text.codes(), device="cpu")
    with pytest.raises(AssertionError):
        out.values_u64()  # 8 bits a char: 9 chars need 72 bits


def test_bad_arguments_raise():
    codes = _codes(1)
    chars = _chars(codes, False)
    pos = _pos_tensor(np.array([0, 1], np.uint32))
    with pytest.raises(TypeError):
        device_values.kmer_values_limbs(chars.to(torch.int32), pos, 5)
    with pytest.raises(ValueError):
        device_values.kmer_values_limbs(chars, pos.to(torch.int64), 5)
    with pytest.raises(ValueError):
        native.kmer_values_u64(codes, np.array([codes.size - 4], np.uint32), 5, False)


def test_native_builds_into_its_own_directory():
    """The extractor is built once, named by a hash of its source and flags,
    under build/torch_native/ at the root of the checkout."""
    lib = native.library()
    assert native.library() is lib
    names = [p.name for p in native.BUILD_DIR.glob("libsmt_native_*.so")]
    assert names and native.BUILD_DIR.parts[-2:] == ("build", "torch_native")
