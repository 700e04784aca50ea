"""The large-w route's pre-pass, kmer_top16, on the CPU: its plain version
(`pipeline.kmer_top16_plain`) against the JAX package's hashes of the same
inputs, and the wrapper on a CPU tensor.

The kernel itself (csrc/top16.cu) runs only on a card
(tests/test_torch_cuda.py, chip_smoke.py); on a CPU tensor its wrapper runs
this plain version and counts no launch. Inputs are made with numpy from a
seed; the tops are integers, so the tolerance is 0. The JAX side is
`hash_kmers_np(codes) >> 16` for 2-bit codes (packed and one code per byte)
and `pipeline.kmer_hashes_2d` on one row of text bytes, as
tests/test_torch_hashers.py runs it.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simd_minimizers_tpu.hashers import AntiLexHasher, MulHasher, NtHasher
from simd_minimizers_tpu.ops import pipeline as jpipe
from simd_minimizers_tpu_torch import convert
from simd_minimizers_tpu_torch.ops import fused, pipeline
from simd_minimizers_tpu_torch.seq.packed import GenericSeq, PackedSeqVec

KINDS = {"nt": NtHasher, "mul": MulHasher, "antilex": AntiLexHasher}
KS = [1, 5, 21, 31, 64]
NS = ["k - 1", "k", "10,000"]


def _n(k: int, which: str) -> int:
    return {"k - 1": k - 1, "k": k, "10,000": 10_000}[which]


def _tops(got: torch.Tensor) -> np.ndarray:
    assert got.dtype == torch.int16
    return got.numpy().view(np.uint16)


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("which", NS)
def test_plain_vs_jax_hashes_of_2bit_codes(kind, canonical, k, which):
    """2-bit codes, packed and as code bytes (high bits set, which the
    kernel ignores), seeded and not: the top halves of the JAX hasher's
    `hash_kmers_np`."""
    n = _n(k, which)
    codes = np.random.default_rng(k * 10 + n).integers(0, 4, n, dtype=np.uint8)
    for seed in (None, 7):
        jh = KINDS[kind](k, canonical=canonical, seed=seed)
        want = (jh.hash_kmers_np(codes) >> 16).astype(np.uint16)
        (kd, can, rot), tables = convert.hasher_tensors(convert.hasher_from(jh), "cpu")
        packed = convert.packed_words(PackedSeqVec.from_codes(codes), "cpu")
        np.testing.assert_array_equal(
            _tops(pipeline.kmer_top16_plain(packed, n, k, tables, rot, can, kind=kd)), want)
        high = convert.code_bytes(codes | 0xF0, "cpu")
        np.testing.assert_array_equal(
            _tops(pipeline.kmer_top16_plain(high, n, k, tables, rot, can, kind=kd,
                                            byte_codes=True)), want)


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("which", NS)
def test_plain_vs_jax_pipeline_on_text(kind, canonical, k, which):
    """Text bytes: the top halves of the JAX pipeline's `kmer_hashes_2d` on
    one row of the same bytes."""
    n = _n(k, which)
    text = np.random.default_rng(k * 10 + n + 1).integers(0, 256, n, dtype=np.uint8)
    jh = KINDS[kind](k, canonical=canonical)
    (kd, can, rot), tables = convert.hasher_tensors(convert.hasher_from(jh), "cpu", text=True)
    got = _tops(pipeline.kmer_top16_plain(convert.text_bytes(GenericSeq(text), "cpu"), n, k,
                                          tables, rot, can, text=True, kind=kd))
    if n < k:
        assert got.size == 0
        return
    want = np.asarray(jpipe.kmer_hashes_2d(jnp.asarray(text[None, :]), jh, n))[0] >> 16
    np.testing.assert_array_equal(got, want.astype(np.uint16))


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("text", [False, True])
def test_wrapper_on_cpu_is_the_plain_version(kind, text):
    """fused.kmer_top16 on a CPU tensor returns the plain version and
    launches nothing; LAUNCHES counts the kernel by name; below one k-mer
    the result is empty."""
    k, n = 21, 5000
    rng = np.random.default_rng(3)
    jh = KINDS[kind](k, canonical=not text)
    (kd, can, rot), tables = convert.hasher_tensors(convert.hasher_from(jh), "cpu", text=text)
    if text:
        chars, kw = convert.text_bytes(GenericSeq(rng.integers(0, 256, n, dtype=np.uint8)),
                                       "cpu"), {"text": True}
    else:
        chars = convert.packed_words(PackedSeqVec.from_codes(
            rng.integers(0, 4, n, dtype=np.uint8)), "cpu")
        kw = {}
    assert "kmer_top16" in fused.LAUNCHES
    before = dict(fused.LAUNCHES)
    got = fused.kmer_top16(chars, n, k, tables, rot, can, kind=kd, **kw)
    assert torch.equal(got, pipeline.kmer_top16_plain(chars, n, k, tables, rot, can, kind=kd,
                                                      **kw))
    assert got.shape == (n - k + 1,)
    assert fused.kmer_top16(chars, k - 1, k, tables, rot, can, kind=kd, **kw).numel() == 0
    assert fused.LAUNCHES == before


def test_top16_argument_is_checked():
    """minimizer_tiles takes a `top16` array on the large-w route only, of
    int16 and at least n - k + 1 values; the CPU's plain version hashes on
    both routes and returns the same with or without it."""
    k = 21
    rng = np.random.default_rng(4)
    h = convert.hasher_from(NtHasher(k))
    (kd, can, rot), tables = convert.hasher_tensors(h, "cpu")
    for w in (11, fused.LARGE_W_MIN):
        n = fused.TILE + k + w + 50
        chars = convert.packed_words(PackedSeqVec.from_codes(
            rng.integers(0, 4, n, dtype=np.uint8)), "cpu")
        args = (chars, n, k, w, tables, rot, can)
        tops = fused.kmer_top16(chars, n, k, tables, rot, can, kind=kd)
        if fused.sub_tile(k, w, can) == 0:
            with pytest.raises(ValueError, match="large-w route only"):
                fused.minimizer_tiles(*args, top16=tops)
            continue
        want = fused.minimizer_tiles(*args)
        got = fused.minimizer_tiles(*args, top16=tops)
        assert all(torch.equal(g, p) for g, p in zip(got, want, strict=True))
        for bad in (tops.to(torch.int32), tops[:-1]):
            with pytest.raises(ValueError, match="top16"):
                fused.minimizer_tiles(*args, top16=bad)


@pytest.mark.parametrize("name", ["large-w branch", "pre-pass"])
def test_sources_hash_where_they_should(name):
    """The large-w branch of minimizer_tiles hashes nothing and reads no
    table (it reads kmer_top16's tops); the pre-pass has its own hash."""
    csrc = Path(fused.__file__).resolve().parents[1] / "csrc"
    if name == "pre-pass":
        src = (csrc / "top16.cu").read_text()
        assert "rotl(tF[c]" in src and "s_roll[0][4 * c_out + c_in]" in src
        return
    src = (csrc / "minimizers.cu").read_text()
    branch = re.search(r"\n  } else {\n    // large-w route(.*?)\n  // B3/B4/B5/B6", src, re.S)
    assert branch is not None
    body = branch.group(1)
    assert "top16" in body
    for word in ("hash_cols", "rotl", "rotr", "tF[", "tR[", "s_roll", "table["):
        assert word not in body, word
