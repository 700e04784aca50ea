"""The port's own hashers and their per-char tables == the JAX package's.

`simd_minimizers_tpu_torch/hashers` is a copy of the JAX package's
hashers, so the NT table (a reconstruction, see its module note), the mul
constant and every hash must stay equal to the original. The per-char
forward and complement values that `convert.hasher_tensors` hands the
kernel must reproduce the hash of each single char, and the plain
pipeline's k-mer hashes on the lane matrix must equal `hash_kmers_np` on
2-bit codes and on text bytes. Integer outputs: tolerance 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import simd_minimizers_tpu.hashers as jh
import simd_minimizers_tpu.utils.bits as jbits
import simd_minimizers_tpu_torch.hashers as ph
import simd_minimizers_tpu_torch.utils.bits as pbits
from simd_minimizers_tpu.ops import pipeline as jpipe
from simd_minimizers_tpu_torch import convert
from simd_minimizers_tpu_torch.ops import pipeline

KINDS = {"nt": (jh.NtHasher, ph.NtHasher), "mul": (jh.MulHasher, ph.MulHasher),
         "antilex": (jh.AntiLexHasher, ph.AntiLexHasher)}
KS = [1, 5, 16, 17, 21, 31, 64]


def _inputs(k):
    """2-bit codes and random text bytes (both with a run of one char)."""
    rng = np.random.default_rng(k)
    codes = rng.integers(0, 4, 600, dtype=np.uint8)
    text = rng.integers(0, 256, 600, dtype=np.uint8)
    codes[100:160] = 2
    text[100:160] = ord("a")
    return codes, text


def test_constants_equal_the_jax_package():
    np.testing.assert_array_equal(ph.NT_TABLE, jh.NT_TABLE)
    assert ph.NT_TABLE.dtype == np.uint32
    assert ph.NT_ROT_OFFSET == jh.NT_ROT_OFFSET
    assert ph.MUL_CONST == jh.MUL_CONST and ph.MUL_CONST.dtype == np.uint32
    for seed in (0, 1, 42, 2**40 + 3):
        np.testing.assert_array_equal(ph._derive_table(seed), jh._derive_table(seed))
        assert pbits.splitmix64(seed) == jbits.splitmix64(seed)
    assert (pbits.INVALID, pbits.SKIPPED, pbits.VAL_MASK) == (jbits.INVALID, jbits.SKIPPED,
                                                              jbits.VAL_MASK)
    x = np.random.default_rng(0).integers(0, 1 << 32, 100, dtype=np.uint64).astype(np.uint32)
    for r in (0, 1, 23, 31, 32, 55):
        np.testing.assert_array_equal(pbits.rotl32_np(x, r), jbits.rotl32_np(x, r))


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("seed", [None, 99])
def test_hash_kmers_np_vs_jax(kind, k, canonical, seed):
    jcls, pcls = KINDS[kind]
    want_h, got_h = jcls(k, canonical, seed), pcls(k, canonical, seed)
    assert (got_h.kind, got_h.k, got_h.canonical, got_h.seed) == (kind, k, canonical, seed)
    for codes in _inputs(k):
        np.testing.assert_array_equal(got_h.hash_kmers_np(codes), want_h.hash_kmers_np(codes))
    assert ph.default_hasher(k, canonical).kind == "nt"


@pytest.mark.parametrize("kind", ["nt", "mul"])
@pytest.mark.parametrize("text", [False, True])
@pytest.mark.parametrize("seed", [None, 5])
def test_char_tables_are_per_char_hashes(kind, text, seed):
    """F[c] is the forward hash of the 1-mer c before its rotation by
    rot_offset, R[c] the reverse-complement one: canonical XOR forward."""
    jcls, pcls = KINDS[kind]
    fwd, can = jcls(1, False, seed), jcls(1, True, seed)
    key, tables = convert.hasher_tensors(pcls(1, True, seed), "cpu", text=text)
    rot = key[2]
    assert key == (kind, True, 23) and tables.dtype == torch.int64
    chars = np.arange(256 if text else 4, dtype=np.uint8)
    assert tables.shape == (2, chars.size)
    h_f, h_c = fwd.hash_kmers_np(chars), can.hash_kmers_np(chars)
    F, R = tables.numpy().astype(np.uint32)
    np.testing.assert_array_equal(jbits.rotl32_np(F, rot), h_f)
    np.testing.assert_array_equal(jbits.rotl32_np(R, rot), h_f ^ h_c)


def test_antilex_has_no_tables():
    for text in (False, True):
        key, tables = convert.hasher_tensors(ph.AntiLexHasher(21, True), "cpu", text=text)
        assert key == ("antilex", True, 0) and tables is None


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("canonical", [False, True])
def test_plain_kmer_hashes_vs_hash_kmers_np(kind, k, canonical):
    """The plain pipeline's lane-matrix hashes (the kernel's plain version)
    on 2-bit codes and on text bytes, seeded and not."""
    for seed in (None, 7):
        h = KINDS[kind][1](k, canonical, seed)
        for text, codes in zip((False, True), _inputs(k)):
            (_, _, rot), tables = convert.hasher_tensors(h, "cpu", text=text)
            M = torch.from_numpy(codes)[None, :]
            got = pipeline.kmer_hashes_2d(M, tables, k, rot, canonical, codes.size, kind)
            np.testing.assert_array_equal(got[0].numpy().astype(np.uint32),
                                          h.hash_kmers_np(codes))


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("canonical", [False, True])
def test_plain_kmer_hashes_vs_jax_pipeline(kind, canonical):
    """Against the JAX pipeline's `kmer_hashes_2d` on the same lane matrix
    of text bytes (two rows)."""
    k, C = 21, 256
    text = np.random.default_rng(3).integers(0, 256, (2, C + k - 1), dtype=np.uint8)
    jhash = KINDS[kind][0](k, canonical)
    (_, _, rot), tables = convert.hasher_tensors(convert.hasher_from(jhash), "cpu", text=True)
    got = pipeline.kmer_hashes_2d(torch.from_numpy(text), tables, k, rot, canonical, C, kind)
    want = jpipe.kmer_hashes_2d(jnp.asarray(text), jhash, C)
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), np.asarray(want))
