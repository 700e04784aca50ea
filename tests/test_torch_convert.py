"""What the port carries across: the hasher's per-char tables and the
2-bit sequence.

A seeded NtHasher's table, moved by `convert.hasher_tensors`, must give
the same k-mer hashes in both packages (the port's "weights").
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simd_minimizers_tpu.hashers import NT_TABLE, NtHasher
from simd_minimizers_tpu.native import pack_2bit
from simd_minimizers_tpu.ops import pipeline as jpipe
from simd_minimizers_tpu.seq.packed import AsciiSeq, PackedSeqVec
import simd_minimizers_tpu_torch as smt
from simd_minimizers_tpu_torch import convert
from simd_minimizers_tpu_torch.ops import pipeline
from simd_minimizers_tpu_torch.seq.packed import pack_2bit as smt_pack_2bit


@pytest.mark.parametrize("seed", [None, 0, 1, 2024, 2**40 + 3])
@pytest.mark.parametrize("canonical", [False, True])
def test_hasher_tensors_carry_the_table(seed, canonical):
    k = 21
    h = NtHasher(k, canonical=canonical, seed=seed)
    key, table = convert.hasher_tensors(convert.hasher_from(h), "cpu")
    jkey, jtable, jmul = jpipe.hasher_jit_args(h)
    assert key == jkey and int(jmul) == 0
    # forward values F[c] = T[c], complement values R[c] = T[c ^ 2]
    assert table.dtype == torch.int64 and table.shape == (2, 4)
    np.testing.assert_array_equal(table.numpy().astype(np.uint32), [jtable, jtable[[2, 3, 0, 1]]])
    if seed is None:
        np.testing.assert_array_equal(table[0].numpy().astype(np.uint32), NT_TABLE)

    codes = np.random.default_rng(5).integers(0, 4, 600, dtype=np.uint8)
    M = torch.from_numpy(codes)[None, :]
    got = pipeline.kmer_hashes_2d(M, table, k, key[2], canonical, C=codes.size)
    want_jax = jpipe.kmer_hashes_2d(jnp.asarray(codes)[None, :], h, codes.size)
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), np.asarray(want_jax))
    np.testing.assert_array_equal(got[0].numpy().astype(np.uint32), h.hash_kmers_np(codes))


@pytest.mark.parametrize("offset", [0, 1, 2, 3, 4, 7])
def test_packed_words_layout(offset):
    codes = np.random.default_rng(offset).integers(0, 4, 1001, dtype=np.uint8)
    seq = convert.seq_from(PackedSeqVec.from_codes(codes).slice(offset, 1001))
    words = convert.packed_words(seq, "cpu")
    assert words.dtype == torch.uint8 and words.numel() == (seq.length + 3) // 4
    np.testing.assert_array_equal(pipeline.unpack_2bit(words, seq.length).numpy(),
                                  seq.codes())


def test_packed_words_zero_copy_when_aligned():
    seq = convert.seq_from(PackedSeqVec.random(1000, np.random.default_rng(1)))
    words = convert.packed_words(seq, "cpu")
    assert words.data_ptr() == seq.data.ctypes.data


def test_packed_words_from_ascii():
    raw = b"ACGTTGCA" * 9
    words = convert.packed_words(smt.AsciiSeq(raw), "cpu")
    np.testing.assert_array_equal(words.numpy(), pack_2bit(AsciiSeq(raw).codes()))
    np.testing.assert_array_equal(smt_pack_2bit(AsciiSeq(raw).codes()), words.numpy())


@pytest.mark.parametrize("n", [0, 1, 3, 4, 5, 1001])
def test_pack_2bit_vs_native(n):
    """The port's NumPy packing equals the JAX package's native one."""
    codes = np.random.default_rng(n).integers(0, 4, n, dtype=np.uint8)
    got = smt_pack_2bit(codes)
    assert got.dtype == np.uint8 and got.flags.c_contiguous
    np.testing.assert_array_equal(got, pack_2bit(codes))
    np.testing.assert_array_equal(smt.PackedSeqVec.from_codes(codes).codes(), codes)


def test_text_bytes():
    """Text crosses as its raw bytes, 1 B per char, without a host copy."""
    raw = np.random.default_rng(3).integers(0, 256, 777, dtype=np.uint8)
    t = convert.text_bytes(smt.GenericSeq(raw), "cpu")
    assert t.dtype == torch.uint8 and t.shape == (777,)
    assert t.data_ptr() == raw.ctypes.data
    np.testing.assert_array_equal(t.numpy(), raw)
    t = convert.text_bytes(smt.GenericSeq(b"read-only bytes!"), "cpu")
    assert bytes(t.numpy()) == b"read-only bytes!"
