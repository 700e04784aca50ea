"""What the port carries across: the hasher's table and the 2-bit sequence.

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
from simd_minimizers_tpu_torch import convert
from simd_minimizers_tpu_torch.ops import pipeline


@pytest.mark.parametrize("seed", [None, 0, 1, 2024, 2**40 + 3])
@pytest.mark.parametrize("canonical", [False, True])
def test_hasher_tensors_carry_the_table(seed, canonical):
    k = 21
    h = NtHasher(k, canonical=canonical, seed=seed)
    key, table, mul_const = convert.hasher_tensors(h, "cpu")
    jkey, jtable, jmul = jpipe.hasher_jit_args(h)
    assert key == jkey and mul_const == int(jmul)
    assert table.dtype == torch.int64 and table.shape == (4,)
    np.testing.assert_array_equal(table.numpy().astype(np.uint32), jtable)
    if seed is None:
        np.testing.assert_array_equal(table.numpy().astype(np.uint32), NT_TABLE)

    codes = np.random.default_rng(5).integers(0, 4, 600, dtype=np.uint8)
    M = torch.from_numpy(codes)[None, :]
    got = pipeline.kmer_hashes_2d(M, table, k, key[2], canonical, C=codes.size)
    want_jax = jpipe.kmer_hashes_2d(jnp.asarray(codes)[None, :], h, codes.size)
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), np.asarray(want_jax))
    np.testing.assert_array_equal(got[0].numpy().astype(np.uint32), h.hash_kmers_np(codes))


@pytest.mark.parametrize("offset", [0, 1, 2, 3, 4, 7])
def test_packed_words_layout(offset):
    codes = np.random.default_rng(offset).integers(0, 4, 1001, dtype=np.uint8)
    seq = PackedSeqVec.from_codes(codes).slice(offset, 1001)
    words = convert.packed_words(seq, "cpu")
    assert words.dtype == torch.uint8 and words.numel() == (seq.length + 3) // 4
    np.testing.assert_array_equal(pipeline.unpack_2bit(words, seq.length).numpy(),
                                  seq.codes())


def test_packed_words_zero_copy_when_aligned():
    seq = PackedSeqVec.random(1000, np.random.default_rng(1))
    words = convert.packed_words(seq, "cpu")
    assert words.data_ptr() == seq.data.ctypes.data


def test_packed_words_from_ascii():
    raw = b"ACGTTGCA" * 9
    words = convert.packed_words(AsciiSeq(raw), "cpu")
    np.testing.assert_array_equal(words.numpy(), pack_2bit(AsciiSeq(raw).codes()))
