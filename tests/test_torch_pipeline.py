"""The port's plain PyTorch pipeline == the JAX pipeline == the NumPy oracle.

Inputs are made from a numpy seed and go through both packages; outputs
are integers, so the tolerance is 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simd_minimizers_tpu.hashers import NtHasher
from simd_minimizers_tpu.native import pack_2bit
from simd_minimizers_tpu.ops import layout as jlayout
from simd_minimizers_tpu.ops import oracle
from simd_minimizers_tpu.ops import pipeline as jpipe
from simd_minimizers_tpu_torch import convert
from simd_minimizers_tpu_torch.ops import layout, pipeline

KW = [(5, 7), (21, 11), (31, 5), (19, 19)]


def _port(codes, k, w, h):
    words = torch.from_numpy(pack_2bit(codes))
    key, table = convert.hasher_tensors(convert.hasher_from(h), "cpu")
    got = pipeline.run_pipeline(words, codes.size, k, w, table, key[2], h.canonical)
    assert got.dtype == torch.int32
    return got.numpy().astype(np.uint32)


def _oracle(codes, k, w, h):
    return oracle.collect_and_dedup(oracle.selected_stream(codes, k, w, h))


@pytest.mark.parametrize("k,w", KW)
@pytest.mark.parametrize("canonical", [False, True])
def test_plain_vs_jax_pipeline(k, w, canonical):
    codes = np.random.default_rng(k * 100 + w).integers(0, 4, 20000, dtype=np.uint8)
    h = NtHasher(k, canonical=canonical)
    got = _port(codes, k, w, h)
    np.testing.assert_array_equal(got, jpipe.run_pipeline(codes, k, w, h))
    np.testing.assert_array_equal(got, _oracle(codes, k, w, h))


@pytest.mark.parametrize("k,w", KW)
@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("dn", [-1, 0, 1])
def test_plain_edge_lengths(k, w, canonical, dn):
    """n = l - 1 (no window), l (one window), l + 1 (two windows)."""
    n = k + w - 1 + dn
    codes = np.random.default_rng(n).integers(0, 4, n, dtype=np.uint8)
    h = NtHasher(k, canonical=canonical)
    got = _port(codes, k, w, h)
    np.testing.assert_array_equal(got, _oracle(codes, k, w, h))
    np.testing.assert_array_equal(got, jpipe.run_pipeline(codes, k, w, h))
    assert (got.size == 0) == (dn < 0)


# l = k + w - 1 odd, so each also runs canonical
@pytest.mark.parametrize("k,w", [(1, 5), (32, 6), (33, 5), (64, 4)])
@pytest.mark.parametrize("canonical", [False, True])
def test_plain_k_range(k, w, canonical):
    codes = np.random.default_rng(k).integers(0, 4, 5000, dtype=np.uint8)
    h = NtHasher(k, canonical=canonical)
    got = _port(codes, k, w, h)
    np.testing.assert_array_equal(got, _oracle(codes, k, w, h))
    np.testing.assert_array_equal(got, jpipe.run_pipeline(codes, k, w, h))


@pytest.mark.parametrize("canonical", [False, True])
def test_plain_seeded_hasher(canonical):
    k, w = 21, 11
    codes = np.random.default_rng(11).integers(0, 4, 20000, dtype=np.uint8)
    h = NtHasher(k, canonical=canonical, seed=1234)
    got = _port(codes, k, w, h)
    np.testing.assert_array_equal(got, _oracle(codes, k, w, h))
    np.testing.assert_array_equal(got, jpipe.run_pipeline(codes, k, w, h))


@pytest.mark.parametrize("k", [1, 2, 5, 21, 31, 32, 33, 63, 64])
@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("seed", [None, 99])
def test_kmer_hashes_vs_hash_kmers_np(k, canonical, seed):
    codes = np.random.default_rng(k).integers(0, 4, 700, dtype=np.uint8)
    h = NtHasher(k, canonical=canonical, seed=seed)
    key, table = convert.hasher_tensors(convert.hasher_from(h), "cpu")
    M = torch.from_numpy(codes)[None, :]
    got = pipeline.kmer_hashes_2d(M, table, k, key[2], canonical, C=codes.size)
    np.testing.assert_array_equal(got[0].numpy().astype(np.uint32), h.hash_kmers_np(codes))


@pytest.mark.parametrize("width", [1, 2, 3, 7, 11, 31, 64])
def test_layout_folds_vs_jax(width):
    rng = np.random.default_rng(width)
    x = rng.integers(0, 1 << 32, (3, 200), dtype=np.uint64).astype(np.uint32)
    bits = rng.integers(0, 2, (3, 200), dtype=np.int32)
    got_x = layout.windowed_xor(torch.from_numpy(x.astype(np.int64)), width)
    got_s = layout.windowed_sum(torch.from_numpy(bits), width)
    np.testing.assert_array_equal(got_x.numpy().astype(np.uint32),
                                  np.asarray(jlayout.windowed_xor(jnp.asarray(x), width)))
    np.testing.assert_array_equal(got_s.numpy(),
                                  np.asarray(jlayout.windowed_sum(jnp.asarray(bits), width)))
    hv = x & np.uint32(0xFFFF0000)
    hv[:, ::13] = np.uint32(0xFFFFFFFF)  # never-winning k-mers
    for right in (False, True):
        got = layout.window_min_cols_packed(torch.from_numpy(hv.astype(np.int64)), width, right)
        want = jlayout.window_min_cols_packed(jnp.asarray(hv), width, right_tie=right)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("C,R,span", [(16, 1, 10), (16, 3, 40), (8, 4, 8), (32, 2, 33)])
def test_build_lane_matrix_vs_jax(C, R, span):
    nblocks = -(-max(span - C, 0) // C)
    flat = np.arange((R + nblocks) * C, dtype=np.uint8)
    got = layout.build_lane_matrix(torch.from_numpy(flat), R, C, span)
    want = jlayout.build_lane_matrix(jnp.asarray(flat), R, C, span)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_even_l_canonical_raises():
    h = NtHasher(20, canonical=True)
    with pytest.raises(ValueError):
        _port(np.zeros(100, np.uint8), 20, 11, h)
