"""The port's kernel wrapper (`ops.fused.fused_sketch`) on CPU tensors == the
JAX fused Pallas kernel in interpret mode == the NumPy oracle.

On a CPU tensor the wrapper runs the kernel's plain version and launches
nothing; the kernel itself is checked on a card by tests/test_torch_cuda.py
and chip_smoke.py. Integer outputs: tolerance 0.
"""

import numpy as np
import pytest
import torch

import simd_minimizers_tpu_torch as smt

from simd_minimizers_tpu.hashers import AntiLexHasher, MulHasher, NtHasher
from simd_minimizers_tpu.native import pack_2bit
from simd_minimizers_tpu.ops import backend as jbackend
from simd_minimizers_tpu.ops import fused as jfused
from simd_minimizers_tpu.ops import oracle
from simd_minimizers_tpu_torch import convert
from simd_minimizers_tpu_torch.ops import backend, fused, pipeline

C = 1024  # the JAX kernel's smallest legal block width, as tests/test_fused.py runs it


def _port(codes, k, w, h):
    words = torch.from_numpy(pack_2bit(codes))
    key, table = convert.hasher_tensors(convert.hasher_from(h), "cpu")
    return fused.fused_sketch(words, codes.size, k, w, table, key[2], h.canonical, kind=key[0])


@pytest.mark.parametrize("k,w,canonical,seed", [
    (5, 7, False, None), (21, 11, True, None), (31, 5, False, None),
    (19, 19, True, None), (21, 11, True, 77),
])
def test_fused_sketch_cpu_vs_jax_interpret(k, w, canonical, seed):
    codes = np.random.default_rng(k * 31 + w).integers(0, 4, 20000, dtype=np.uint8)
    h = NtHasher(k, canonical=canonical, seed=seed)
    before = dict(fused.LAUNCHES)
    got = _port(codes, k, w, h)
    assert fused.LAUNCHES == before  # the CPU path launches no kernel
    assert got.device.type == "cpu" and got.dtype == torch.int32
    got = got.numpy().astype(np.uint32)
    want = jfused.fused_sketch(codes, k, w, h, C=C, interpret=True)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, oracle.collect_and_dedup(oracle.selected_stream(codes, k, w, h)))


@pytest.mark.parametrize("k,w,canonical", [(21, 11, True), (5, 7, False)])
@pytest.mark.parametrize("nw", [1, fused.TILE, fused.TILE + 1, 3 * fused.TILE + 17])
def test_each_kernel_cpu_vs_oracle(k, w, canonical, nw):
    """Each kernel's wrapper on CPU tensors (its plain version): the tile
    runs and counts of minimizer_tiles, the scan of tile_offsets and the
    gather of tile_append, from the oracle's kept windows."""
    tile = fused.TILE
    codes = np.random.default_rng(nw).integers(0, 4, nw + k + w - 2, dtype=np.uint8)
    h = NtHasher(k, canonical=canonical)
    pos, widx = oracle.collect_and_dedup_with_index(oracle.selected_stream(codes, k, w, h))
    ntiles = -(-nw // tile)
    want_counts = np.bincount(widx // tile, minlength=ntiles)
    before = dict(fused.LAUNCHES)

    words = torch.from_numpy(pack_2bit(codes))
    key, table = convert.hasher_tensors(convert.hasher_from(h), "cpu")
    scratch, counts = fused.minimizer_tiles(words, codes.size, k, w, table, key[2], canonical)
    assert scratch.shape == (ntiles * tile,) and scratch.dtype == counts.dtype == torch.int32
    np.testing.assert_array_equal(counts.numpy(), want_counts)
    runs = scratch.view(ntiles, tile).numpy()
    np.testing.assert_array_equal(
        np.concatenate([runs[t, :c] for t, c in enumerate(want_counts)]).astype(np.uint32), pos)

    offsets = fused.tile_offsets(counts)
    np.testing.assert_array_equal(offsets.numpy(), np.r_[0, np.cumsum(want_counts)])
    out = fused.tile_append(scratch, counts, offsets, pos.size)
    np.testing.assert_array_equal(out.numpy().astype(np.uint32), pos)
    assert fused.LAUNCHES == before


@pytest.mark.parametrize("n", [0, 3, 30])
def test_short_input_is_empty(n):
    before = dict(fused.LAUNCHES)
    got = _port(np.zeros(n, np.uint8), 21, 11, NtHasher(21, canonical=True))
    assert got.numel() == 0 and fused.LAUNCHES == before


def test_geometry_gate():
    # the tile's chars and keys must fit one block's shared memory: two key
    # arrays for canonical, one for forward
    assert fused.fused_supported(21, 21_000, canonical=True)
    assert not fused.fused_supported(21, 22_000, canonical=True)
    assert fused.fused_supported(21, 40_000, canonical=False)
    assert not fused.fused_supported(21, 43_000, canonical=False)
    assert fused.fused_supported(21, 11) and fused.fused_supported(64, 2)
    assert not fused.fused_supported(200_000, 11)
    # chars, keys, then the nt fold's 2-bit tables (2 x 4 words)
    assert fused._tile_smem_bytes(21, 11, True) == 4144 + 2 * (fused.TILE + 11) * 4 + 32
    # super-k-mers stage two planes of TILE words in the keys' space; an
    # ambiguity plane adds the tile's bits in 32-bit words
    skm = pipeline.MODE_SUPERKMERS
    assert fused._tile_smem_bytes(21, 11, False, skm) == 4144 + 2 * fused.TILE * 4 + 32
    assert fused._tile_smem_bytes(21, 11, True, skm) == fused._tile_smem_bytes(21, 11, True)
    assert (fused._tile_smem_bytes(21, 11, True, ambiguous=True)
            == fused._tile_smem_bytes(21, 11, True) + (fused.TILE + 31 + 62) // 32 * 4)
    assert fused.fused_supported(21, 40_000, False, skm)
    assert not fused.fused_supported(21, 42_376, False, ambiguous=True)
    assert fused.fused_supported(21, 42_376, False)


@pytest.mark.parametrize("k,w", [(200_001, 11), (21, 43_001)])
def test_beyond_gate_raises_on_cpu(k, w):
    words = torch.zeros(1 << 16, dtype=torch.uint8)
    with pytest.raises(NotImplementedError, match="ROADMAP A3"):
        backend.sketch(words, 1 << 18, k, w, smt.NtHasher(k, canonical=(k + w) % 2 == 0))


@pytest.mark.parametrize("mode", [pipeline.MODE_SUPERKMERS, pipeline.MODE_CLOSED_SYNCMERS,
                                  pipeline.MODE_OPEN_SYNCMERS])
def test_other_modes_raise(mode):
    """The modes besides minimizers, refused until they were ported, run on
    the CPU and match the oracle, super-k-mers with an ambiguity plane too
    (equal to the JAX package's backend.sketch with that mask); what the JAX
    package refuses in them raises its AssertionError: open syncmers with an
    even w, a canonical hasher with an even l."""
    codes = np.random.default_rng(6).integers(0, 4, 400, dtype=np.uint8)
    words = torch.from_numpy(pack_2bit(codes))
    h = smt.NtHasher(5)
    got = backend.sketch(words, 400, 5, 7, h, mode=mode)
    sel = oracle.selected_stream(codes, 5, 7, h)
    if mode == pipeline.MODE_SUPERKMERS:
        for g, want in zip(got, oracle.collect_and_dedup_with_index(sel), strict=True):
            np.testing.assert_array_equal(g.numpy().astype(np.uint32), want)
        mask = np.zeros(400, np.uint8)
        mask[[3, 150, 151, 390]] = 1
        got = backend.sketch(words, 400, 5, 7, h, mode, convert.ambiguity_plane(mask, 400, "cpu"))
        want = jbackend.sketch(codes, 5, 7, NtHasher(5), mode=mode, ambiguous_np=mask)
        for g, p in zip(got, want, strict=True):
            np.testing.assert_array_equal(g.numpy().view(np.uint32), p)
        refused = dict(w=8, hasher=smt.NtHasher(5, canonical=True))
    else:
        want = oracle.collect_syncmers(sel, 7, mode == pipeline.MODE_OPEN_SYNCMERS)
        np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
        refused = (dict(w=8, hasher=h) if mode == pipeline.MODE_OPEN_SYNCMERS
                   else dict(w=8, hasher=smt.NtHasher(5, canonical=True)))
    with pytest.raises(AssertionError):
        backend.sketch(words, 400, 5, refused.pop("w"), refused.pop("hasher"), mode=mode,
                       **refused)


def test_other_hasher_raises():
    """The mul and antilex hashers, refused until they were ported, run on
    the CPU and match the oracle; a hasher that is not the port's, or of
    another k, still raises."""
    codes = np.random.default_rng(7).integers(0, 4, 400, dtype=np.uint8)
    words = torch.from_numpy(pack_2bit(codes))
    for cls in (MulHasher, AntiLexHasher):
        for canonical in (False, True):
            jh = cls(5, canonical=canonical)
            got = backend.sketch(words, 400, 5, 7, convert.hasher_from(jh))
            want = oracle.collect_and_dedup(oracle.selected_stream(codes, 5, 7, jh))
            np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
    with pytest.raises(TypeError):
        backend.sketch(words, 400, 5, 7, MulHasher(5))
    with pytest.raises(ValueError):
        backend.sketch(words, 400, 5, 7, smt.MulHasher(6))


def test_long_input_raises():
    """One launch takes fewer than 2^31 chars (the JAX package's
    AssertionError in _fused_launch); sketch_long splits longer inputs, up
    to 2^32 chars."""
    words = torch.zeros(4, dtype=torch.uint8)
    with pytest.raises(AssertionError, match="2\\^31"):
        fused.fused_sketch(words, 1 << 31, 21, 11, torch.zeros(2, 4, dtype=torch.int64), 23,
                           False)
    with pytest.raises(AssertionError, match="2\\^32"):
        fused.sketch_long(words, 1 << 32, 21, 11, smt.NtHasher(21))


def test_bad_arguments_raise():
    table = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(TypeError):
        fused.fused_sketch(torch.zeros(8, dtype=torch.int32), 30, 5, 7, table, 23, False)
    with pytest.raises(ValueError):  # canonical needs odd l
        fused.fused_sketch(torch.zeros(8, dtype=torch.uint8), 30, 6, 7, table, 23, True)
    with pytest.raises(ValueError):
        fused.fused_sketch(torch.zeros(8, dtype=torch.uint8, device="meta"), 30, 5, 7,
                           table, 23, False)


def test_cuda_request_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    seq = np.zeros(100, np.uint8)
    with pytest.raises(RuntimeError):
        convert.packed_words(smt.PackedSeqVec.from_codes(seq), "cuda")
    with pytest.raises(RuntimeError):
        convert.text_bytes(smt.GenericSeq(seq), "cuda")
    with pytest.raises(RuntimeError):
        convert.hasher_tensors(smt.NtHasher(5), "cuda")
