"""The port's super-k-mers, syncmers and skip-ambiguous windows on the CPU
(the kernels' plain versions) == the JAX package == the NumPy oracle.

Each case makes its sequence and mask from a numpy seed and runs them
through the port (a CPU tensor through `ops/fused.fused_sketch`, and the
builder) and through the JAX fused kernel in interpret mode, the JAX
pipeline and the oracle. Masks: none, 1% random, and one clustered at the
port's 4096-window tile seams. Integer outputs: tolerance 0. The kernels
themselves are checked on a card by tests/test_torch_cuda.py and
chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import simd_minimizers_tpu as sm
import simd_minimizers_tpu_torch as smt
from simd_minimizers_tpu.hashers import NtHasher
from simd_minimizers_tpu.native import pack_2bit
from simd_minimizers_tpu.ops import fused as jfused
from simd_minimizers_tpu.ops import oracle
from simd_minimizers_tpu.ops import pipeline as jpipe
from simd_minimizers_tpu.seq.packed import PackedSeqVec
from simd_minimizers_tpu.utils.bits import SKIPPED
from simd_minimizers_tpu_torch import convert
from simd_minimizers_tpu_torch.ops import fused, pipeline

K, W = 21, 11
L = K + W - 1
TILE = fused.TILE
N = 3 * TILE + 17 + L - 1  # four tiles of windows, the last one short
C = 1024  # the JAX kernel's smallest legal block width, as tests/test_fused.py runs it
MIN, SKM = pipeline.MODE_MINIMIZERS, pipeline.MODE_SUPERKMERS
CLOSED, OPEN = pipeline.MODE_CLOSED_SYNCMERS, pipeline.MODE_OPEN_SYNCMERS
SYNCMER = {MIN: 0, SKM: 0, CLOSED: 1, OPEN: 2}  # the builders' `syncmer` field


def _mask(kind: str, n: int, rng) -> np.ndarray | None:
    if kind == "none":
        return None
    if kind == "random":
        return rng.random(n) < 0.01
    # clustered: an N in the last l chars before the first tile seam (it
    # makes the window before the seam SKIPPED but not the first one after
    # it), one just past the second seam's halo, and a run across the third
    amb = np.zeros(n, bool)
    amb[[p for p in (TILE - 1, 2 * TILE + L - 2) if p < n]] = True
    amb[3 * TILE - 60:3 * TILE + 40] = True
    return amb


def _planes(x) -> tuple:
    """A result as a tuple of uint32 planes (two for super-k-mers)."""
    if isinstance(x, tuple):
        return tuple(_planes(p)[0] for p in x)
    if isinstance(x, torch.Tensor):
        x = x.numpy()
    return (np.asarray(x).astype(np.uint32),)


def _oracle(codes, h, mode, amb):
    sel = oracle.selected_stream(codes, K, W, h, ambiguous=amb)
    if mode == SKM:
        return oracle.collect_and_dedup_with_index(sel)
    if mode in (CLOSED, OPEN):
        return oracle.collect_syncmers(sel, W, mode == OPEN)
    return oracle.collect_and_dedup(sel, skip_sentinel=amb is not None)


def _port(codes, h, mode, amb):
    words = torch.from_numpy(pack_2bit(codes))
    key, table = convert.hasher_tensors(convert.hasher_from(h), "cpu")
    plane = None if amb is None else convert.ambiguity_plane(amb, codes.size, "cpu")
    before = dict(fused.LAUNCHES)
    got = fused.fused_sketch(words, codes.size, K, W, table, key[2], h.canonical, mode, plane)
    assert fused.LAUNCHES == before  # the CPU path launches no kernel
    assert all(g.dtype == torch.int32 for g in (got if mode == SKM else (got,)))
    return _planes(got)


def _builder(pkg, mode, canonical):
    b = pkg.Builder(K, W, canonical, syncmer=SYNCMER[mode])
    return b.super_kmers() if mode == SKM else b


CASES = [(mode, canonical, mask) for mode in (MIN, CLOSED, OPEN) for canonical in (False, True)
         for mask in ("none", "random", "clustered")]
# super-k-mers never carry a mask (the reference cannot express it)
CASES += [(SKM, canonical, "none") for canonical in (False, True)]


@pytest.mark.parametrize("mode,canonical,mask", CASES)
def test_port_vs_jax_and_oracle(mode, canonical, mask):
    rng = np.random.default_rng(2)
    codes = rng.integers(0, 4, N, dtype=np.uint8)
    amb = _mask(mask, N, rng)
    amb_u8 = None if amb is None else amb.astype(np.uint8)
    h = NtHasher(K, canonical=canonical)
    got = _port(codes, h, mode, amb)
    wants = {
        "oracle": _oracle(codes, h, mode, amb),
        "JAX fused, interpret": jfused.fused_sketch(codes, K, W, h, mode=mode,
                                                    ambiguous_np=amb_u8, C=C, interpret=True),
        "JAX pipeline": jpipe.run_pipeline(codes, K, W, h, mode=mode, ambiguous_np=amb_u8),
    }
    for name, want in wants.items():
        want = _planes(want)
        assert len(got) == len(want), name
        for g, p in zip(got, want):
            np.testing.assert_array_equal(g, p, err_msg=name)
    out = _builder(smt, mode, canonical).run(smt.PackedSeqVec.from_codes(codes), ambiguous=amb,
                                              device="cpu")
    np.testing.assert_array_equal(out.positions, got[0])
    if mode == SKM:
        np.testing.assert_array_equal(out.superkmer_indices, got[1])
    assert SKIPPED not in got[0]  # dropped after the dedup, never emitted


def _oracle_kept(codes, h, mode, amb):
    """(value planes, window index of each kept window) of the oracle."""
    sel = oracle.selected_stream(codes, K, W, h, ambiguous=amb)
    widx = np.arange(sel.size, dtype=np.uint32)
    if mode in (CLOSED, OPEN):
        kept = oracle.collect_syncmers(sel, W, mode == OPEN)
        return (kept,), kept
    keep = np.ones(sel.size, bool)
    keep[1:] = sel[1:] != sel[:-1]
    if amb is not None:
        keep &= sel != SKIPPED
    planes = (sel[keep], widx[keep]) if mode == SKM else (sel[keep],)
    return planes, widx[keep]


@pytest.mark.parametrize("mode,ambiguous", [(SKM, False), (CLOSED, False), (OPEN, True),
                                            (MIN, True)])
@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("nw", [1, TILE, TILE + 1, 3 * TILE + 17])
def test_each_kernel_plain_at_tile_seams(mode, ambiguous, canonical, nw):
    """Each kernel's wrapper on CPU tensors (its plain version): the tile
    runs and counts of minimizer_tiles in every plane, the scan of
    tile_offsets and the gather of tile_append, from the oracle's kept
    windows (oracle.collect_and_dedup_with_index for super-k-mers)."""
    rng = np.random.default_rng(nw)
    codes = rng.integers(0, 4, nw + L - 1, dtype=np.uint8)
    amb = None
    if ambiguous:
        amb = _mask("clustered", codes.size, rng) | (rng.random(codes.size) < 0.002)
    h = NtHasher(K, canonical=canonical)
    want, widx = _oracle_kept(codes, h, mode, amb)
    if mode == SKM:
        np.testing.assert_array_equal(
            want, oracle.collect_and_dedup_with_index(oracle.selected_stream(codes, K, W, h)))
    ntiles = -(-nw // TILE)
    want_counts = np.bincount(widx // TILE, minlength=ntiles)

    words = torch.from_numpy(pack_2bit(codes))
    key, table = convert.hasher_tensors(convert.hasher_from(h), "cpu")
    plane = None if amb is None else convert.ambiguity_plane(amb, codes.size, "cpu")
    before = dict(fused.LAUNCHES)
    scratch, counts = fused.minimizer_tiles(words, codes.size, K, W, table, key[2], canonical,
                                            mode, plane)
    assert scratch.shape == ((2, ntiles * TILE) if mode == SKM else (ntiles * TILE,))
    np.testing.assert_array_equal(counts.numpy(), want_counts)
    for runs, w_plane in zip(scratch.view(-1, ntiles, TILE).numpy(), want):
        got = np.concatenate([runs[t, :c] for t, c in enumerate(want_counts)])
        np.testing.assert_array_equal(got.astype(np.uint32), w_plane)

    offsets = fused.tile_offsets(counts)
    np.testing.assert_array_equal(offsets.numpy(), np.r_[0, np.cumsum(want_counts)])
    out = fused.tile_append(scratch, counts, offsets, int(widx.size))
    assert out.shape == ((2, widx.size) if mode == SKM else (widx.size,))
    for o, w_plane in zip(out.view(len(want), widx.size).numpy(), want):
        np.testing.assert_array_equal(o.astype(np.uint32), w_plane)
    assert fused.LAUNCHES == before


@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 1001])
@pytest.mark.parametrize("dtype", [np.bool_, np.uint8])
def test_ambiguity_plane_layout(n, dtype):
    rng = np.random.default_rng(n)
    flags = rng.random(n) < 0.3
    # a uint8 mask counts any nonzero byte as ambiguous
    mask = flags if dtype == np.bool_ else flags * rng.integers(1, 256, n).astype(np.uint8)
    plane = convert.ambiguity_plane(mask, n, "cpu")
    assert plane.dtype == torch.uint8 and plane.shape == ((n + 7) // 8,)
    bits = plane.numpy()
    for i in range(n):
        assert (bits[i // 8] >> (i % 8)) & 1 == flags[i]
    unpacked = pipeline.unpack_bits(plane, plane.numel() * 8).numpy()
    np.testing.assert_array_equal(unpacked[:n], flags)
    assert not unpacked[n:].any()  # the bits past n are zero
    np.testing.assert_array_equal(np.packbits(flags, bitorder="little"), bits)


def test_ambiguity_plane_rejects_bad_masks():
    with pytest.raises(ValueError):
        convert.ambiguity_plane(np.zeros(10, bool), 11, "cpu")
    with pytest.raises(TypeError):
        convert.ambiguity_plane(np.zeros(10, np.float32), 10, "cpu")


@pytest.mark.parametrize("name", ["minimizers", "canonical_minimizers", "closed_syncmers",
                                  "canonical_closed_syncmers", "open_syncmers",
                                  "canonical_open_syncmers"])
def test_builders_vs_jax(name):
    rng = np.random.default_rng(3)
    seq = PackedSeqVec.from_codes(rng.integers(0, 4, N, dtype=np.uint8))
    amb = _mask("random", N, rng)
    for mask in (None, amb):
        got = getattr(smt, name)(K, W).run(convert.seq_from(seq), ambiguous=mask, device="cpu")
        want = getattr(sm, name)(K, W).run(seq, ambiguous=mask)
        assert isinstance(got, smt.Output)
        assert (got.length, got.canonical) == (want.length, want.canonical)
        np.testing.assert_array_equal(got.positions, want.positions)
        np.testing.assert_array_equal(got.values_u64(), want.values_u64())
    assert got.length == (L if "syncmers" in name else K)


@pytest.mark.parametrize("canonical", [False, True])
def test_superkmer_builder_vs_jax(canonical):
    seq = PackedSeqVec.from_codes(np.random.default_rng(4).integers(0, 4, N, dtype=np.uint8))
    got = smt.Builder(K, W, canonical).super_kmers().run(convert.seq_from(seq), device="cpu")
    want = sm.Builder(K, W, canonical).super_kmers().run(seq)
    np.testing.assert_array_equal(got.positions, want.positions)
    np.testing.assert_array_equal(got.superkmer_indices, want.superkmer_indices)
    assert got.superkmer_indices.dtype == np.uint32
    np.testing.assert_array_equal(got.values_u64(), want.values_u64())
