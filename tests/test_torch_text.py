"""General text and the mul and antilex hashers through the port on the CPU
(the kernels' plain versions) == the JAX fused kernel in interpret mode ==
the NumPy oracle.

Each case makes its input from a numpy seed: text as random bytes (the
JAX kernel reads them byte-striped, `dna=False`), DNA as random 2-bit codes
(`dna=True`). It runs through `ops/fused.fused_sketch` on CPU tensors, the
JAX fused kernel in interpret mode (one compile per case; seeded and
unseeded tables share it) and the oracle, and through the port's builder.
The inputs span four tiles of the port's 4096 windows. Text at w = 2047 is
held against the JAX pipeline and the oracle, since the JAX kernel stops
at l - 1 <= 1024 for text. Integer outputs: tolerance 0.
"""

import numpy as np
import pytest
import torch

import simd_minimizers_tpu_torch as smt
from simd_minimizers_tpu.hashers import AntiLexHasher, MulHasher, NtHasher
from simd_minimizers_tpu.ops import fused as jfused
from simd_minimizers_tpu.ops import oracle
from simd_minimizers_tpu.ops import pipeline as jpipe
from simd_minimizers_tpu_torch import convert
from simd_minimizers_tpu_torch.ops import fused, pipeline

K, W = 21, 11
L = K + W - 1
TILE = fused.TILE
N = 3 * TILE + 17 + L - 1  # four tiles of windows, the last one short
C = 1024  # the JAX kernel's smallest legal block width, as tests/test_fused.py runs it
MIN, SKM = pipeline.MODE_MINIMIZERS, pipeline.MODE_SUPERKMERS
CLOSED, OPEN = pipeline.MODE_CLOSED_SYNCMERS, pipeline.MODE_OPEN_SYNCMERS
SYNCMER = {MIN: 0, SKM: 0, CLOSED: 1, OPEN: 2}
HASHERS = {"nt": NtHasher, "mul": MulHasher, "antilex": AntiLexHasher}


def _planes(x) -> tuple:
    if isinstance(x, tuple):
        return tuple(_planes(p)[0] for p in x)
    if isinstance(x, torch.Tensor):
        x = x.numpy()
    return (np.asarray(x).astype(np.uint32),)


def _oracle(codes, k, w, h, mode, amb=None):
    sel = oracle.selected_stream(codes, k, w, h, ambiguous=amb)
    if mode == SKM:
        return oracle.collect_and_dedup_with_index(sel)
    if mode in (CLOSED, OPEN):
        return oracle.collect_syncmers(sel, w, mode == OPEN)
    return oracle.collect_and_dedup(sel, skip_sentinel=amb is not None)


def _chars(codes, text):
    return torch.from_numpy(codes if text else smt.PackedSeqVec.from_codes(codes).data)


def _port(codes, k, w, h, mode, text, amb=None):
    """fused_sketch on CPU tensors; launches nothing."""
    key, tables = convert.hasher_tensors(convert.hasher_from(h), "cpu", text=text)
    plane = None if amb is None else convert.ambiguity_plane(amb, codes.size, "cpu")
    before = dict(fused.LAUNCHES)
    got = fused.fused_sketch(_chars(codes, text), codes.size, k, w, tables, key[2], h.canonical,
                             mode, plane, text=text, kind=key[0])
    assert fused.LAUNCHES == before
    return _planes(got)


def _seq(codes, text):
    return smt.GenericSeq(codes) if text else smt.PackedSeqVec.from_codes(codes)


def _check(codes, h, mode, text, amb=None):
    """Port (wrapper and builder) == JAX fused interpret == oracle."""
    got = _port(codes, K, W, h, mode, text, amb)
    amb_u8 = None if amb is None else amb.astype(np.uint8)
    wants = {
        "oracle": _oracle(codes, K, W, h, mode, amb),
        "JAX fused, interpret": jfused.fused_sketch(codes, K, W, h, mode=mode,
                                                    ambiguous_np=amb_u8, C=C, interpret=True,
                                                    dna=not text),
    }
    for name, want in wants.items():
        want = _planes(want)
        assert len(got) == len(want), name
        for g, p in zip(got, want):
            np.testing.assert_array_equal(g, p, err_msg=name)
    b = smt.Builder(K, W, h.canonical, syncmer=SYNCMER[mode]).hasher(convert.hasher_from(h))
    b = b.super_kmers() if mode == SKM else b
    out = b.run(_seq(codes, text), ambiguous=amb, device="cpu")
    assert out.length == (L if mode in (CLOSED, OPEN) else K)
    np.testing.assert_array_equal(out.positions, got[0])
    if mode == SKM:
        np.testing.assert_array_equal(out.superkmer_indices, got[1])
    return got


CASES = [(kind, mode, canonical, True) for kind in HASHERS for mode in (MIN, SKM, CLOSED, OPEN)
         for canonical in (False, True)]
CASES += [(kind, mode, canonical, False) for kind in ("mul", "antilex")
          for mode in (MIN, SKM, CLOSED, OPEN) for canonical in (False, True)]


@pytest.mark.parametrize("kind,mode,canonical,text", CASES)
def test_port_vs_jax_and_oracle(kind, mode, canonical, text):
    """Every mode, both strands; nt and mul seeded and not (one JAX compile:
    the table and constant are data)."""
    rng = np.random.default_rng(5)
    codes = rng.integers(0, 256 if text else 4, N, dtype=np.uint8)
    for seed in ((None,) if kind == "antilex" else (None, 1234)):
        _check(codes, HASHERS[kind](K, canonical=canonical, seed=seed), mode, text)


MASK_CASES = [("mul", MIN, False), ("nt", CLOSED, True), ("antilex", OPEN, True),
              ("mul", OPEN, False)]


@pytest.mark.parametrize("kind,mode,canonical", MASK_CASES)
def test_text_with_mask(kind, mode, canonical):
    """A mask on text: 1% random flags and a run across a tile seam."""
    rng = np.random.default_rng(6)
    codes = rng.integers(32, 127, N, dtype=np.uint8)
    amb = rng.random(N) < 0.01
    amb[2 * TILE - 40:2 * TILE + 30] = True
    amb[TILE - 1] = True
    got = _check(codes, HASHERS[kind](K, canonical=canonical), mode, True, amb)
    assert pipeline.SKIPPED not in got[0]


@pytest.mark.parametrize("kind", list(HASHERS))
@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("nw", [1, TILE - 1, TILE, TILE + 1, 2 * TILE + 1])
def test_each_kernel_plain_at_tile_seams(kind, canonical, nw):
    """Each kernel's wrapper on CPU tensors of text (its plain version), in
    the two-plane super-k-mer mode: the tile runs and counts of
    minimizer_tiles, the scan of tile_offsets and the gather of tile_append,
    from the oracle's kept windows."""
    rng = np.random.default_rng(nw)
    codes = rng.integers(0, 256, nw + L - 1, dtype=np.uint8)
    h = HASHERS[kind](K, canonical=canonical)
    pos, widx = _oracle(codes, K, W, h, SKM)
    ntiles = -(-nw // TILE)
    want_counts = np.bincount(widx // TILE, minlength=ntiles)
    key, tables = convert.hasher_tensors(convert.hasher_from(h), "cpu", text=True)
    scratch, counts = fused.minimizer_tiles(torch.from_numpy(codes), codes.size, K, W, tables,
                                            key[2], canonical, SKM, text=True, kind=kind)
    assert scratch.shape == (2, ntiles * TILE)
    np.testing.assert_array_equal(counts.numpy(), want_counts)
    for runs, want in zip(scratch.view(2, ntiles, TILE).numpy(), (pos, widx)):
        got = np.concatenate([runs[t, :c] for t, c in enumerate(want_counts)])
        np.testing.assert_array_equal(got.astype(np.uint32), want)
    offsets = fused.tile_offsets(counts)
    out = fused.tile_append(scratch, counts, offsets, int(pos.size))
    np.testing.assert_array_equal(out.numpy().astype(np.uint32), np.stack([pos, widx]))


@pytest.mark.parametrize("canonical", [False, True])
def test_text_w2047(canonical):
    """Text at w = 2047 (l - 1 = 2066 > the JAX kernel's text halo of 1024):
    the port's kernel geometry takes it; held against the JAX pipeline and
    the oracle."""
    k, w = 21, 2047
    assert fused.fused_supported(k, w, canonical, text=True)
    assert not jfused.fused_supported(k, w, dna=False)
    codes = np.random.default_rng(8).integers(0, 256, 2 * TILE + k + w - 2, dtype=np.uint8)
    h = MulHasher(k, canonical=canonical)
    key, tables = convert.hasher_tensors(convert.hasher_from(h), "cpu", text=True)
    got = fused.fused_sketch(torch.from_numpy(codes), codes.size, k, w, tables, key[2],
                             canonical, text=True, kind="mul").numpy().astype(np.uint32)
    assert got.size >= 4
    np.testing.assert_array_equal(got, _oracle(codes, k, w, h, MIN))
    np.testing.assert_array_equal(got, jpipe.run_pipeline(codes, k, w, h))


@pytest.mark.parametrize("k", [5, 21, 33])
@pytest.mark.parametrize("text", [False, True])
def test_antilex_low_entropy_ties(k, text):
    """Long runs of one char tie the top 16 bits (the first 8 chars) of many
    windows; with k > 16 the hash ignores the k-mer's tail. The
    leftmost / rightmost tie-breaks carry the result."""
    rng = np.random.default_rng(k)
    alphabet = 256 if text else 4
    codes = np.repeat(rng.integers(0, alphabet, 900, dtype=np.uint8), rng.integers(1, 30, 900))
    w = 11  # l = k + 10 is odd for each k here: both strands run
    for canonical in (False, True):
        h = AntiLexHasher(k, canonical=canonical)
        for mode in (MIN, SKM):
            got = fused.fused_sketch(_chars(codes, text), codes.size, k, w, None, 0, canonical,
                                     mode, text=text, kind="antilex")
            want = _oracle(codes, k, w, h, mode)
            for g, p in zip(_planes(got), _planes(want)):
                np.testing.assert_array_equal(g, p)


def test_table_shape_is_checked():
    """The wrapper holds the tables to the input kind: 4 entries a row for
    2-bit codes, 256 for text; antilex takes none."""
    h = smt.MulHasher(5)
    _, t4 = convert.hasher_tensors(h, "cpu")
    _, t256 = convert.hasher_tensors(h, "cpu", text=True)
    chars = torch.zeros(64, dtype=torch.uint8)
    for tables, text in ((t4, True), (t256, False), (None, False), (t4[0], False)):
        with pytest.raises(ValueError, match="tables"):
            fused.fused_sketch(chars, 64, 5, 7, tables, 23, False, text=text, kind="mul")
    with pytest.raises(ValueError, match="kind"):
        fused.fused_sketch(chars, 64, 5, 7, t4, 23, False, kind="xor")
    fused.fused_sketch(chars, 64, 5, 7, None, 0, False, text=True, kind="antilex")


def test_text_geometry_gate():
    """The fold's tables take 2 KB of the tile's shared memory for text, 32 B
    for 2-bit codes, and nothing for antilex, which reads none."""
    for canonical, mode, amb in ((True, MIN, False), (False, SKM, False), (False, CLOSED, True)):
        dna = fused._tile_smem_bytes(21, 11, canonical, mode, amb)
        for kind in ("nt", "mul"):
            assert fused._tile_smem_bytes(21, 11, canonical, mode, amb, True, kind) == dna + 2016
        for text in (False, True):
            assert (fused._tile_smem_bytes(21, 11, canonical, mode, amb, text, "antilex")
                    == dna - 32)
    # the large-w route holds no tables (it reads kmer_top16's tops) and the
    # 16-bit column bounds w first: 4096 + w <= 2^16 for every input and hasher
    assert (fused._tile_smem_bytes(21, 32_767, True, text=True, kind="mul")
            == fused._tile_smem_bytes(21, 32_767, True))
    for text, kind in ((False, "nt"), (True, "mul"), (True, "antilex"), (False, "antilex")):
        assert fused.fused_supported(21, 61_440, False, text=text, kind=kind)
        assert not fused.fused_supported(21, 61_441, False, text=text, kind=kind)
    assert fused.fused_supported(21, 2047, True, text=True)
