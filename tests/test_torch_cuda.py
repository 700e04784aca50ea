"""The port's CUDA kernels against their plain versions and the oracle, on a card.

Every instance of minimizer_tiles (strand x minimizers / super-k-mers /
syncmers x ambiguity plane) and both small kernels, around tile seams.

Marked `cuda`; without a CUDA card every test skips. This file imports no
JAX, so on a machine without it run it as

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from simd_minimizers_tpu.hashers import NtHasher
from simd_minimizers_tpu.ops import oracle
from simd_minimizers_tpu.seq.packed import PackedNSeqVec, PackedSeqVec
from simd_minimizers_tpu_torch import api, convert
from simd_minimizers_tpu_torch.ops import fused, pipeline

pytestmark = pytest.mark.cuda

TILE = fused.TILE
SKM, CLOSED, OPEN = (pipeline.MODE_SUPERKMERS, pipeline.MODE_CLOSED_SYNCMERS,
                     pipeline.MODE_OPEN_SYNCMERS)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _both(codes, k, w, h, dev, mode=pipeline.MODE_MINIMIZERS, amb=None):
    """(kernel path, plain version) on the card, as numpy planes."""
    words = convert.packed_words(PackedSeqVec.from_codes(codes), dev)
    key, table, _ = convert.hasher_tensors(h, dev)
    plane = None if amb is None else convert.ambiguity_plane(amb, codes.size, dev)
    args = (words, codes.size, k, w, table, key[2], h.canonical, mode, plane)
    got = fused.fused_sketch(*args)
    want = pipeline.run_pipeline(*args)
    torch.cuda.synchronize()
    if mode == SKM:
        return tuple(t.cpu().numpy() for t in got), tuple(t.cpu().numpy() for t in want)
    return got.cpu().numpy(), want.cpu().numpy()


def _oracle(codes, k, w, h, mode=pipeline.MODE_MINIMIZERS, amb=None):
    sel = oracle.selected_stream(codes, k, w, h, ambiguous=amb)
    if mode == SKM:
        return oracle.collect_and_dedup_with_index(sel)
    if mode in (CLOSED, OPEN):
        return oracle.collect_syncmers(sel, w, mode == OPEN)
    return oracle.collect_and_dedup(sel, skip_sentinel=amb is not None)


def _assert_planes(got, want, ref):
    got, want, ref = ((x,) if isinstance(x, np.ndarray) else x for x in (got, want, ref))
    for g, p, r in zip(got, want, ref, strict=True):
        np.testing.assert_array_equal(g, p)
        np.testing.assert_array_equal(g.astype(np.uint32), r)


def _clustered_mask(n, l, rng):
    """Ns where tile seams meet them: in the last chars of the window before
    a seam (the predecessor tile 1 recomputes), in the halo past another,
    a run across a third; plus a few isolated ones."""
    amb = np.zeros(n, bool)
    for pos in (TILE - 1, 2 * TILE + l - 2):
        if pos < n:
            amb[pos] = True
    amb[3 * TILE - 100:3 * TILE + 150] = True
    amb[rng.integers(0, n, 8)] = True
    return amb


CONFIGS = [(5, 7), (21, 11), (31, 5), (19, 19), (1, 5), (64, 2), (33, 3), (21, 1)]
# canonical needs odd l = k + w - 1
CASES = [(k, w, c) for k, w in CONFIGS for c in (False, True) if not c or (k + w) % 2 == 0]


@pytest.mark.parametrize("k,w,canonical", CASES)
@pytest.mark.parametrize("seed", [None, 7])
def test_kernel_vs_plain_and_oracle(dev, k, w, canonical, seed):
    l = k + w - 1
    rng = np.random.default_rng(k * 1000 + w)
    h = NtHasher(k, canonical=canonical, seed=seed)
    # lengths around tile seams and a multi-tile run
    for nw in [1, 2, TILE - 1, TILE, TILE + 1, 3 * TILE + 17, 200_003]:
        codes = rng.integers(0, 4, nw + l - 1, dtype=np.uint8)
        got, want = _both(codes, k, w, h, dev)
        np.testing.assert_array_equal(got, want)
        ref = oracle.collect_and_dedup(oracle.selected_stream(codes, k, w, h))
        np.testing.assert_array_equal(got.astype(np.uint32), ref)


@pytest.mark.parametrize("canonical", [False, True])
def test_each_kernel_vs_its_plain_version(dev, canonical):
    k, w = 21, 11
    codes = np.random.default_rng(8).integers(0, 4, 3 * TILE + 17 + k + w - 2, dtype=np.uint8)
    h = NtHasher(k, canonical=canonical)
    words = convert.packed_words(PackedSeqVec.from_codes(codes), dev)
    key, table, _ = convert.hasher_tensors(h, dev)
    args = (words, codes.size, k, w, table, key[2], canonical)
    scratch, counts = fused.minimizer_tiles(*args)
    plain_scratch, plain_counts = pipeline.minimizer_tiles_plain(*args, TILE)
    assert torch.equal(counts, plain_counts)
    live = torch.arange(TILE, device=dev) < counts[:, None]
    assert torch.equal(scratch.view(-1, TILE)[live], plain_scratch.view(-1, TILE)[live])
    offsets = fused.tile_offsets(counts)
    assert torch.equal(offsets, pipeline.tile_offsets_plain(counts))
    total = int(offsets[-1])
    assert torch.equal(fused.tile_append(scratch, counts, offsets, total),
                       pipeline.tile_append_plain(scratch, counts, offsets, total, TILE))


@pytest.mark.parametrize("ntiles", [1, 1023, 1024, 1025, 24_415])
def test_tile_offsets_many_tiles(dev, ntiles):
    # more tiles than the scan kernel's 1024 threads: each thread sums a run
    counts = torch.randint(0, TILE + 1, (ntiles,), dtype=torch.int32, device=dev)
    assert torch.equal(fused.tile_offsets(counts), pipeline.tile_offsets_plain(counts))


@pytest.mark.parametrize("canonical", [False, True])
def test_widest_geometry(dev, canonical):
    # the largest w the gate admits uses (nearly) all of a block's shared memory
    k = 21
    w = max(w for w in range(1, 1 << 16, 2 if canonical else 1)
            if fused.fused_supported(k, w, canonical))
    assert not fused.fused_supported(k, w + 2, canonical)
    codes = np.random.default_rng(w).integers(0, 4, 4 * w + k + w - 2, dtype=np.uint8)
    got, want = _both(codes, k, w, NtHasher(k, canonical=canonical), dev)
    np.testing.assert_array_equal(got, want)
    assert got.size >= 4


def test_low_entropy_ties(dev):
    # long runs of one base make many equal top-16 keys: exercises the
    # leftmost/rightmost tie-breaks across tile seams
    rng = np.random.default_rng(3)
    codes = np.repeat(rng.integers(0, 4, 4000, dtype=np.uint8), rng.integers(1, 40, 4000))
    for canonical in (False, True):
        h = NtHasher(21, canonical=canonical)
        got, want = _both(codes, 21, 11, h, dev)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode,amb", [(pipeline.MODE_MINIMIZERS, False),
                                      (pipeline.MODE_MINIMIZERS, True), (SKM, False),
                                      (CLOSED, False), (CLOSED, True), (OPEN, True)])
def test_short_input_launches_nothing(dev, mode, amb):
    before = dict(fused.LAUNCHES)
    codes = np.zeros(30, np.uint8)
    got, _ = _both(codes, 21, 11, NtHasher(21, canonical=True), dev, mode,
                   np.ones(30, bool) if amb else None)
    assert all(g.size == 0 for g in (got if mode == SKM else (got,)))
    assert fused.LAUNCHES == before


def test_builder_on_card_counts_launches(dev):
    seq = PackedSeqVec.random(100_000, np.random.default_rng(5))
    before = dict(fused.LAUNCHES)
    out = api.canonical_minimizers(21, 11).run(seq, device=dev)
    grew = {name: fused.LAUNCHES[name] - before[name] for name in before}
    assert grew == dict.fromkeys(before, 0) | {"minimizer_tiles<canonical>": 1,
                                                "tile_offsets": 1, "tile_append": 1}
    np.testing.assert_array_equal(out.positions,
                                  api.canonical_minimizers(21, 11).run_scalar_once(seq))


MODE_KW = [(21, 11), (5, 7), (19, 19), (31, 5)]  # odd l and odd w: every mode, both strands


@pytest.mark.parametrize("k,w", MODE_KW)
@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("seed", [None, 7])
@pytest.mark.parametrize("mode", [SKM, CLOSED, OPEN])
def test_modes_vs_plain_and_oracle(dev, k, w, canonical, seed, mode):
    l = k + w - 1
    rng = np.random.default_rng(k * 1000 + w)
    h = NtHasher(k, canonical=canonical, seed=seed)
    for nw in [1, 2, TILE - 1, TILE, TILE + 1, 3 * TILE + 17, 200_003]:
        codes = rng.integers(0, 4, nw + l - 1, dtype=np.uint8)
        got, want = _both(codes, k, w, h, dev, mode)
        _assert_planes(got, want, _oracle(codes, k, w, h, mode))


@pytest.mark.parametrize("k,w", [(21, 11), (5, 7), (31, 5)])
@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("seed", [None, 7])
@pytest.mark.parametrize("mode", [pipeline.MODE_MINIMIZERS, CLOSED, OPEN])
def test_ambiguity_vs_plain_and_oracle(dev, k, w, canonical, seed, mode):
    """Random (1%), clustered across tile seams, and all-clean masks: the
    dirty and clean branches of the block vote, and the recomputed
    predecessor window of a tile turning SKIPPED."""
    l = k + w - 1
    rng = np.random.default_rng(k * 7 + w)
    h = NtHasher(k, canonical=canonical, seed=seed)
    for nw in [1, TILE + 1, 5 * TILE + 3, 100_001]:
        n = nw + l - 1
        codes = rng.integers(0, 4, n, dtype=np.uint8)
        for amb in (rng.random(n) < 0.01, _clustered_mask(n, l, rng), np.zeros(n, bool)):
            got, want = _both(codes, k, w, h, dev, mode, amb)
            _assert_planes(got, want, _oracle(codes, k, w, h, mode, amb))


@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("mode,amb", [(pipeline.MODE_MINIMIZERS, True), (SKM, False),
                                      (CLOSED, False), (CLOSED, True), (OPEN, True)])
def test_each_new_instance_vs_its_plain_version(dev, canonical, mode, amb):
    k, w = 21, 11
    n = 5 * TILE + 17 + k + w - 2
    rng = np.random.default_rng(9)
    codes = rng.integers(0, 4, n, dtype=np.uint8)
    h = NtHasher(k, canonical=canonical)
    words = convert.packed_words(PackedSeqVec.from_codes(codes), dev)
    key, table, _ = convert.hasher_tensors(h, dev)
    plane = convert.ambiguity_plane(_clustered_mask(n, k + w - 1, rng), n, dev) if amb else None
    args = (words, n, k, w, table, key[2], canonical, mode, plane)
    name = fused.instance_name(canonical, mode, amb)
    before = fused.LAUNCHES[name]
    scratch, counts = fused.minimizer_tiles(*args)
    assert fused.LAUNCHES[name] == before + 1
    plain_scratch, plain_counts = pipeline.minimizer_tiles_plain(*args[:7], TILE, mode, plane)
    assert scratch.shape == plain_scratch.shape
    assert torch.equal(counts, plain_counts)
    live = torch.arange(TILE, device=dev) < counts[:, None]
    for got, want in zip(scratch.view(-1, counts.numel(), TILE),
                         plain_scratch.view(-1, counts.numel(), TILE)):
        assert torch.equal(got[live], want[live])
    offsets = fused.tile_offsets(counts)
    total = int(offsets[-1])
    assert torch.equal(fused.tile_append(scratch, counts, offsets, total),
                       pipeline.tile_append_plain(scratch, counts, offsets, total, TILE))


@pytest.mark.parametrize("canonical", [False, True])
def test_superkmers_many_tiles(dev, canonical):
    codes = np.random.default_rng(11).integers(0, 4, 2_000_000, dtype=np.uint8)
    h = NtHasher(21, canonical=canonical)
    got, want = _both(codes, 21, 11, h, dev, SKM)
    _assert_planes(got, want, _oracle(codes, 21, 11, h, SKM))


@pytest.mark.parametrize("mode,amb", [(pipeline.MODE_MINIMIZERS, True), (SKM, False),
                                      (CLOSED, True)])
def test_widest_geometry_modes(dev, mode, amb):
    # the ambiguity words and the second staging plane count against the gate
    k, canonical = 21, False
    w = max(w for w in range(1, 1 << 16) if fused.fused_supported(k, w, canonical, mode, amb))
    assert not fused.fused_supported(k, w + 1, canonical, mode, amb)
    n = 4 * w + k + w - 2
    rng = np.random.default_rng(w)
    codes = rng.integers(0, 4, n, dtype=np.uint8)
    mask = (rng.random(n) < 1e-4) if amb else None
    h = NtHasher(k, canonical=canonical)
    got, want = _both(codes, k, w, h, dev, mode, mask)
    _assert_planes(got, want, _oracle(codes, k, w, h, mode, mask))


def test_builders_on_card(dev):
    rng = np.random.default_rng(12)
    seq = PackedSeqVec.random(300_000, rng)
    amb = _clustered_mask(300_000, 31, rng)
    for b in (api.closed_syncmers(21, 11), api.canonical_open_syncmers(21, 11)):
        out = b.run(seq, ambiguous=amb, device=dev)
        assert out.length == 31
        np.testing.assert_array_equal(out.positions, b.run_scalar(seq, ambiguous=amb).positions)
    for b in (api.minimizers(21, 11).super_kmers(), api.canonical_minimizers(21, 11).super_kmers()):
        out, want = b.run(seq, device=dev), b.run_scalar(seq)
        np.testing.assert_array_equal(out.positions, want.positions)
        np.testing.assert_array_equal(out.superkmer_indices, want.superkmer_indices)
    nseq = PackedNSeqVec(seq, amb)
    b = api.canonical_minimizers(21, 11)
    np.testing.assert_array_equal(b.run_skip_ambiguous_windows_once(nseq, device=dev),
                                  b.run_scalar(seq, ambiguous=amb).positions)
