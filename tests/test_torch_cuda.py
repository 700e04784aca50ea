"""The port's CUDA kernels against their plain versions and the oracle, on a card.

Every instance of minimizer_tiles (strand x minimizers / super-k-mers /
syncmers x ambiguity plane), on 2-bit DNA and on text, with the nt, mul
and antilex hashers, and both small kernels, around tile seams. The port
runs on its own classes; the independent reference is the JAX package's
NumPy oracle with the JAX package's hashers (both import no JAX).

Marked `cuda`; without a CUDA card every test skips. This file imports no
JAX, so on a machine without it run it as

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from simd_minimizers_tpu.hashers import AntiLexHasher, MulHasher, NtHasher
from simd_minimizers_tpu.ops import oracle
from simd_minimizers_tpu_torch import api, convert
from simd_minimizers_tpu_torch.ops import fused, pipeline
from simd_minimizers_tpu_torch.seq.packed import GenericSeq, PackedNSeqVec, PackedSeqVec

pytestmark = pytest.mark.cuda

TILE = fused.TILE
SKM, CLOSED, OPEN = (pipeline.MODE_SUPERKMERS, pipeline.MODE_CLOSED_SYNCMERS,
                     pipeline.MODE_OPEN_SYNCMERS)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _args(codes, k, w, h, dev, mode=pipeline.MODE_MINIMIZERS, amb=None, text=False):
    """(positional, keyword) arguments of the wrapper and its plain version
    for codes (2-bit codes, or text bytes) hashed by the port's copy of h."""
    if text:
        chars = convert.text_bytes(GenericSeq(codes), dev)
    else:
        chars = convert.packed_words(PackedSeqVec.from_codes(codes), dev)
    (kind, canonical, rot), tables = convert.hasher_tensors(convert.hasher_from(h), dev, text)
    plane = None if amb is None else convert.ambiguity_plane(amb, codes.size, dev)
    return ((chars, codes.size, k, w, tables, rot, canonical, mode, plane),
            {"text": text, "kind": kind})


def _both(codes, k, w, h, dev, mode=pipeline.MODE_MINIMIZERS, amb=None, text=False):
    """(kernel path, plain version) on the card, as numpy planes."""
    args, kw = _args(codes, k, w, h, dev, mode, amb, text)
    got = fused.fused_sketch(*args, **kw)
    want = pipeline.run_pipeline(*args, **kw)
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
    args = _args(codes, k, w, h, dev)[0][:7]
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
    args = _args(codes, k, w, h, dev, mode, _clustered_mask(n, k + w - 1, rng) if amb else None)[0]
    plane = args[-1]
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


# -- text and the mul and antilex hashers ------------------------------------
# (the hasher and text part of tests/test_tpu_hardware.py's fuzz)
HASHER_CASES = [(MulHasher, 31, 5, False), (MulHasher, 21, 11, True),
                (AntiLexHasher, 19, 19, True), (AntiLexHasher, 5, 7, True),
                (AntiLexHasher, 33, 7, True), (NtHasher, 21, 11, True)]


@pytest.mark.parametrize("cls,k,w,canonical", HASHER_CASES)
@pytest.mark.parametrize("text", [False, True])
@pytest.mark.parametrize("mode", [pipeline.MODE_MINIMIZERS, SKM, CLOSED, OPEN])
def test_hashers_vs_plain_and_oracle(dev, cls, k, w, canonical, text, mode):
    """On 2-bit DNA and on text, around tile seams, seeded and not (antilex
    has no seed)."""
    l = k + w - 1
    rng = np.random.default_rng(k * 100 + w)
    for seed in (None, 31) if cls is not AntiLexHasher else (None,):
        h = cls(k, canonical=canonical, seed=seed)
        for nw in [1, TILE - 1, TILE + 1, 3 * TILE + 17, 100_003]:
            codes = rng.integers(0, 256 if text else 4, nw + l - 1, dtype=np.uint8)
            got, want = _both(codes, k, w, h, dev, mode, text=text)
            _assert_planes(got, want, _oracle(codes, k, w, h, mode))


def test_text_mul_on_card(dev):
    """tests/test_tpu_hardware.py's text case: printable bytes, mul (7, 5)."""
    text = np.random.default_rng(0xF022).integers(32, 127, 50_000, dtype=np.uint8)
    h = MulHasher(7)
    got, want = _both(text, 7, 5, h, dev, text=True)
    _assert_planes(got, want, _oracle(text, 7, 5, h))
    b = api.minimizers(7, 5).hasher(convert.hasher_from(h))
    np.testing.assert_array_equal(b.run_once(text.tobytes(), device=dev), want)


@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("cls", [MulHasher, NtHasher, AntiLexHasher])
def test_text_w2047(dev, canonical, cls):
    """Text at w = 2047: beyond the TPU kernel's text halo, inside this one."""
    k, w = 21, 2047
    codes = np.random.default_rng(2047).integers(0, 256, 5 * TILE + k + w - 2, dtype=np.uint8)
    h = cls(k, canonical=canonical)
    got, want = _both(codes, k, w, h, dev, text=True)
    _assert_planes(got, want, _oracle(codes, k, w, h))


def test_text_with_mask_and_ties(dev):
    """Text with a mask (random and across tile seams), and low-entropy
    text whose antilex keys tie, every mode but super-k-mers with a mask."""
    rng = np.random.default_rng(77)
    n = 5 * TILE + 3 + 30
    text = rng.integers(32, 127, n, dtype=np.uint8)
    runs = np.repeat(rng.integers(0, 256, 9000, dtype=np.uint8), rng.integers(1, 40, 9000))
    for mode in (pipeline.MODE_MINIMIZERS, CLOSED, OPEN):
        for h in (MulHasher(21), NtHasher(21, canonical=True), AntiLexHasher(21, canonical=True)):
            for amb in (rng.random(n) < 0.01, _clustered_mask(n, 31, rng)):
                got, want = _both(text, 21, 11, h, dev, mode, amb, text=True)
                _assert_planes(got, want, _oracle(text, 21, 11, h, mode, amb))
    for mode in (pipeline.MODE_MINIMIZERS, SKM):
        for canonical in (False, True):
            h = AntiLexHasher(21, canonical=canonical)
            got, want = _both(runs, 21, 11, h, dev, mode, text=True)
            _assert_planes(got, want, _oracle(runs, 21, 11, h, mode))


@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("mode,amb", [(pipeline.MODE_MINIMIZERS, False),
                                      (pipeline.MODE_MINIMIZERS, True), (SKM, False),
                                      (CLOSED, False), (CLOSED, True), (OPEN, True)])
@pytest.mark.parametrize("cls,text", [(MulHasher, True), (AntiLexHasher, True),
                                      (NtHasher, True), (MulHasher, False),
                                      (AntiLexHasher, False)])
def test_each_instance_with_text_and_hashers_vs_its_plain_version(dev, canonical, mode, amb,
                                                                  cls, text):
    """Every instance with the new input kind and hashers, each kernel
    against its plain version at several tile counts."""
    k, w = 21, 11
    rng = np.random.default_rng(10)
    h = cls(k, canonical=canonical)
    for ntiles in (1, 2, 7):
        n = ntiles * TILE - 5 + k + w - 2
        codes = rng.integers(0, 256 if text else 4, n, dtype=np.uint8)
        mask = _clustered_mask(n, k + w - 1, rng) if amb else None
        args, kw = _args(codes, k, w, h, dev, mode, mask, text)
        name = fused.instance_name(canonical, mode, amb)
        before = fused.LAUNCHES[name]
        scratch, counts = fused.minimizer_tiles(*args, **kw)
        assert fused.LAUNCHES[name] == before + 1 and counts.numel() == ntiles
        plain_scratch, plain_counts = pipeline.minimizer_tiles_plain(*args[:7], TILE,
                                                                     *args[7:], **kw)
        assert torch.equal(counts, plain_counts)
        live = torch.arange(TILE, device=dev) < counts[:, None]
        for got, want in zip(scratch.view(-1, ntiles, TILE), plain_scratch.view(-1, ntiles, TILE)):
            assert torch.equal(got[live], want[live])
        offsets = fused.tile_offsets(counts)
        assert torch.equal(offsets, pipeline.tile_offsets_plain(counts))
        total = int(offsets[-1])
        assert torch.equal(fused.tile_append(scratch, counts, offsets, total),
                           pipeline.tile_append_plain(scratch, counts, offsets, total, TILE))


@pytest.mark.parametrize("mode,amb,canonical,cls,text", [
    (pipeline.MODE_MINIMIZERS, False, True, MulHasher, True),
    (pipeline.MODE_MINIMIZERS, True, False, MulHasher, True),
    (SKM, False, False, MulHasher, True), (CLOSED, True, True, MulHasher, True),
    (pipeline.MODE_MINIMIZERS, True, False, AntiLexHasher, True),
    (SKM, False, True, AntiLexHasher, False)])
def test_widest_geometry_text(dev, mode, amb, canonical, cls, text):
    """The fold's tables count against the gate (2 KB for text, none for
    antilex): the widest w it admits runs."""
    k = 21
    step = 2 if canonical else 1
    kind = "antilex" if cls is AntiLexHasher else "mul"
    w = max(w for w in range(1, 1 << 16, step)
            if fused.fused_supported(k, w, canonical, mode, amb, text, kind))
    assert not fused.fused_supported(k, w + step, canonical, mode, amb, text, kind)
    n = 4 * w + k + w - 2
    rng = np.random.default_rng(w)
    codes = rng.integers(0, 256 if text else 4, n, dtype=np.uint8)
    mask = (rng.random(n) < 1e-4) if amb else None
    h = cls(k, canonical=canonical)
    got, want = _both(codes, k, w, h, dev, mode, mask, text=text)
    _assert_planes(got, want, _oracle(codes, k, w, h, mode, mask))


def test_builders_text_and_hashers_on_card(dev):
    """The public builders on the card: text (bytes, GenericSeq) with mul,
    nt and antilex, and DNA with mul and antilex, against the port's oracle."""
    rng = np.random.default_rng(13)
    text = rng.integers(32, 127, 200_000, dtype=np.uint8).tobytes()
    seq = PackedSeqVec.random(200_000, rng)
    for k, w, cls, canonical in ((21, 11, MulHasher, False), (21, 11, NtHasher, True),
                                 (21, 11, AntiLexHasher, True), (31, 5, MulHasher, False)):
        h = convert.hasher_from(cls(k, canonical=canonical))
        for b in (api.Builder(k, w, canonical).hasher(h),
                  api.Builder(k, w, canonical, syncmer=1).hasher(h),
                  api.Builder(k, w, canonical).hasher(h).super_kmers()):
            for s in (text, GenericSeq(text), seq):
                out, want = b.run(s, device=dev), b.run_scalar(s)
                np.testing.assert_array_equal(out.positions, want.positions)
                if out.superkmer_indices is not None:
                    np.testing.assert_array_equal(out.superkmer_indices, want.superkmer_indices)
