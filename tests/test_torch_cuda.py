"""The port's CUDA kernels against their plain versions and the oracle, on a card.

Every instance of minimizer_tiles (strand x minimizers / super-k-mers /
syncmers x ambiguity plane), on 2-bit DNA (packed and one code per byte)
and on text, with the nt, mul and antilex hashers, with a launch offset,
and both small kernels, around tile seams; and the drivers that run them:
sketch_long across many seams, sketch_records (pinned downloads reused
across waves) and the batch engine behind run_batch, with the ascii_slots
kernel that folds a read matrix on the card; the large-w route
(both routes bit-equal, w up to 61,439), ShortSeqSketcher's captured
graph, sharded sketching on one card and NCCL in a world of one; the
kmer_values kernel against its plain version and the host (positions past
2^31 included) and Output's values after a card run, by the launch count;
the randomized fuzz (tools/fuzz.py) on the card, and read_fasta's native
scan into sketch_records against the NumPy scan's records.
The port
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
from simd_minimizers_tpu.utils.bits import SKIPPED
from simd_minimizers_tpu_torch import api, convert
from simd_minimizers_tpu_torch.ops import fused, pipeline, spans
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
        # with a mask: the dedup on the raw stream, then SKIPPED dropped
        keep = np.ones(sel.size, bool)
        keep[1:] = sel[1:] != sel[:-1]
        keep &= sel != SKIPPED
        return sel[keep], np.flatnonzero(keep).astype(np.uint32)
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


@pytest.mark.parametrize("ntiles", [1, 2, 1023, 1024, 1025, 4095, 4096, 4097, 32_768, 32_769,
                                    24_415, 131_072, 1 << 19])
def test_tile_offsets_many_tiles(dev, ntiles):
    # the blocks of SCAN_BLOCK = 1024 counts and their ragged ends, a
    # look-back past 32 blocks (32,769 counts), a 2^29-char span's 131,072
    # tiles and the most a launch has (2^19)
    g = torch.Generator(device=dev).manual_seed(ntiles)
    counts = torch.randint(0, TILE + 1, (ntiles,), dtype=torch.int32, device=dev, generator=g)
    assert torch.equal(fused.tile_offsets(counts), pipeline.tile_offsets_plain(counts))
    zeros = torch.zeros(ntiles, dtype=torch.int32, device=dev)
    assert torch.equal(fused.tile_offsets(zeros), torch.zeros(ntiles + 1, dtype=torch.int32,
                                                              device=dev))
    # counts that do not start on 16 bytes take the scalar loads
    buf = torch.randint(0, TILE + 1, (ntiles + 1,), dtype=torch.int32, device=dev, generator=g)
    assert torch.equal(fused.tile_offsets(buf[1:]), pipeline.tile_offsets_plain(buf[1:]))
    # each launch leaves the card's tickets, counters and look-back words zeroed
    torch.cuda.synchronize()
    assert not fused._scan_status[counts.device.index].any()


@pytest.mark.parametrize("ntiles", [1, 1025, 24_415])
def test_tile_offsets_in_a_graph(dev, ntiles):
    """Launches captured in a CUDA graph, each replay beside eager launches
    on the same stream: every replay and every eager launch equal the plain
    version (no memset of the status words, eager or in the graph)."""
    g = torch.Generator(device=dev).manual_seed(ntiles)
    counts = torch.randint(0, TILE + 1, (ntiles,), dtype=torch.int32, device=dev, generator=g)
    want = pipeline.tile_offsets_plain(counts)
    fused.tile_offsets(counts)
    stream = torch.cuda.Stream(dev)
    stream.wait_stream(torch.cuda.current_stream(dev))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        outs = [fused.tile_offsets(counts) for _ in range(3)]
    torch.cuda.current_stream(dev).wait_stream(stream)
    for _ in range(4):
        for o in outs:
            o.zero_()
        graph.replay()
        eager = fused.tile_offsets(counts)
        assert all(torch.equal(o, want) for o in outs) and torch.equal(eager, want)
    torch.cuda.synchronize()
    assert not fused._scan_status[counts.device.index].any()


def _append_case(dev, ntiles, planes, counts_kind, seed):
    """(scratch, counts, offsets, total) of `ntiles` tiles: random runs, and
    counts all 0, all TILE, or random (so offsets are not multiples of 4)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    if counts_kind == "zero":
        counts = torch.zeros(ntiles, dtype=torch.int32, device=dev)
    elif counts_kind == "full":
        counts = torch.full((ntiles,), TILE, dtype=torch.int32, device=dev)
    else:
        counts = torch.randint(0, TILE + 1, (ntiles,), dtype=torch.int32, device=dev,
                               generator=g)
    scratch = torch.randint(0, 1 << 30, (planes, ntiles * TILE), dtype=torch.int32, device=dev,
                            generator=g)
    offsets = fused.tile_offsets(counts)
    return (scratch if planes == 2 else scratch[0]), counts, offsets, int(offsets[-1])


APPEND_NTILES = ["1", "2", "grid-1", "grid+1", "3grid+1", "131072"]


def _append_ntiles(dev, name):
    """A tile count: a number, or one about the size in tiles (warps) of
    tile_append's persistent grid on this card."""
    blocks, warps = fused.append_grid(dev)
    grid = blocks * warps
    return {"grid-1": grid - 1, "grid+1": grid + 1, "3grid+1": 3 * grid + 1}.get(name) or int(name)


@pytest.mark.parametrize("name", APPEND_NTILES)
@pytest.mark.parametrize("planes", [1, 2])
def test_tile_append_persistent_grid(dev, name, planes):
    """The persistent copy against its plain version over tile counts about
    the grid's size (a warp's second and fourth round of tiles) and a
    2^29-char span's 131,072 tiles, with random counts (offsets at every
    int of a 16-byte unit); with counts of a full tile the output is the
    scratch itself; with zero counts a launch copies nothing."""
    ntiles = _append_ntiles(dev, name)
    big = ntiles == 131_072
    for counts_kind in ("random", "full", "zero"):
        if big and planes == 2 and counts_kind == "full":
            continue  # 4 GiB of output that the one-plane case already covers
        scratch, counts, offsets, total = _append_case(dev, ntiles, planes, counts_kind, ntiles)
        before = fused.LAUNCHES["tile_append"]
        got = fused.tile_append(scratch, counts, offsets, total)
        assert fused.LAUNCHES["tile_append"] == before + (total > 0)
        assert got.shape == (*scratch.shape[:-1], total)
        if counts_kind == "full":
            assert torch.equal(got, scratch)
        elif counts_kind == "random" and big:  # the plain version's gather of 2^29 ints is costly
            for t in (0, 1, ntiles // 2, ntiles - 1):
                c, o = int(counts[t]), int(offsets[t])
                assert torch.equal(got[..., o:o + c], scratch[..., t * TILE:t * TILE + c])
        else:
            assert torch.equal(got, pipeline.tile_append_plain(scratch, counts, offsets, total,
                                                               TILE))
        if counts_kind == "zero":  # the card reads the total (0): nothing is written
            flat = fused.tile_append(scratch, counts, offsets, None)
            assert flat.numel() == planes * ntiles * TILE
        del scratch, got
    torch.cuda.empty_cache()


@pytest.mark.parametrize("planes", [1, 2])
def test_tile_append_unaligned_offsets(dev, planes):
    """Runs of every length 0..40 and a few near TILE at offsets of every
    residue mod 4: the realigned head and tail of each run."""
    rng = np.random.default_rng(planes)
    lengths = np.r_[np.arange(41), [TILE - 1, TILE, 127, 128, 129, 511, 512, 513]]
    counts = torch.from_numpy(rng.permutation(np.tile(lengths, 4)).astype(np.int32)).to(dev)
    ntiles = counts.numel()
    scratch = torch.arange(planes * ntiles * TILE, dtype=torch.int32, device=dev).view(
        planes, -1)
    scratch = scratch if planes == 2 else scratch[0]
    offsets = fused.tile_offsets(counts)
    total = int(offsets[-1])
    assert len({int(o) % 4 for o in offsets[:-1]}) == 4
    assert torch.equal(fused.tile_append(scratch, counts, offsets, total),
                       pipeline.tile_append_plain(scratch, counts, offsets, total, TILE))


@pytest.mark.parametrize("planes", [1, 2])
def test_tile_append_total_read_in_a_graph(dev, planes):
    """total=None captured in a CUDA graph (the grid fixed at capture) and
    replayed beside eager calls on new counts and runs of the same tile
    count: each replay's first planes * total ints equal the eager call's
    planes, and nothing past them is written."""
    ntiles = _append_ntiles(dev, "grid+1")
    scratch, counts, offsets, _ = _append_case(dev, ntiles, planes, "random", 7)
    fused.tile_append(scratch, counts, offsets, None)  # set-up, outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fused.tile_append(scratch, counts, offsets, None)
    sentinel = 0x5A5A5A5A
    for seed in range(4):
        s2, c2, o2, total = _append_case(dev, ntiles, planes, ("random", "full", "zero")[seed % 3],
                                         100 + seed)
        scratch.copy_(s2)
        counts.copy_(c2)
        offsets.copy_(o2)
        out.fill_(sentinel)
        graph.replay()
        eager = fused.tile_append(scratch, counts, offsets, total)
        torch.cuda.synchronize()
        assert torch.equal(out[:planes * total].view(*scratch.shape[:-1], total), eager)
        assert bool((out[planes * total:] == sentinel).all())


def test_tile_append_launch_failure_raises(dev, monkeypatch):
    """A failed launch raises; nothing falls back to the plain version, and
    the launch is not counted."""
    from simd_minimizers_tpu_torch.ops import _build

    scratch, counts, offsets, total = _append_case(dev, 3, 1, "random", 3)
    fused._library(scratch.device)  # the card's set-up, before the library fails

    class Failing:
        @staticmethod
        def smt_tile_append(*args):
            return 1

    monkeypatch.setattr(_build, "library", lambda: Failing)
    before = fused.LAUNCHES["tile_append"]
    with pytest.raises(RuntimeError, match="tile_append failed"):
        fused.tile_append(scratch, counts, offsets, total)
    assert fused.LAUNCHES["tile_append"] == before


def test_tile_append_grid_from_the_card(dev):
    """The persistent grid is the SMs times the blocks an SM holds, and a
    launch starts no more blocks than its tiles need."""
    blocks, warps = fused.append_grid(dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert warps == 8 and blocks % sms == 0 and blocks >= sms
    assert fused.append_blocks(1, blocks, warps) == 1
    assert fused.append_blocks(131_072, blocks, warps) == blocks


@pytest.mark.parametrize("canonical", [False, True])
def test_widest_geometry(dev, canonical):
    # the largest w the gate admits: TILE + w = 2^16, the 16-bit column key
    # (the large-w route keeps shared memory well inside a block's)
    k = 21
    w = max(w for w in range(1, 1 << 16, 2 if canonical else 1)
            if fused.fused_supported(k, w, canonical))
    assert not fused.fused_supported(k, w + 2, canonical) and TILE + w + 2 > 1 << 16
    codes = np.random.default_rng(w).integers(0, 4, 2 * TILE + 17 + k + w - 2, dtype=np.uint8)
    got, want = _both(codes, k, w, NtHasher(k, canonical=canonical), dev)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got.astype(np.uint32), _oracle(codes, k, w, NtHasher(
        k, canonical=canonical)))
    assert got.size >= 1


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
                                      (CLOSED, False), (CLOSED, True), (OPEN, True),
                                      (SKM, True)])
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
                                      (CLOSED, True), (SKM, True)])
@pytest.mark.parametrize("canonical", [False, True])
def test_widest_geometry_modes(dev, mode, amb, canonical):
    # the widest w of each instance: TILE + w = 2^16 with the ambiguity
    # words and the second staging plane in shared memory
    k, step = 21, 2 if canonical else 1
    w = max(w for w in range(1, 1 << 16, step)
            if fused.fused_supported(k, w, canonical, mode, amb))
    assert not fused.fused_supported(k, w + step, canonical, mode, amb)
    n = 2 * TILE + 17 + k + w - 2
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
    """The widest w the gate admits runs with the fold's tables in shared
    memory too (2 KB for text, none for antilex)."""
    k = 21
    step = 2 if canonical else 1
    kind = "antilex" if cls is AntiLexHasher else "mul"
    w = max(w for w in range(1, 1 << 16, step)
            if fused.fused_supported(k, w, canonical, mode, amb, text, kind))
    assert not fused.fused_supported(k, w + step, canonical, mode, amb, text, kind)
    n = 2 * TILE + 17 + k + w - 2
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


# -- the drivers: offsets, code bytes, spans, records, batches -----------


@pytest.mark.parametrize("mode,amb", [(pipeline.MODE_MINIMIZERS, False), (SKM, True),
                                      (CLOSED, True), (OPEN, False)])
@pytest.mark.parametrize("offset", [0, (1 << 31) + 12_345, (1 << 32) - 10**5])
def test_offset_and_code_bytes_vs_plain(dev, mode, amb, offset):
    """The u32 offset near 2^32 and the one-code-per-byte input (bytes
    above 3 keep their low two bits), each kernel against its plain version
    and the oracle."""
    k, w = 21, 11
    rng = np.random.default_rng(offset % 977)
    codes = rng.integers(0, 4, 3 * TILE + 50, dtype=np.uint8)
    noisy = codes | (rng.integers(0, 64, codes.size, dtype=np.uint8) << 2)
    mask = _clustered_mask(codes.size, k + w - 1, rng) if amb else None
    h = NtHasher(k, canonical=True)
    (kind, canonical, rot), tables = convert.hasher_tensors(convert.hasher_from(h), dev)
    plane = None if mask is None else convert.ambiguity_plane(mask, codes.size, dev)
    ref = _oracle(codes, k, w, h, mode, mask)
    ref = tuple(r.astype(np.uint64) + offset for r in (ref if mode == SKM else (ref,)))
    for chars, kw in ((convert.code_bytes(noisy, dev), {"byte_codes": True}),
                      (convert.packed_words(PackedSeqVec.from_codes(codes), dev), {})):
        args = (chars, codes.size, k, w, tables, rot, canonical, mode, plane)
        got = fused.fused_sketch(*args, offset=offset, **kw)
        want = pipeline.run_pipeline(*args, offset=offset, **kw)
        got, want = ((x,) if mode != SKM else x for x in (got, want))
        for g, p, r in zip(got, want, ref, strict=True):
            assert torch.equal(g, p)
            np.testing.assert_array_equal(g.cpu().numpy().view(np.uint32), r)


@pytest.mark.parametrize("mode", pipeline.MODES)
@pytest.mark.parametrize("masked", [False, True])
def test_sketch_long_many_seams(dev, mode, masked):
    """sketch_long over 2e6 chars in 64 Ki-char spans (about 31 seams), with
    a mask, eager and in waves: bit-equal to one launch, which equals its
    plain version, and to the oracle."""
    k, w, n = 21, 11, 2_000_000
    rng = np.random.default_rng(31 + masked)
    codes = rng.integers(0, 4, n, dtype=np.uint8)
    mask = _clustered_mask(n, k + w - 1, rng) | (rng.random(n) < 1e-4) if masked else None
    h = convert.hasher_from(NtHasher(k, canonical=True))
    chars = convert.packed_words(PackedSeqVec.from_codes(codes), dev)
    plane = None if mask is None else convert.ambiguity_plane(mask, n, dev)
    (kind, canonical, rot), tables = convert.hasher_tensors(h, dev)
    one = fused.fused_sketch(chars, n, k, w, tables, rot, canonical, mode, plane)
    plain = pipeline.run_pipeline(chars, n, k, w, tables, rot, canonical, mode, plane)
    one, plain = ((x,) if mode != SKM else x for x in (one, plain))
    for budget in (0, 1 << 30):
        got = spans.sketch_long(chars, n, k, w, h, mode, plane, span_chars=1 << 16,
                                wave_bytes=budget)
        torch.cuda.synchronize()
        for g, o, p in zip(got if mode == SKM else (got,), one, plain, strict=True):
            assert torch.equal(g, o) and torch.equal(o, p)
    ref = _oracle(codes, k, w, NtHasher(k, canonical=True), mode, mask)
    for o, r in zip(one, ref if mode == SKM else (ref,), strict=True):
        np.testing.assert_array_equal(o.cpu().numpy().view(np.uint32), r)


def test_builder_run_long_route(dev, monkeypatch):
    """Builder.run on the card in spans (spans.SPAN_CHARS lowered), with its
    pinned download: equal to the one-launch run and the oracle."""
    seq = PackedSeqVec.random(1_000_000, np.random.default_rng(8))
    mask = np.random.default_rng(9).random(1_000_000) < 1e-3
    b = api.canonical_minimizers(21, 11)
    want = b.run(seq, ambiguous=mask, device=dev).positions
    monkeypatch.setattr(spans, "SPAN_CHARS", 1 << 18)
    got = b.run(seq, ambiguous=mask, device=dev).positions
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, b.run_scalar(seq, ambiguous=mask).positions)


@pytest.mark.parametrize("mode", [pipeline.MODE_MINIMIZERS, SKM, CLOSED])
def test_sketch_records_vs_plain_and_oracle(dev, mode):
    """Records of every size (sub-window to several spans), with masks on
    all but super-k-mers, through the kernels: equal to the plain version
    of each record on the card and to the oracle."""
    from simd_minimizers_tpu_torch.ops import backend

    k, w = 21, 11
    rng = np.random.default_rng(40)
    lens = [0, 30, 31, 4096, 70_001, 300_000] + list(rng.integers(100, 3000, 12))
    recs = [rng.integers(0, 4, int(n), dtype=np.uint8) for n in lens]
    ambs = None if mode == SKM else [None if i % 3 == 0 else (rng.random(r.size) < 0.005)
                                     for i, r in enumerate(recs)]
    jh = NtHasher(k, canonical=True)
    h = convert.hasher_from(jh)
    (kind, canonical, rot), tables = convert.hasher_tensors(h, dev)
    got_span = spans.sketch_records(recs, k, w, h, mode, ambs, device=dev, span_chars=50_000)
    got_routed = backend.sketch_records(recs, k, w, h, mode, ambs, device=dev)
    for i, r in enumerate(recs):
        a = None if ambs is None else ambs[i]
        chars = convert.code_bytes(r, dev)
        plane = None if a is None else convert.ambiguity_plane(a, r.size, dev)
        plain = pipeline.run_pipeline(chars, r.size, k, w, tables, rot, canonical, mode, plane,
                                      byte_codes=True)
        plain = tuple(p.cpu().numpy().view(np.uint32) for p in (plain if mode == SKM
                                                                else (plain,)))
        ref = _oracle(r, k, w, jh, mode, a) if r.size >= k + w - 1 else (
            np.zeros(0, np.uint32),) * len(plain)
        ref = ref if isinstance(ref, tuple) else (ref,)
        for got in (got_span[i], got_routed[i]):
            for g, p, o in zip(got if mode == SKM else (got,), plain, ref, strict=True):
                np.testing.assert_array_equal(g, p)
                np.testing.assert_array_equal(g, o)


def test_pinned_downloads_reused_across_waves(dev):
    """Many small waves (a budget below one launch) recycle pinned buffers
    while later launches run; two runs agree with each other and with a
    one-wave run, compared after torch.cuda.synchronize()."""
    k, w = 21, 11
    rng = np.random.default_rng(41)
    recs = [rng.integers(0, 4, int(n), dtype=np.uint8) for n in rng.integers(50_000, 400_000, 40)]
    h = convert.hasher_from(NtHasher(k, canonical=True))
    runs = [spans.sketch_records(recs, k, w, h, device=dev, span_chars=1 << 17, wave_bytes=b)
            for b in (1, 1, 1 << 34)]
    torch.cuda.synchronize()
    for other in runs[1:]:
        for a, b in zip(runs[0], other, strict=True):
            np.testing.assert_array_equal(a, b)
    for r, g in zip(recs[:3], runs[0]):
        np.testing.assert_array_equal(g, _oracle(r, k, w, NtHasher(k, canonical=True)))


@pytest.mark.parametrize("mode,masked", [(pipeline.MODE_MINIMIZERS, False),
                                         (pipeline.MODE_MINIMIZERS, True), (SKM, False),
                                         (OPEN, True)])
def test_run_batch_vs_plain_and_oracle(dev, mode, masked):
    """Builder.run_batch on the card (every launch runs an instance with the
    padding plane): equal to the plain pipeline of the same launches on the
    card and to the per-read oracle."""
    from simd_minimizers_tpu_torch.ops import batch

    k, w = 21, 11
    rng = np.random.default_rng(42 + masked)
    lens = list(rng.integers(0, 3000, 300)) + [10_000, 150, 150, 31, 30]
    acgt = np.frombuffer(b"ACGT", np.uint8)
    reads = [acgt[rng.integers(0, 4, int(n))].tobytes() for n in lens]
    ambs = [(rng.random(len(r)) < 0.01).astype(np.uint8) for r in reads] if masked else None
    syncmer = 2 if mode == OPEN else 0
    b = api.Builder(k, w, mode != OPEN, syncmer=syncmer)
    if mode == SKM:
        b = b.super_kmers()
    before = dict(fused.LAUNCHES)
    got = b.run_batch(reads, ambiguous=ambs, device=dev)
    name = fused.instance_name(b.canonical, mode, True)
    assert fused.LAUNCHES[name] > before[name]
    codes = [np.frombuffer(r, np.uint8) >> 1 & 3 for r in reads]
    plain = batch.sketch_batch(codes, k, w, b._resolved_hasher(), mode, ambs, dna=True,
                               device=dev, backend="pipeline")
    for g, p in zip(got, plain, strict=True):
        np.testing.assert_array_equal(g, p)
    rid, *planes = got
    h = NtHasher(k, canonical=b.canonical)
    for i, c in enumerate(codes[:120]):
        if c.size < k + w - 1:
            assert not np.any(rid == i)
            continue
        want = _oracle(c, k, w, h, mode, None if ambs is None else ambs[i])
        for p, r in zip(planes, want if mode == SKM else (want,), strict=True):
            np.testing.assert_array_equal(p[rid == i], r, err_msg=f"read {i}")


@pytest.mark.parametrize("L", [1, 2, 3, 5, 8, 15, 16, 31, 33, 63, 100, 150, 151, 255, 497, 498,
                               512, 513, 1000, 4097])
@pytest.mark.parametrize("masked", [False, True])
def test_ascii_slots_vs_plain(dev, L, masked):
    """fused.ascii_slots on the card against its plain version on the same
    card: random bytes over all 256 values, ACGTacgt rows with a text row
    among them, and all-ACGT rows; the bucketed stride and wider ones (a
    slot's edge off every alignment), row counts that end a launch
    mid-word, a range of rows taken out of a larger upload; rows past
    about 32 x 16 B read twice."""
    from simd_minimizers_tpu_torch.ops import batch

    rng = np.random.default_rng(L * 2 + masked)
    mixed = np.frombuffer(b"ACGTacgt", np.uint8)
    for rows_n, stride in [(1, batch._stride_bucket(L + 1)), (37, batch._stride_bucket(L + 1)),
                           (53, L + 1), (29, L + 3 + int(rng.integers(0, 21)))]:
        for alphabet in ("bytes", "acgt, one text row", "acgt"):
            if alphabet == "bytes":
                rows = rng.integers(0, 256, (rows_n, L), dtype=np.uint8)
            else:
                rows = mixed[rng.integers(0, 8, (rows_n, L))]
                if alphabet != "acgt":
                    rows[rows_n // 2, int(rng.integers(0, L))] = ord("N")
            amb = ((rng.random((rows_n, L)) < 0.05) * rng.integers(1, 256, (rows_n, L))
                   ).astype(np.uint8) if masked else None
            for r0, r1 in [(0, rows_n), (rows_n // 3, rows_n)]:
                t = torch.from_numpy(rows[r0:r1].copy()).to(dev)
                a = None if amb is None else torch.from_numpy(amb[r0:r1].copy()).to(dev)
                got_dna = torch.ones(1, dtype=torch.int32, device=dev)
                want_dna = torch.ones(1, dtype=torch.int32, device=dev)
                before = fused.LAUNCHES["ascii_slots"]
                got = fused.ascii_slots(t, stride, got_dna, a)
                want = pipeline.ascii_slots_plain(t, stride, want_dna, a)
                torch.cuda.synchronize()
                assert fused.LAUNCHES["ascii_slots"] == before + 1
                what = f"{alphabet}, rows {r0}..{r1} of {rows_n}, stride {stride}"
                for g, w in zip(got, want, strict=True):
                    np.testing.assert_array_equal(g.cpu().numpy(), w.cpu().numpy(), err_msg=what)
                assert int(got_dna.item()) == int(want_dna.item()), what


@pytest.mark.parametrize("mode", [pipeline.MODE_MINIMIZERS, SKM, OPEN])
@pytest.mark.parametrize("case", ["acgt", "one N", "masks", "split launches", "view"])
def test_run_batch_matrix_route_on_card(dev, mode, case, monkeypatch):
    """Builder.run_batch of a (B, L) ASCII matrix on the card (ascii_slots,
    then the kernels) == the same rows as a list on the card (folded on the
    host) == the matrix route on the CPU (the plain versions)."""
    from simd_minimizers_tpu_torch.ops import batch

    rng = np.random.default_rng(len(case) * 3 + len(mode))
    rows = np.frombuffer(b"ACGTacgt", np.uint8)[rng.integers(0, 8, (3001, 150))]
    masks = None
    if case == "one N":
        rows[1234, 77] = ord("N")
    elif case == "masks" and mode != SKM:
        masks = (rng.random(rows.shape) < 0.01).astype(np.uint8)
    elif case == "split launches":
        monkeypatch.setattr(batch, "MAX_LAUNCH_CHARS", 1000 * 160)
    elif case == "view":
        rows = rows[::2, 3:140]
    syncmer = 2 if mode == OPEN else 0
    b = api.Builder(21, 11, mode != OPEN, syncmer=syncmer)
    if mode == SKM:
        b = b.super_kmers()
    before = fused.LAUNCHES["ascii_slots"]
    got = b.run_batch(rows, ambiguous=masks, device=dev)
    assert fused.LAUNCHES["ascii_slots"] == before + (4 if case == "split launches" else 1)
    listed = b.run_batch([r.tobytes() for r in rows],
                         ambiguous=None if masks is None else list(masks), device=dev)
    plain = b.run_batch(rows, ambiguous=masks, device="cpu")
    for g, h, p in zip(got, listed, plain, strict=True):
        np.testing.assert_array_equal(g, h)
        np.testing.assert_array_equal(g, p)


def test_wall_split_on_card(dev):
    """utils/profiling.split_wall around run_batch and sketch_records on the
    card: the download is a stage there, and the results equal a run
    without the split."""
    from simd_minimizers_tpu_torch.ops import backend
    from simd_minimizers_tpu_torch.utils import profiling

    k, w = 21, 11
    rng = np.random.default_rng(43)
    recs = [rng.integers(0, 4, int(n), dtype=np.uint8) for n in rng.integers(100, 5000, 20)]
    recs.append(rng.integers(0, 4, 300_000, dtype=np.uint8))
    ambs = [(rng.random(r.size) < 0.01).astype(np.uint8) for r in recs]
    h = convert.hasher_from(NtHasher(k, canonical=True))
    b = api.canonical_minimizers(k, w)
    reads = [np.frombuffer(b"ACGT", np.uint8)[r].tobytes() for r in recs]

    # the long record takes the span route, the others the batch route
    def both():
        return (backend.sketch_records(recs, k, w, h, pipeline.MODE_MINIMIZERS, ambs,
                                       device=dev, batch_max_bp=100_000),
                b.run_batch(reads, device=dev))

    want = both()
    with profiling.split_wall() as parts:
        got = both()
    for g_run, w_run in zip(got, want, strict=True):
        for g, p in zip(g_run, w_run, strict=True):
            np.testing.assert_array_equal(g, p)
    assert {"upload", "mask packing", "kernels", "download", "seam merge", "split by record",
            "fold reads to codes", "slot fill"} <= set(parts)


# -- large w, the short-sequence sketcher, sharded and multi-process -------

LARGE_W = [128, 1000, 4095, 4096, 5001, 21_721, 21_723, 32_767, 61_439]


@pytest.mark.parametrize("w", LARGE_W)
@pytest.mark.parametrize("canonical", [False, True])
def test_large_w_vs_plain_and_oracle(dev, w, canonical):
    """The large-w route in every mode family, with and without a mask, on
    2-bit DNA (nt) and text (mul), across tile seams: against the plain
    version on the card and the oracle."""
    k = 21 if (w % 2 or not canonical) else 22
    l = k + w - 1
    rng = np.random.default_rng(w + canonical)
    n = 2 * TILE + 17 + l - 1
    for text, cls in ((False, NtHasher), (True, MulHasher)):
        codes = rng.integers(0, 256 if text else 4, n, dtype=np.uint8)
        h = cls(k, canonical=canonical)
        for mode, amb in ((pipeline.MODE_MINIMIZERS, None), (SKM, None), (CLOSED, None),
                          (pipeline.MODE_MINIMIZERS, rng.random(n) < 2e-5),
                          (CLOSED, _clustered_mask(n, l, rng))):
            got, want = _both(codes, k, w, h, dev, mode, amb, text=text)
            _assert_planes(got, want, _oracle(codes, k, w, h, mode, amb))


@pytest.mark.parametrize("w", [16, 64, 127, 128, 1001, 4095])
@pytest.mark.parametrize("canonical", [False, True])
def test_routes_agree(dev, w, canonical, monkeypatch):
    """Both routes at the same w (the threshold moved below and above it):
    bit-equal to each other and to the plain version, every instance."""
    k = 21 if (w % 2 or not canonical) else 22
    rng = np.random.default_rng(w)
    n = 3 * TILE + 5 + k + w - 2
    codes = rng.integers(0, 4, n, dtype=np.uint8)
    mask = _clustered_mask(n, k + w - 1, rng)
    h = NtHasher(k, canonical=canonical)
    for mode, amb in ((pipeline.MODE_MINIMIZERS, None), (SKM, None), (SKM, mask),
                      (OPEN if w % 2 else CLOSED, mask)):
        runs = []
        for threshold in (1, 1 << 16):
            monkeypatch.setattr(fused, "LARGE_W_MIN", threshold)
            runs.append(_both(codes, k, w, h, dev, mode, amb))
        _assert_planes(runs[0][0], runs[1][0], runs[0][1])
        _assert_planes(runs[0][0], runs[0][1], runs[1][1])


def test_large_w_offset_and_code_bytes(dev):
    """The large-w route with a u32 offset near 2^32 and code bytes."""
    k, w = 21, 32_767
    rng = np.random.default_rng(5)
    codes = rng.integers(0, 4, 2 * TILE + k + w, dtype=np.uint8)
    h = NtHasher(k, canonical=True)
    (kind, canonical, rot), tables = convert.hasher_tensors(convert.hasher_from(h), dev)
    offset = (1 << 32) - 3000
    args = (convert.code_bytes(codes | 0xF0, dev), codes.size, k, w, tables, rot, canonical)
    got = fused.fused_sketch(*args, offset=offset, byte_codes=True)
    want = pipeline.run_pipeline(*args, offset=offset, byte_codes=True)
    assert torch.equal(got, want)
    np.testing.assert_array_equal(got.cpu().numpy().view(np.uint32),
                                  (_oracle(codes, k, w, h).astype(np.uint64) + offset)
                                  .astype(np.uint32))


def test_large_w_builders_on_card(dev):
    """Builder.run, run_skip_ambiguous_windows and run_batch at w = 32,767."""
    k, w = 21, 32_767
    rng = np.random.default_rng(6)
    seq = PackedSeqVec.random(200_000, rng)
    amb = np.zeros(200_000, bool)
    amb[[70_000, 150_000]] = True
    for b in (api.canonical_minimizers(k, w), api.minimizers(k, w).super_kmers(),
              api.closed_syncmers(k, w)):
        out, want = b.run(seq, device=dev), b.run_scalar(seq)
        np.testing.assert_array_equal(out.positions, want.positions)
    b = api.canonical_minimizers(k, w)
    np.testing.assert_array_equal(
        b.run_skip_ambiguous_windows_once(PackedNSeqVec(seq, amb), device=dev),
        b.run_scalar(seq, ambiguous=amb).positions)
    reads = [seq.slice(0, 40_000), seq.slice(1000, 120_000), seq.slice(5, 20)]
    actg = np.frombuffer(b"ACTG", np.uint8)  # code order
    rid, pos = b.run_batch([actg[r.codes()].tobytes() for r in reads], device=dev)
    for i, r in enumerate(reads):
        np.testing.assert_array_equal(pos[rid == i], b.run_scalar_once(r))


@pytest.mark.parametrize("mode", pipeline.MODES)
def test_short_seq_sketcher_on_card(dev, mode):
    """One captured graph per sketcher: sketch_many over lengths 0..max_chars
    against the oracle, each replay counted once per kernel, the capture
    not at all; longer inputs refused."""
    from simd_minimizers_tpu_torch.ops.device_sketcher import ShortSeqSketcher

    k, w = (21, 11) if mode != SKM else (5, 7)
    canonical = mode != OPEN
    h = NtHasher(k, canonical=canonical)
    before = dict(fused.LAUNCHES)
    sk = ShortSeqSketcher(k, w, convert.hasher_from(h), mode, device=dev)
    assert fused.LAUNCHES == before and sk.max_chars == 8192 + k + w - 2
    rng = np.random.default_rng(17)
    lens = [0, k + w - 2, k + w - 1, 64, 1024, 4096 + 30, 8192, sk.max_chars]
    lens += list(rng.integers(1, sk.max_chars + 1, 40))
    seqs = [rng.integers(0, 4, int(n), dtype=np.uint8) for n in lens]
    outs = sk.sketch_many(seqs)
    ran = sum(s.size >= k + w - 1 for s in seqs)
    name = fused.instance_name(canonical, mode, False)
    assert fused.LAUNCHES[name] - before[name] == ran
    assert fused.LAUNCHES["tile_append"] - before["tile_append"] == ran
    for s, got in zip(seqs, outs, strict=True):
        want = _oracle(s, k, w, h, mode) if s.size >= k + w - 1 else (
            (np.zeros(0, np.uint32),) * 2 if mode == SKM else np.zeros(0, np.uint32))
        for g, p in zip(got if mode == SKM else (got,), want if mode == SKM else (want,),
                        strict=True):
            np.testing.assert_array_equal(g, p)
    got = sk.harvest(sk.launch(seqs[6], offset=(1 << 32) - 10))
    want = _oracle(seqs[6], k, w, h, mode)
    np.testing.assert_array_equal((got[0] if mode == SKM else got),
                                  ((want[0] if mode == SKM else want).astype(np.uint64)
                                   + (1 << 32) - 10).astype(np.uint32))
    with pytest.raises(AssertionError):
        sk.launch(np.zeros(sk.max_chars + 1, np.uint8))


def test_short_seq_measure_floor(dev):
    from simd_minimizers_tpu_torch.ops.device_sketcher import ShortSeqSketcher

    h = convert.hasher_from(NtHasher(21, canonical=True))
    codes = np.random.default_rng(3).integers(0, 4, 8192, dtype=np.uint8)
    res = ShortSeqSketcher(21, 11, h, donate=False, device=dev).measure_floor(codes, m=20)
    assert {"per_call_us", "sync_us", "device_floor_us", "replay_us"} <= set(res)
    assert all(v > 0 for v in res.values())
    assert "device_floor_us" not in ShortSeqSketcher(21, 11, h, device=dev).measure_floor(
        codes, m=5, probes=1)


@pytest.mark.parametrize("mode,masked", [(pipeline.MODE_MINIMIZERS, False),
                                         (pipeline.MODE_MINIMIZERS, True), (SKM, False),
                                         (CLOSED, True), (OPEN, False)])
def test_sharded_on_one_card(dev, mode, masked):
    """fused_sharded_sketch over ["cuda:0"] and ["cuda:0"] * 4 (and 7 shards
    of a short input, some empty): equal to one launch and the oracle."""
    from simd_minimizers_tpu_torch.parallel import shard

    k, w = 21, 11
    rng = np.random.default_rng(50 + masked)
    h = NtHasher(k, canonical=mode != OPEN)
    for n in (300_000, 40):
        codes = rng.integers(0, 4, n, dtype=np.uint8)
        amb = (rng.random(n) < 1e-3) if masked else None
        want = _oracle(codes, k, w, h, mode, amb)
        for mesh in ([dev], [dev] * 4, [dev] * 7):
            got = shard.fused_sharded_sketch(codes, k, w, convert.hasher_from(h), mode, amb,
                                             mesh=mesh)
            for g, p in zip(got if mode == SKM else (got,), want if mode == SKM else (want,),
                            strict=True):
                np.testing.assert_array_equal(g, p)


def test_multihost_nccl_world_of_one(dev):
    """multihost_sketch under an NCCL group of one process, and the ragged
    all-gather of two planes over it."""
    import datetime
    import socket

    import torch.distributed as dist

    from simd_minimizers_tpu_torch.parallel import multihost

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    torch.cuda.set_device(torch.device("cuda", 0))
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", world_size=1,
                            rank=0, timeout=datetime.timedelta(seconds=120))
    try:
        rng = np.random.default_rng(60)
        codes = rng.integers(0, 4, 100_000, dtype=np.uint8)
        h = NtHasher(21, canonical=True)
        got = multihost.multihost_sketch(codes, 21, 11, convert.hasher_from(h), SKM)
        for g, p in zip(got, _oracle(codes, 21, 11, h, SKM), strict=True):
            np.testing.assert_array_equal(g, p)
        a, b = np.arange(7, dtype=np.uint32), np.arange(100, 107, dtype=np.uint32)
        parts, aux = multihost._allgather_ragged_planes([a, b], 1)
        np.testing.assert_array_equal(parts[0], a)
        np.testing.assert_array_equal(aux[0], b)
    finally:
        dist.destroy_process_group()


# -- the stored route: conflict-free keys and doubling passes ---------------

STORED_W = [1, 2, 3, 4, 5, 7, 8, 9, 15, 16, 17, 31, 32, 33, 63]


@pytest.mark.parametrize("w", STORED_W)
@pytest.mark.parametrize("canonical", [False, True])
def test_stored_route_w_sweep(dev, w, canonical):
    """chip_smoke.py's sweep at a small size: every instance (each mode
    family with and without an ambiguity plane) at each w of the stored
    route, across tile seams, against the plain version and the oracle."""
    k = 21 if (w % 2 or not canonical) else 22
    l = k + w - 1
    if w >= fused.LARGE_W_MIN:
        pytest.skip(f"w = {w} takes the large-w route (LARGE_W_MIN = {fused.LARGE_W_MIN})")
    assert fused.sub_tile(k, w, canonical) == 0
    rng = np.random.default_rng(w * 2 + canonical)
    n = 3 * TILE + 17 + l - 1
    codes = rng.integers(0, 4, n, dtype=np.uint8)
    h = NtHasher(k, canonical=canonical)
    modes = [pipeline.MODE_MINIMIZERS, SKM, CLOSED] + ([OPEN] if w % 2 else [])
    for mode in modes:
        for amb in (None, _clustered_mask(n, l, rng) | (rng.random(n) < 1e-3)):
            got, want = _both(codes, k, w, h, dev, mode, amb)
            _assert_planes(got, want, _oracle(codes, k, w, h, mode, amb))


@pytest.mark.parametrize("tiles", [1, 2, 3])
@pytest.mark.parametrize("d", [-1, 0, 1])
@pytest.mark.parametrize("k,w,canonical", [(21, 11, True), (5, 7, False), (22, 16, True),
                                           (21, 1, True), (21, 63, False)])
def test_stored_route_tile_edges(dev, tiles, d, k, w, canonical):
    """n = l - 1 + 4096 t + d: the last tile ends one window before, at, or
    one window past a tile seam (and its chars at the end of the input)."""
    l = k + w - 1
    n = l - 1 + TILE * tiles + d
    codes = np.random.default_rng(n).integers(0, 4, n, dtype=np.uint8)
    h = NtHasher(k, canonical=canonical)
    for mode in (pipeline.MODE_MINIMIZERS, SKM, CLOSED):
        got, want = _both(codes, k, w, h, dev, mode)
        _assert_planes(got, want, _oracle(codes, k, w, h, mode))


@pytest.mark.parametrize("k,w", [(64, 5), (1001, 5), (1000, 2), (64, 1), (4095, 3)])
@pytest.mark.parametrize("canonical", [False, True])
def test_stored_route_large_k(dev, k, w, canonical):
    """Large k with small w: the strand count's popc over the T/G plane
    spans many words, the hash runs start with O(k) loops."""
    if canonical and (k + w) % 2:
        k += 1
    l = k + w - 1
    rng = np.random.default_rng(k + w)
    n = 2 * TILE + 17 + l - 1
    codes = rng.integers(0, 4, n, dtype=np.uint8)
    h = NtHasher(k, canonical=canonical)
    for mode, amb in ((pipeline.MODE_MINIMIZERS, None), (SKM, None),
                      (CLOSED, _clustered_mask(n, l, rng))):
        got, want = _both(codes, k, w, h, dev, mode, amb)
        _assert_planes(got, want, _oracle(codes, k, w, h, mode, amb))


@pytest.mark.parametrize("cls", [MulHasher, AntiLexHasher])
@pytest.mark.parametrize("w", [1, 2, 8, 11, 33])
@pytest.mark.parametrize("canonical", [False, True])
def test_stored_route_text_hashers(dev, cls, w, canonical):
    """Text with the mul and antilex hashers on the stored route, with a
    mask and with low-entropy runs whose keys tie."""
    k = 21 if (w % 2 or not canonical) else 22
    l = k + w - 1
    rng = np.random.default_rng(w * 3 + canonical)
    n = 2 * TILE + 17 + l - 1
    text = rng.integers(32, 127, n, dtype=np.uint8)
    runs = np.repeat(rng.integers(0, 256, n), rng.integers(1, 30, n))[:n].astype(np.uint8)
    h = cls(k, canonical=canonical)
    for codes in (text, runs):
        for mode, amb in ((pipeline.MODE_MINIMIZERS, None), (SKM, None),
                          (CLOSED, rng.random(n) < 1e-3)):
            got, want = _both(codes, k, w, h, dev, mode, amb, text=True)
            _assert_planes(got, want, _oracle(codes, k, w, h, mode, amb))


@pytest.mark.parametrize("w", [1, 5, 11, 16])
@pytest.mark.parametrize("canonical", [False, True])
def test_stored_route_meta_launch(dev, w, canonical):
    """The length and offset read on the card (`meta`, a CUDA-graph
    capture's launch) over a buffer sized for more chars: equal to the
    plain version at the meta length and to the oracle plus the offset."""
    k = 21 if (w % 2 or not canonical) else 22
    l = k + w - 1
    rng = np.random.default_rng(w + 100 * canonical)
    cap = 2 * TILE + l - 1
    h = NtHasher(k, canonical=canonical)
    (kind, can, rot), tables = convert.hasher_tensors(convert.hasher_from(h), dev)
    for n, offset in ((cap, 0), (TILE + l + 5, 12_345), (l, (1 << 32) - 7), (l - 1, 3)):
        codes = rng.integers(0, 4, cap, dtype=np.uint8)
        codes[n:] = 0
        chars = convert.code_bytes(codes, dev)
        meta = torch.tensor([n, offset - (1 << 32) if offset >= 1 << 31 else offset],
                            dtype=torch.int32, device=dev)
        scratch, counts = fused.minimizer_tiles(chars, cap, k, w, tables, rot, can,
                                                meta=meta, kind=kind, byte_codes=True)
        plain_scratch, plain_counts = pipeline.minimizer_tiles_plain(
            chars[:n], n, k, w, tables, rot, can, TILE, offset=offset, byte_codes=True)
        got = fused.tile_append(scratch, counts, fused.tile_offsets(counts), None)
        total = int(plain_counts.sum())
        want = pipeline.tile_append_plain(plain_scratch, plain_counts,
                                          pipeline.tile_offsets_plain(plain_counts), total, TILE)
        assert torch.equal(got[:total], want)
        ref = (_oracle(codes[:n], k, w, h).astype(np.uint64) + offset).astype(np.uint32) if (
            n >= l) else np.zeros(0, np.uint32)
        np.testing.assert_array_equal(got[:total].cpu().numpy().view(np.uint32), ref)


@pytest.mark.parametrize("side", [-1, 0, 1])
@pytest.mark.parametrize("canonical", [False, True])
def test_routes_either_side_of_threshold(dev, side, canonical, monkeypatch):
    """At LARGE_W_MIN - 1 (stored), LARGE_W_MIN and LARGE_W_MIN + 1
    (large-w): the route the rule picks, and both routes forced, bit-equal
    to each other, to the plain version and the oracle."""
    w = fused.LARGE_W_MIN + side
    k = 21 if (w % 2 or not canonical) else 22
    assert (fused.sub_tile(k, w, canonical) == 0) == (side < 0)
    rng = np.random.default_rng(w + canonical)
    n = 2 * TILE + 5 + k + w - 2
    codes = rng.integers(0, 4, n, dtype=np.uint8)
    h = NtHasher(k, canonical=canonical)
    for mode, amb in ((pipeline.MODE_MINIMIZERS, None), (SKM, None),
                      (CLOSED, _clustered_mask(n, k + w - 1, rng))):
        ref = _oracle(codes, k, w, h, mode, amb)
        runs = [_both(codes, k, w, h, dev, mode, amb)]
        for threshold in (1, 1 << 16):
            monkeypatch.setattr(fused, "LARGE_W_MIN", threshold)
            runs.append(_both(codes, k, w, h, dev, mode, amb))
        monkeypatch.undo()
        for got, want in runs:
            _assert_planes(got, want, ref)


@pytest.mark.parametrize("slack", [0, 1, 2, 3, 8])
@pytest.mark.parametrize("w", [3, 11, 33, 63])
def test_stored_route_any_pass_count(dev, slack, w):
    """Every pass count from none (w loads per window) to the most (two
    loads), `slack` short of the most, gives the same result: the rule only
    trades passes for loads."""
    passes = max(0, w.bit_length() - 1 - slack)
    k = 21 if w % 2 else 22
    rng = np.random.default_rng(w + slack)
    n = 2 * TILE + 33 + k + w - 2
    codes = rng.integers(0, 4, n, dtype=np.uint8)
    for canonical in (False, True):
        h = NtHasher(k, canonical=canonical)
        args, kw = _args(codes, k, w, h, dev)
        scratch, counts = fused.minimizer_tiles(*args, **kw, passes=passes)
        got = fused._fused_harvest((scratch, counts, fused.tile_offsets(counts)),
                                   pipeline.MODE_MINIMIZERS)
        want = pipeline.run_pipeline(*args, **kw)
        _assert_planes(got.cpu().numpy(), want.cpu().numpy(), _oracle(codes, k, w, h))


# -- the large-w route's pre-pass (csrc/top16.cu) ----------------------------

TOP16_KINDS = {"nt": NtHasher, "mul": MulHasher, "antilex": AntiLexHasher}
TOP16_N = [0, 1, 10_000, 3 * 8192 + 5, 200_003]  # chars past k - 1: across the chunks' seams
TOP16_CHUNK = 8192  # k-mers per chunk of csrc/top16.cu
# k at the corners of the kernel's streams: one word of 16 codes, the
# antilex tops' 8 and 16 chars, the 64-char region boundary, past a chunk
TOP16_K = [1, 2, 5, 15, 16, 17, 21, 31, 32, 33, 63, 64, 100, TOP16_CHUNK + 3]


def _top16_inputs(codes, text, dev):
    """(chars, keywords) of the pre-pass: the 2-bit byte stream, code bytes
    (high bits set, also from an odd byte) and text."""
    odd = convert.code_bytes(np.concatenate([[7], codes | 0xF0]).astype(np.uint8), dev)[1:]
    return [(convert.packed_words(PackedSeqVec.from_codes(codes), dev), {}),
            (convert.code_bytes(codes | 0xF0, dev), {"byte_codes": True}),
            (odd, {"byte_codes": True}),
            (convert.text_bytes(GenericSeq(text), dev), {"text": True})]


def _top16_both(chars, n, k, h, dev, **kw):
    """(kernel, plain version) of the pre-pass on the card."""
    (kd, can, rot), tables = convert.hasher_tensors(convert.hasher_from(h), dev,
                                                    kw.get("text", False))
    got = fused.kmer_top16(chars, n, k, tables, rot, can, kind=kd, **kw)
    want = pipeline.kmer_top16_plain(chars, n, k, tables, rot, can, kind=kd, **kw)
    assert got.dtype == torch.int16
    return got, want


@pytest.mark.parametrize("kind", list(TOP16_KINDS))
@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("k", TOP16_K)
def test_kmer_top16_vs_plain(dev, kind, canonical, k):
    """The pre-pass against its plain version on the card (exact) at
    n in {k - 1, k, 10,000, ...} on the 2-bit byte stream, code bytes (high
    bits set, also from an odd byte) and text, and against the JAX
    package's hasher where that is quick; and with `meta` over a buffer
    sized for more chars."""
    rng = np.random.default_rng(k + 100 * canonical)
    h = TOP16_KINDS[kind](k, canonical=canonical)
    for n in (k - 1 + d for d in TOP16_N):
        codes = rng.integers(0, 4, n, dtype=np.uint8)
        text = rng.integers(0, 256, n, dtype=np.uint8)
        for chars, kw in _top16_inputs(codes, text, dev):
            got, want = _top16_both(chars, n, k, h, dev, **kw)
            assert torch.equal(got, want), (n, kw)
            if not kw.get("text") and n * k <= 2 * 10**7:  # the hasher's fold is O(k) a k-mer
                ref = (h.hash_kmers_np(codes) >> 16).astype(np.uint16)
                np.testing.assert_array_equal(got.cpu().numpy().view(np.uint16), ref)
    # meta: the length read on the card, the array sized by the buffer
    cap = k - 1 + 3 * 8192 + 5
    codes = rng.integers(0, 4, cap, dtype=np.uint8)
    chars = convert.code_bytes(codes, dev)
    (kd, can, rot), tables = convert.hasher_tensors(convert.hasher_from(h), dev)
    for n in (cap, k + 8192, k, k - 1):
        meta = torch.tensor([n, 0], dtype=torch.int32, device=dev)
        got = fused.kmer_top16(chars, cap, k, tables, rot, can, kind=kd, byte_codes=True,
                               meta=meta)
        want = pipeline.kmer_top16_plain(chars, n, k, tables, rot, can, kind=kd, byte_codes=True)
        assert got.numel() == cap - k + 1 and torch.equal(got[:want.numel()], want)


@pytest.mark.parametrize("canonical", [False, True])
def test_kmer_top16_largest_gate_k(dev, canonical):
    """At w = 32,767 the largest k the gate admits (nt, and text mul): the
    pre-pass's shared memory is fixed, so it takes any such k."""
    k = _largest_gate_k(32_767, canonical)
    rng = np.random.default_rng(k)
    n = k + 3 * TOP16_CHUNK + 7
    codes = rng.integers(0, 4, n, dtype=np.uint8)
    text = rng.integers(0, 256, n, dtype=np.uint8)
    for (chars, kw), h in zip(_top16_inputs(codes, text, dev),
                              [NtHasher(k, canonical=canonical)] * 3 + [MulHasher(k, canonical=canonical)]):
        got, want = _top16_both(chars, n, k, h, dev, **kw)
        assert torch.equal(got, want), (k, kw)


def _largest_gate_k(w, canonical):
    """The largest k with fused_supported(k, w) (the halo bound falls with
    k), by bisection."""
    lo, hi = 1, 1 << 20
    assert fused.fused_supported(lo, w, canonical) and not fused.fused_supported(hi, w, canonical)
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if fused.fused_supported(mid, w, canonical) else (lo, mid)
    return lo


@pytest.mark.parametrize("offset", range(1, 16))
def test_kmer_top16_unaligned_views(dev, offset):
    """Chars views that start 1 .. 15 bytes past a 16-byte boundary (no bulk
    copy: the kernel's plain loads) on every input kind, both strands."""
    rng = np.random.default_rng(offset)
    n = 3 * TOP16_CHUNK + 4 * offset + 40
    codes = rng.integers(0, 4, n + 64, dtype=np.uint8)
    text = rng.integers(0, 256, n + 64, dtype=np.uint8)
    packed = convert.packed_words(PackedSeqVec.from_codes(codes), dev)
    views = [(packed[offset:], {}),
             (convert.code_bytes(codes | 0xF0, dev)[offset:], {"byte_codes": True}),
             (convert.text_bytes(GenericSeq(text), dev)[offset:], {"text": True})]
    for chars, kw in views:
        for canonical in (False, True):
            for h in (NtHasher(21, canonical=canonical), AntiLexHasher(17, canonical=canonical)):
                got, want = _top16_both(chars, n, h.k, h, dev, **kw)
                assert chars.data_ptr() % 16 and torch.equal(got, want), (offset, kw, h)


@pytest.mark.parametrize("canonical", [False, True])
def test_kmer_top16_chunk_and_grid_edges(dev, canonical):
    """k-mer counts at a chunk's edge and at the persistent grid's whole
    first pass (one chunk a block), each +- 1."""
    k = 21
    grid, smem = fused.top16_grid(k, canonical, device=dev)
    assert grid >= torch.cuda.get_device_properties(dev).multi_processor_count and smem > 0
    rng = np.random.default_rng(grid)
    codes = rng.integers(0, 4, (grid + 1) * TOP16_CHUNK + k, dtype=np.uint8)
    chars = convert.packed_words(PackedSeqVec.from_codes(codes), dev)
    h = NtHasher(k, canonical=canonical)
    for kmers in (TOP16_CHUNK + d for d in (-1, 0, 1)):
        got, want = _top16_both(chars, kmers + k - 1, k, h, dev)
        assert torch.equal(got, want), kmers
    for kmers in (grid * TOP16_CHUNK + d for d in (-1, 0, 1)):
        got, want = _top16_both(chars, kmers + k - 1, k, h, dev)
        assert torch.equal(got, want), kmers


def test_kmer_top16_meta_in_a_graph(dev):
    """A captured launch reads its length from meta[0] on each replay: its
    tops equal the plain version of that many chars, and it writes nothing
    past them."""
    k = 31
    cap = 5 * TOP16_CHUNK + k + 11
    codes = np.random.default_rng(31).integers(0, 4, cap, dtype=np.uint8)
    chars = convert.packed_words(PackedSeqVec.from_codes(codes), dev)
    h = convert.hasher_from(NtHasher(k, canonical=True))
    (kd, can, rot), tables = convert.hasher_tensors(h, dev)
    meta = torch.tensor([cap, 0], dtype=torch.int32, device=dev)
    fused.kmer_top16(chars, cap, k, tables, rot, can, kind=kd, meta=meta)  # set-up, outside
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        tops = fused.kmer_top16(chars, cap, k, tables, rot, can, kind=kd, meta=meta)
    sentinel = 0x5A5A
    for n in (cap, cap - 1, k - 1 + TOP16_CHUNK + 1, k - 1 + TOP16_CHUNK, k + 1, k, k - 1):
        meta.fill_(0)
        meta[0] = n
        tops.fill_(sentinel)
        graph.replay()
        torch.cuda.synchronize()
        want = pipeline.kmer_top16_plain(chars, n, k, tables, rot, can, kind=kd)
        assert torch.equal(tops[:want.numel()], want), n
        assert bool((tops[want.numel():] == sentinel).all()), n


def test_large_w_route_reads_the_prepass(dev):
    """On the card the large-w route launches kmer_top16 once per launch
    and the stored route never does; the route reads the array it is given
    (tops of all zero move the minima), which the stored route refuses."""
    k, w = 22, 8192
    codes = np.random.default_rng(4).integers(0, 4, 2 * TILE + k + w + 100, dtype=np.uint8)
    args, kw = _args(codes, k, w, NtHasher(k, canonical=True), dev)
    stored, stored_kw = _args(codes, 21, 11, NtHasher(21), dev)
    before = fused.LAUNCHES["kmer_top16"]
    fused.fused_sketch(*stored, **stored_kw)
    assert fused.LAUNCHES["kmer_top16"] == before
    want = fused.fused_sketch(*args, **kw)
    assert fused.LAUNCHES["kmer_top16"] == before + 1
    tops = fused.kmer_top16(*args[:3], *args[4:7], kind=kw["kind"])
    for given, equal in ((tops, True), (torch.zeros_like(tops), False)):
        scratch, counts = fused.minimizer_tiles(*args, **kw, top16=given)
        got = fused._fused_harvest((scratch, counts, fused.tile_offsets(counts)),
                                   pipeline.MODE_MINIMIZERS)
        assert torch.equal(got, want) == equal
    assert fused.LAUNCHES["kmer_top16"] == before + 2
    with pytest.raises(ValueError, match="top16"):
        fused.minimizer_tiles(*stored, **stored_kw, top16=tops)


def test_large_w_route_without_tops_is_refused(dev):
    """smt_minimizer_tiles on the large-w route with no top16 array returns
    an error (the route never hashes); so does an array on the stored route."""
    k, w = 21, 8192
    codes = np.random.default_rng(5).integers(0, 4, TILE + k + w, dtype=np.uint8)
    (chars, n, _, _, tables, rot, canonical, _, _), _ = _args(codes, k, w, NtHasher(k), dev)
    dev = chars.device
    lib = fused._library(dev)
    scratch = torch.empty(TILE, dtype=torch.int32, device=dev)
    counts = torch.empty(1, dtype=torch.int32, device=dev)
    tops = torch.zeros(n, dtype=torch.int16, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for sub_tile, w_, passes, top16 in ((4096, w, 0, None), (0, 11, 2, tops)):
        err = lib.smt_minimizer_tiles(
            dev.index, chars.data_ptr(), chars.numel(), n, k, w_, 0, 0, 0, 0, 0,
            tables.data_ptr(), rot, None, 0, 0, 0, 0, None, sub_tile, passes,
            None if top16 is None else top16.data_ptr(), scratch.data_ptr(), counts.data_ptr(),
            1, stream)
        assert err != 0
    torch.cuda.synchronize()


def test_short_seq_sketcher_large_w(dev):
    """A ShortSeqSketcher at w = 8,192 (the large-w route, in its graph):
    each replay counts four launches, kmer_top16 among them, and every
    result equals the oracle, with the length read on the card."""
    from simd_minimizers_tpu_torch.ops.device_sketcher import ShortSeqSketcher

    k, w = 22, 8192
    h = NtHasher(k, canonical=True)
    sk = ShortSeqSketcher(k, w, convert.hasher_from(h), device=dev)
    rng = np.random.default_rng(23)
    lens = [k + w - 2, k + w - 1, k + w + 4096, sk.max_chars, 5000 + w]
    seqs = [rng.integers(0, 4, n, dtype=np.uint8) for n in lens]
    before = dict(fused.LAUNCHES)
    outs = sk.sketch_many(seqs)
    ran = sum(s.size >= k + w - 1 for s in seqs)
    grew = {key: fused.LAUNCHES[key] - before[key] for key in before}
    name = fused.instance_name(True, pipeline.MODE_MINIMIZERS, False)
    assert {key: c for key, c in grew.items() if c} == {
        "kmer_top16": ran, name: ran, "tile_offsets": ran, "tile_append": ran}
    for s, got in zip(seqs, outs, strict=True):
        want = _oracle(s, k, w, h) if s.size >= k + w - 1 else np.zeros(0, np.uint32)
        np.testing.assert_array_equal(got, want)



# every power of two T = sub_tile from 1 to TILE with the large-w route forced
FORCED_W = [1, 2, 5, 9, 17, 31, 33, 63, 65, 255, 257, 1000, 1025, 4095, 4097, 8192, 32_767,
            61_439]


@pytest.mark.parametrize("w", FORCED_W)
@pytest.mark.parametrize("canonical", [False, True])
def test_large_w_route_every_scan_size(dev, w, canonical, monkeypatch):
    """The large-w route forced at every w (LARGE_W_MIN = 1): every block
    size of its scan (T = 1 .. 4,096, below a warp too), in every mode
    family with and without a mask, on 2-bit packed DNA (an unaligned view
    too), code bytes and text, across tile seams: minimizer_tiles
    bit-equal to minimizer_tiles_plain."""
    monkeypatch.setattr(fused, "LARGE_W_MIN", 1)
    k = 21 if (w % 2 or not canonical) else 22
    l = k + w - 1
    assert fused.sub_tile(k, w, canonical) == min(TILE, 1 << (w.bit_length() - 1))
    rng = np.random.default_rng(w * 2 + canonical)
    n = 2 * TILE + 17 + l - 1
    dna = rng.integers(0, 4, n, dtype=np.uint8)
    text = rng.integers(0, 256, n, dtype=np.uint8)
    h = convert.hasher_from(NtHasher(k, canonical=canonical))
    packed = convert.packed_words(PackedSeqVec.from_codes(dna), dev)
    inputs = [("packed", packed, False, {}),
              ("unaligned", torch.cat([packed.new_zeros(1), packed])[1:], False, {}),
              ("code bytes", convert.code_bytes(dna | 0xF0, dev), False, {"byte_codes": True}),
              ("text", convert.text_bytes(GenericSeq(text), dev), True, {"text": True})]
    mask = _clustered_mask(n, l, rng)
    plane = convert.ambiguity_plane(mask, n, dev)
    for name, chars, is_text, kw in inputs:
        (kind, can, rot), tables = convert.hasher_tensors(h, dev, is_text)
        for mode in (pipeline.MODE_MINIMIZERS, SKM, CLOSED):
            for amb in (None, plane):
                args = (chars, n, k, w, tables, rot, can, mode, amb)
                scratch, counts = fused.minimizer_tiles(*args, kind=kind, **kw)
                p_scratch, p_counts = pipeline.minimizer_tiles_plain(
                    *args[:7], TILE, mode, amb, kind=kind, **kw)
                assert torch.equal(counts, p_counts), (name, mode, amb is not None)
                live = torch.arange(TILE, device=dev) < counts[:, None]
                for g, p in zip(scratch.view(-1, counts.numel(), TILE),
                                p_scratch.view(-1, counts.numel(), TILE)):
                    assert torch.equal(g[live], p[live]), (name, mode, amb is not None)


def test_short_seq_sketcher_large_w_32767(dev):
    """A ShortSeqSketcher at w = 32,767: each replay reads its length from
    meta on the card; every result equals the plain version of the same
    chars and the oracle."""
    from simd_minimizers_tpu_torch.ops.device_sketcher import ShortSeqSketcher

    k, w = 21, 32_767
    h = NtHasher(k, canonical=True)
    sk = ShortSeqSketcher(k, w, convert.hasher_from(h), device=dev)
    rng = np.random.default_rng(29)
    lens = [k + w - 1, k + w + 17, k + w + 4096, k + w + 6000, sk.max_chars]
    seqs = [rng.integers(0, 4, n, dtype=np.uint8) for n in lens]
    before = fused.LAUNCHES["kmer_top16"]
    outs = sk.sketch_many(seqs)
    assert fused.LAUNCHES["kmer_top16"] - before == len(seqs)
    for s, got in zip(seqs, outs, strict=True):
        args, kw = _args(s, k, w, h, dev)
        want = pipeline.run_pipeline(*args, **kw)
        np.testing.assert_array_equal(got, want.cpu().numpy().view(np.uint32))
        np.testing.assert_array_equal(got, _oracle(s, k, w, h))


def test_smem_bytes_agree_with_the_kernel(dev):
    """ops/fused._smem_bytes equals the kernel's tile_smem_bytes on both
    routes; the large-w paths fit 2 (canonical w = 32,767), 3 (forward
    w = 61,439 with a mask) and 4 (forward w = 32,767) blocks per SM."""
    lib = fused._library(torch.device("cuda", torch.cuda.current_device()))
    for k, w in ((21, 11), (5, 7), (64, 63), (21, 8191), (21, 8192), (22, 32_767),
                 (21, 61_439), (190_001, 63), (1001, 5)):
        for canonical, mode, amb, text, kind in (
                (True, pipeline.MODE_MINIMIZERS, False, False, "nt"),
                (False, SKM, True, True, "mul"), (False, CLOSED, True, False, "antilex"),
                (True, SKM, False, True, "antilex")):
            for t in (0, min(TILE, 1 << (w.bit_length() - 1))):
                assert lib.smt_tile_smem_bytes(
                    k, w, int(canonical), fused._KERNEL_MODE[mode], int(amb), int(text),
                    int(kind == "antilex"), t) == fused._smem_bytes(
                        k, w, canonical, mode, amb, text, kind, t), (k, w, t, canonical, mode)
    for want, geometry in ((2, (21, 32_767, True)), (3, (21, 61_439, False, "minimizers", True)),
                           (4, (21, 32_767, False, CLOSED, False, True, "mul"))):
        blocks, smem = fused.tiles_occupancy(*geometry)
        assert smem == fused._tile_smem_bytes(*geometry)
        assert blocks >= want, (geometry, blocks, smem)

# -- k-mer values on the card (csrc/values.cu) ------------------------------

VALUE_KS = [1, 2, 5, 15, 16, 17, 21, 31, 32, 33, 48, 63, 64]


@pytest.mark.parametrize("k", VALUE_KS)
@pytest.mark.parametrize("canonical", [False, True])
def test_kmer_values_vs_plain(dev, k, canonical):
    """The kernel against its plain version on the card, on the 2-bit byte
    stream (aligned and an unaligned view) and on code bytes, with the two
    ends, a buffer one byte short of a whole word and m = 0; against the
    host's values of the same codes."""
    from simd_minimizers_tpu_torch.ops import device_values, values

    rng = np.random.default_rng(k * 2 + canonical)
    n = 5003
    codes = rng.integers(0, 4, n, dtype=np.uint8)
    pos = np.sort(rng.integers(0, n - k + 1, 3000)).astype(np.uint32)
    pos[[0, -1]] = (0, n - k)
    pos_t = torch.from_numpy(pos.view(np.int32)).to(dev)
    packed = convert.packed_words(PackedSeqVec.from_codes(codes), dev)
    unaligned = torch.cat([packed.new_zeros(1), packed])[1:]  # data_ptr not 4-aligned
    host = (values.canonical_kmer_values_u128_limbs if canonical
            else values.kmer_values_u128_limbs)(codes, pos, k)
    for chars, byte_codes in ((packed, False), (unaligned, False),
                              (convert.code_bytes(codes, dev), True)):
        before = dict(device_values.LAUNCHES)
        got = device_values.kmer_values_limbs(chars, pos_t, k, canonical, byte_codes)
        assert device_values.LAUNCHES["kmer_values"] == before["kmer_values"] + 1
        want = device_values.kmer_values_limbs_plain(chars, pos_t, k, canonical, byte_codes)
        assert torch.equal(got, want)
        lo, hi = device_values.kmer_values_u128_limbs(chars, pos, k, canonical, byte_codes)
        np.testing.assert_array_equal(lo, host[0])
        np.testing.assert_array_equal(hi, host[1])
        empty = device_values.kmer_values_limbs(chars, pos_t[:0], k, canonical, byte_codes)
        assert empty.shape == (0, device_values.limb_count(k))


def test_kmer_values_past_2_31(dev):
    """Positions at and past 2^31 on a 2^31 + 64-char sequence are u32:
    the packed stream against its plain version and against code bytes,
    and the last k-mers against the host."""
    from simd_minimizers_tpu_torch import native
    from simd_minimizers_tpu_torch.ops import device_values

    n = (1 << 31) + 64
    g = torch.Generator(device=dev).manual_seed(5)
    codes = torch.randint(0, 4, (n,), dtype=torch.uint8, device=dev, generator=g)
    q = codes.view(-1, 4)
    packed = q[:, 0] | q[:, 1] << 2 | q[:, 2] << 4 | q[:, 3] << 6
    rng = np.random.default_rng(31)
    for k in (21, 33, 64):
        pos = np.concatenate([rng.integers(0, n - k + 1, 2000),
                              rng.integers((1 << 31) - 100, n - k + 1, 2000),
                              [0, (1 << 31) - 1, 1 << 31, n - k]]).astype(np.uint32)
        pos_t = torch.from_numpy(pos.view(np.int32)).to(dev)
        for canonical in (False, True):
            got = device_values.kmer_values_limbs(packed, pos_t, k, canonical)
            assert torch.equal(got, device_values.kmer_values_limbs_plain(packed, pos_t, k,
                                                                          canonical))
            assert torch.equal(got, device_values.kmer_values_limbs(codes, pos_t, k, canonical,
                                                                    byte_codes=True))
            if k <= 32:
                base = (1 << 31) - 200
                tail = codes[base:].cpu().numpy()
                top = pos[pos >= base]
                want = native.kmer_values_u64(tail, top - base, k, canonical)
                vals = device_values.kmer_values_u64(packed, top, k, canonical)
                np.testing.assert_array_equal(vals, want)
    del codes, packed
    torch.cuda.empty_cache()


VALUE_EDGE_KS = [1, 15, 16, 17, 32, 33, 48, 49, 64]


@pytest.mark.parametrize("k", VALUE_EDGE_KS)
@pytest.mark.parametrize("canonical", [False, True])
def test_kmer_values_positions_in_any_order(dev, k, canonical):
    """The kernel against its plain version on positions in no order: a
    random permutation, duplicates, positions spread over 8 Mbp (a block's
    positions megabytes apart), canonical minimizer positions with steps
    back (neighbours swapped), the last k-mer of the buffer, m of 1,
    3, 255, 256, 257 and 1,027, and a positions view off 16 bytes; on the
    2-bit byte stream and code bytes, each at an aligned and an unaligned
    address."""
    from simd_minimizers_tpu_torch.ops import device_values

    rng = np.random.default_rng(1000 + 2 * k + canonical)
    n = 1 << 23
    codes = rng.integers(0, 4, n, dtype=np.uint8)
    packed = convert.packed_words(PackedSeqVec.from_codes(codes), dev)
    cbytes = convert.code_bytes(codes, dev)
    inputs = [(packed, False), (torch.cat([packed.new_zeros(3), packed])[3:], False),
              (cbytes, True), (torch.cat([cbytes.new_zeros(1), cbytes])[1:], True)]
    some = rng.integers(0, n - k + 1, 3000)
    canon = api.canonical_minimizers(21, 11).run(PackedSeqVec.from_codes(codes[:1_000_000]),
                                                 device=dev).positions.astype(np.int64)
    flip = np.arange(0, canon.size - 1, 37)  # neighbours swapped: steps back by at most w
    canon[flip], canon[flip + 1] = canon[flip + 1], canon[flip].copy()
    assert (np.diff(canon) < 0).any()
    cases = {
        "permutation": rng.permutation(np.sort(some)),
        "duplicates": rng.choice(some[:40], 5000),
        "spread": rng.integers(0, n - k + 1, 20_000),
        "canonical": canon,
        "last k-mer": np.r_[[n - k] * 5, some[:2000], n - k],
        **{f"m={m}": rng.integers(n - k - 5000, n - k + 1, m) for m in (1, 3, 255, 256, 257, 1027)},
    }
    for name, pos in cases.items():
        pos_t = torch.from_numpy(pos.astype(np.uint32).view(np.int32)).to(dev)
        views = [pos_t, torch.cat([pos_t.new_zeros(1), pos_t])[1:]]  # the second off 16 bytes
        for chars, byte_codes in inputs:
            for p in views:
                got = device_values.kmer_values_limbs(chars, p, k, canonical, byte_codes)
                want = device_values.kmer_values_limbs_plain(chars, p, k, canonical, byte_codes)
                assert torch.equal(got, want), (name, byte_codes, chars.data_ptr() % 4)


def test_kmer_values_many_rows(dev):
    """m past 2^31 / 4 positions at L = 4 (more than 2^31 limbs): the first
    and last rows against the plain version."""
    from simd_minimizers_tpu_torch.ops import device_values

    n = 1 << 20
    g = torch.Generator(device=dev).manual_seed(64)
    codes = torch.randint(0, 4, (n,), dtype=torch.uint8, device=dev, generator=g)
    m = (1 << 29) + 1027
    pos = torch.randint(0, n - 63, (m,), dtype=torch.int32, device=dev, generator=g)
    got = device_values.kmer_values_limbs(codes, pos, 64, True, byte_codes=True)
    assert got.shape == (m, 4)
    for part in (slice(0, 5000), slice(m - 5000, m), slice((1 << 29) - 7, (1 << 29) + 9)):
        assert torch.equal(got[part], device_values.kmer_values_limbs_plain(
            codes, pos[part], 64, True, byte_codes=True)), part
    del got, pos
    torch.cuda.empty_cache()


@pytest.mark.parametrize("k,w", [(5, 7), (21, 11), (33, 11), (64, 12)])
def test_output_values_after_a_card_run(dev, k, w):
    """After Builder.run on the card, values_u64 (k <= 32), values_u128_limbs
    and values_u128 of DNA launch the kernel once each (the launch count),
    and equal the host's values after a CPU run; text stays on the host."""
    from simd_minimizers_tpu_torch.ops import device_values

    rng = np.random.default_rng(k + w)
    codes = rng.integers(0, 4, 3 * TILE + 1000, dtype=np.uint8)
    for seq in (PackedSeqVec.from_codes(codes), PackedSeqVec.from_codes(codes).slice(3, 12_000)):
        for b in (api.minimizers(k, w), api.canonical_minimizers(k, w),
                  api.canonical_minimizers(k, w).super_kmers()):
            out, host = b.run(seq, device=dev), b.run(seq, device="cpu")
            np.testing.assert_array_equal(out.positions, host.positions)
            calls = [out.values_u128_limbs, out.values_u128]
            if k <= 32:
                calls.append(out.values_u64)
            for call in calls:
                before = device_values.LAUNCHES["kmer_values"]
                got = call()
                assert device_values.LAUNCHES["kmer_values"] == before + 1
                want = getattr(host, call.__name__)()
                if isinstance(want, tuple):
                    for g_, w_ in zip(got, want, strict=True):
                        np.testing.assert_array_equal(g_, w_)
                elif isinstance(want, list):
                    assert got == want
                else:
                    np.testing.assert_array_equal(got, want)
    text = rng.integers(32, 127, 5000, dtype=np.uint8)
    b = api.minimizers(7, w).hasher(convert.hasher_from(MulHasher(7)))
    out = b.run(text, device=dev)
    before = device_values.LAUNCHES["kmer_values"]
    np.testing.assert_array_equal(out.values_u64(), b.run(text, device="cpu").values_u64())
    assert device_values.LAUNCHES["kmer_values"] == before


def test_kmer_values_launch_failure_raises(dev, monkeypatch):
    """A failed launch raises; nothing falls back to the plain version or
    the host, and the launch is not counted."""
    from simd_minimizers_tpu_torch.ops import _build, device_values

    class Failing:
        @staticmethod
        def smt_kmer_values(*args):
            return 1

    chars = torch.zeros(64, dtype=torch.uint8, device=dev)
    pos = torch.zeros(3, dtype=torch.int32, device=dev)
    monkeypatch.setattr(_build, "library", lambda: Failing)
    before = device_values.LAUNCHES["kmer_values"]
    with pytest.raises(RuntimeError, match="kmer_values failed"):
        device_values.kmer_values_limbs(chars, pos, 21, True)
    assert device_values.LAUNCHES["kmer_values"] == before


@pytest.mark.parametrize("seed", [11, 12])
def test_fuzz_on_card(dev, seed):
    """The randomized differential fuzz (tools/fuzz.py) on the card: 50
    configs of each seed through every entry point, bit-equal to the
    oracle, with launches of the kernels."""
    from simd_minimizers_tpu_torch.tools import fuzz

    before = sum(fused.LAUNCHES.values())
    s = fuzz.run(seed=seed, configs=50, device="cuda")
    assert s["configs"] == 50 and s["mismatches"] == 0 and s["device"].startswith("cuda")
    assert set(s["by_entry"]) == set(fuzz.ENTRIES) and s["by_route"]["large-w"] >= 8
    assert sum(fused.LAUNCHES.values()) > before


def test_native_fasta_scan_on_card(dev, tmp_path):
    """read_fasta (the native scan) -> sketch_records on the card gives the
    positions of the NumPy scan's records, and the oracle's."""
    from simd_minimizers_tpu_torch import hashers
    from simd_minimizers_tpu_torch.seq import fasta

    rng = np.random.default_rng(0xFA5)
    acgtn = np.frombuffer(b"ACGTNacgtnRY", np.uint8)
    raw = b"".join(b">r%d d\r\n" % i + b"\r\n".join(
        acgtn[rng.integers(0, 12, int(n))][j:j + 60].tobytes() for j in range(0, int(n), 60))
        + b"\r\n" for i, n in enumerate(rng.integers(0, 200_000, 12)))
    p = tmp_path / "g.fa"
    p.write_bytes(raw)
    recs = fasta.read_fasta(str(p))
    codes, amb, starts = fasta.fasta_scan_plain(np.frombuffer(raw, np.uint8))
    assert len(recs) == starts.size - 1 == 12
    h = hashers.NtHasher(21, canonical=True)
    got = spans.sketch_records([r.codes for r in recs], 21, 11, h, pipeline.MODE_MINIMIZERS,
                               [r.ambiguous for r in recs], dna=True, device=dev)
    want = spans.sketch_records(
        [codes[a:e] for a, e in zip(starts[:-1], starts[1:])], 21, 11, h,
        pipeline.MODE_MINIMIZERS, [amb[a:e] for a, e in zip(starts[:-1], starts[1:])],
        dna=True, device=dev)
    jh = NtHasher(21, canonical=True)
    for g, p_, r in zip(got, want, recs):
        np.testing.assert_array_equal(g, p_)
        np.testing.assert_array_equal(g, oracle.collect_and_dedup(
            oracle.selected_stream(r.codes, 21, 11, jh, ambiguous=r.ambiguous),
            skip_sentinel=True))


def test_variance_example_on_card(dev):
    """examples.variance --device cuda: each count of the kernel path held
    equal to the oracle's, the density near 2/(w+1)."""
    from simd_minimizers_tpu_torch.examples import variance

    res = variance.main(["--device", "cuda", "--reps", "20", "--len", "20000"])
    assert res["via"] == "Builder.run on cuda (= oracle)" and abs(res["density"] - 2 / 12) < 0.01
