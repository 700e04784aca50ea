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
from simd_minimizers_tpu_torch.ops import backend, fused, pipeline, spans

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


@pytest.mark.parametrize("case", ["full", "zero", "mixed"])
def test_tile_append_plain_two_planes_vs_oracle(case):
    """tile_append on CPU tensors (its plain version) with the two planes of
    super-k-mers (positions, window indices): every tile full (w = 1 keeps
    every window), every tile empty (every char ambiguous) and the counts of
    w = 11, against a NumPy gather of the tile runs and the JAX package's
    oracle's kept windows."""
    tile, k = fused.TILE, 5
    w = 1 if case == "full" else 11
    nw = 2 * tile if case == "full" else 2 * tile + 37
    codes = np.random.default_rng(len(case)).integers(0, 4, nw + k + w - 2, dtype=np.uint8)
    amb = np.ones(codes.size, bool) if case == "zero" else None
    h = NtHasher(k)
    sel = oracle.selected_stream(codes, k, w, h, ambiguous=amb)
    keep = np.r_[True, sel[1:] != sel[:-1]] & (sel != oracle.SKIPPED)
    want = np.stack([sel[keep], np.flatnonzero(keep)]).astype(np.uint32)

    words = torch.from_numpy(pack_2bit(codes))
    key, table = convert.hasher_tensors(convert.hasher_from(h), "cpu")
    plane = None if amb is None else convert.ambiguity_plane(amb, codes.size, "cpu")
    scratch, counts = fused.minimizer_tiles(words, codes.size, k, w, table, key[2], False,
                                            pipeline.MODE_SUPERKMERS, plane)
    assert scratch.shape == (2, counts.numel() * tile)
    if case == "full":
        assert (counts == tile).all()
    if case == "zero":
        assert not counts.any()
    offsets = fused.tile_offsets(counts)
    total = int(offsets[-1])
    runs = scratch.view(2, -1, tile).numpy()
    gather = np.stack([np.concatenate([runs[p, t, :c] for t, c in enumerate(counts.tolist())])
                       for p in range(2)]).astype(np.int32)
    got = fused.tile_append(scratch, counts, offsets, total)
    assert got.shape == (2, total) == want.shape
    np.testing.assert_array_equal(got.numpy(), gather)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


def test_tile_append_grid_and_arguments():
    """The blocks of a tile_append launch (one warp a tile, at most the
    persistent grid, at least one block), the grid refused off the card,
    and arguments that disagree refused on the CPU too."""
    assert fused.append_blocks(1, 792, 8) == 1
    assert fused.append_blocks(8, 792, 8) == 1 and fused.append_blocks(9, 792, 8) == 2
    assert fused.append_blocks(792 * 8 - 1, 792, 8) == 792
    assert fused.append_blocks(24_415, 792, 8) == 792 == fused.append_blocks(131_072, 792, 8)
    for bad in ((0, 792, 8), (5, 0, 8), (5, 792, 0)):
        with pytest.raises(ValueError):
            fused.append_blocks(*bad)
    with pytest.raises(ValueError, match="CUDA card"):
        fused.append_grid("cpu")
    tile = fused.TILE
    counts = torch.tensor([3, 0], dtype=torch.int32)
    offsets = torch.tensor([0, 3, 3], dtype=torch.int32)
    scratch = torch.arange(2 * tile, dtype=torch.int32)
    assert fused.tile_append(scratch, counts, offsets, 3).tolist() == [0, 1, 2]
    assert fused.tile_append(scratch.view(1, -1), counts, offsets, 3).tolist() == [[0, 1, 2]]
    for s, c, o in ((scratch[:tile], counts, offsets), (scratch, counts, offsets[:2]),
                    (scratch.repeat(3).view(3, -1), counts, offsets),
                    (scratch, counts.view(2, 1), offsets)):
        with pytest.raises(ValueError):
            fused.tile_append(s, c, o, 3)
    with pytest.raises(ValueError, match="int32"):
        fused.tile_append(scratch.long(), counts, offsets, 3)


@pytest.mark.parametrize("n", [0, 3, 30])
def test_short_input_is_empty(n):
    before = dict(fused.LAUNCHES)
    got = _port(np.zeros(n, np.uint8), 21, 11, NtHasher(21, canonical=True))
    assert got.numel() == 0 and fused.LAUNCHES == before


def test_geometry_gate():
    # every w with TILE + w <= 2^16 (the 16-bit column key), both strands:
    # from LARGE_W_MIN on, the large-w route keeps two blocks of keys per
    # arm instead of all TILE + w; the tile's chars must still fit one
    # block's shared memory
    assert fused.fused_supported(21, 21_000, canonical=True)
    assert fused.fused_supported(21, 22_000, canonical=True)
    assert fused.fused_supported(21, 40_000, canonical=False)
    assert fused.fused_supported(21, 43_000, canonical=False)
    for canonical in (False, True):
        assert fused.fused_supported(21, (1 << 16) - fused.TILE, canonical)
        assert not fused.fused_supported(21, (1 << 16) - fused.TILE + 1, canonical)
    assert fused.fused_supported(21, 11) and fused.fused_supported(64, 2)
    assert not fused.fused_supported(200_000, 11)
    assert fused.sub_tile(21, fused.LARGE_W_MIN - 1) == 0 and fused.sub_tile(21, 1000) == 0
    assert fused.sub_tile(21, max(5000, fused.LARGE_W_MIN)) == fused.TILE
    assert fused.sub_tile(21, 3000) == fused.sub_tile(21, 3000, mode=pipeline.MODE_SUPERKMERS) == 2048
    assert fused.sub_tile(21, 1000, mode=pipeline.MODE_SUPERKMERS) == 0
    # the large-w route: no chars and no tables; per arm the least key of
    # TILE + 1 windows and two blocks of sub_tile keys, each with one pad
    # word per thread's run of the scan (256) and 8 warp totals, whatever w;
    # canonical the T/G bits of the tile's chars
    w = 32_767
    chars = (fused.TILE + 21 + w - 1 + 6) // 4 * 4
    assert (fused._tile_smem_bytes(21, w, True)
            == 4 * 2 * (fused.TILE + 1 + 2 * (fused.TILE + 256 + 8)) + (chars + 31) // 32 * 4)
    # the stored route: chars, keys in whole 32-word rows (4107 columns take
    # 4128 words an arm), canonical the chars' T/G bits (4132 chars, 130
    # words), then the nt fold's 2-bit tables (2 x 4 words)
    assert fused._tile_smem_bytes(21, 11, True) == 4144 + 2 * 4128 * 4 + 130 * 4 + 32
    assert fused._tile_smem_bytes(21, 11, False) == 4144 + 4128 * 4 + 32
    # super-k-mers stage two planes of TILE words in the keys' space; an
    # ambiguity plane adds the tile's bits in 32-bit words
    skm = pipeline.MODE_SUPERKMERS
    assert fused._tile_smem_bytes(21, 11, False, skm) == 4144 + 2 * fused.TILE * 4 + 32
    assert fused._tile_smem_bytes(21, 11, True, skm) == fused._tile_smem_bytes(21, 11, True)
    assert (fused._tile_smem_bytes(21, 11, True, ambiguous=True)
            == fused._tile_smem_bytes(21, 11, True) + (fused.TILE + 31 + 62) // 32 * 4)
    assert fused.fused_supported(21, 40_000, False, skm)
    assert fused.fused_supported(21, 42_376, False, ambiguous=True)
    assert fused.fused_supported(21, 42_376, False)
    # the stored route below LARGE_W_MIN: every column's key, per arm, in
    # whole rows of 32, and canonical the T/G bits of the tile's chars
    w = fused.LARGE_W_MIN - 1
    chars = (fused.TILE + 21 + w - 1 + 6) // 4 * 4
    assert (fused._tile_smem_bytes(21, w, True)
            == (chars + 15) // 16 * 16 + 4 * 2 * ((fused.TILE + w + 31) // 32 * 32)
            + (chars + 31) // 32 * 4 + 32)
    # where the stored layout would not fit (a huge k), the large-w route
    # takes the w below LARGE_W_MIN too
    k = 190_001
    assert fused.sub_tile(k, 63) > 0 and fused.fused_supported(k, 63)
    assert fused.sub_tile(k - 20_000, 63) == 0
    # the stored route's doubling passes: ceil(w / 2^passes) loads per window
    for w in (1, 2, 3, 4, 7, 8, 11, 16, 63, 1000):
        p = fused.min_passes(w)
        assert 0 <= p and 1 << p <= w
        assert -(-w // (1 << p)) <= 2 << fused.PASS_SLACK


# (k, w, canonical, mode, ambiguity plane, text, hasher kind): the large-w
# paths of chip_smoke.py that the layout is sized for, and the blocks per SM
# each must fit: 228 KiB of shared memory per SM, less 1 KiB reserved and the
# kernel's 160 B of static shared memory per block
LARGE_W_PATHS = [
    ((21, 32_767, True, pipeline.MODE_MINIMIZERS, False, False, "nt"), 107_148, 2),
    ((21, 61_439, False, pipeline.MODE_MINIMIZERS, True, False, "nt"), 59_468, 3),
    ((21, 32_767, False, pipeline.MODE_CLOSED_SYNCMERS, False, True, "mul"), 51_268, 4),
    ((21, 32_767, False, pipeline.MODE_MINIMIZERS, False, True, "mul"), 51_268, 4),
    ((21, 32_767, True, pipeline.MODE_SUPERKMERS, False, False, "nt"), 107_148, 2),
    ((21, 21_721, True, pipeline.MODE_MINIMIZERS, False, False, "nt"), 105_768, 2),
]


@pytest.mark.parametrize("geometry,smem,blocks", LARGE_W_PATHS)
def test_large_w_layout_and_blocks_per_sm(geometry, smem, blocks):
    """The large-w route's shared memory (no chars, no tables; the scans'
    padding and warp totals; canonical a T/G bit plane) and the blocks per
    SM it leaves room for: more than the gate's halo bound (every char one
    byte, the fold's tables) would."""
    k, w, canonical, mode, amb, text, kind = geometry
    t = fused.sub_tile(*geometry)
    assert t == fused.TILE and fused.fused_supported(*geometry)
    assert fused._tile_smem_bytes(*geometry) == fused._smem_bytes(*geometry, t) == smem
    per_sm, reserved, static = 228 * 1024, 1024, 160
    assert per_sm // (smem + reserved + static) == blocks
    assert per_sm // (fused._halo_bytes(*geometry, t) + reserved + static) < blocks


# (k, w) -> (fused_supported, sub_tile) for canonical nt minimizers, forward
# nt minimizers with a mask, forward mul super-k-mers of text and canonical
# antilex closed syncmers of text with a mask: the gate as the kernel has
# always had it, whatever its shared memory holds, and the routing from
# LARGE_W_MIN = 1,536 (the stored route below it, and above it where the
# large-w route's bound does not fit a huge k but the stored layout does)
GATE_CORNERS = {
    (21, 1535): [(True, 0)] * 4,
    (21, 1536): [(True, 1024)] * 4,
    (21, 8191): [(True, 4096)] * 4,
    (21, 8192): [(True, 4096)] * 4,
    (21, 42_376): [(True, 4096)] * 4,
    (21, 61_440): [(True, 4096)] * 4,
    (21, 61_441): [(False, 4096)] * 4,
    (190_001, 11): [(True, 8), (False, 8), (True, 0), (False, 8)],
    (190_001, 63): [(True, 32), (False, 32), (True, 0), (False, 32)],
    (130_001, 4096): [(True, 0), (True, 4096), (True, 4096), (False, 4096)],
    (190_001, 8191): [(False, 4096)] * 4,
    (190_001, 8192): [(False, 4096)] * 4,
    (190_001, 42_376): [(False, 4096)] * 4,
    (190_001, 61_440): [(False, 4096)] * 4,
    (200_000, 11): [(False, 8)] * 4,
    (200_000, 63): [(False, 32)] * 4,
    (200_000, 8192): [(False, 4096)] * 4,
    (200_000, 61_441): [(False, 4096)] * 4,
}
GATE_VARIANTS = [(True, pipeline.MODE_MINIMIZERS, False, False, "nt"),
                 (False, pipeline.MODE_MINIMIZERS, True, False, "nt"),
                 (False, pipeline.MODE_SUPERKMERS, False, True, "mul"),
                 (True, pipeline.MODE_CLOSED_SYNCMERS, True, True, "antilex")]


@pytest.mark.parametrize("variant", range(len(GATE_VARIANTS)))
@pytest.mark.parametrize("k,w", list(GATE_CORNERS))
def test_gate_and_route_pinned(k, w, variant):
    """fused_supported and sub_tile at the corners of the geometry: the
    large-w route's smaller layout widens neither the gate (its halo bound,
    `_halo_bytes`) nor moves the route; where the gate admits, the layout
    the kernel uses fits one block's shared memory."""
    geometry = (k, w, *GATE_VARIANTS[variant])
    supported, t = GATE_CORNERS[(k, w)][variant]
    assert fused.fused_supported(*geometry) is supported
    assert fused.sub_tile(*geometry) == t
    if supported:
        assert fused._tile_smem_bytes(*geometry) <= fused._SMEM_MAX
    assert fused.LARGE_W_MIN == 1536


@pytest.mark.parametrize("w,passes,ok", [(11, 0, True), (11, 3, True), (11, 4, False),
                                          (1, 0, True), (1, 1, False), (11, -1, False),
                                          (9000, 0, False)])
def test_pass_count_argument(w, passes, ok):
    # the stored route's doubling passes: any 2^passes <= w, none on the
    # large-w route (from LARGE_W_MIN); the plain version ignores them
    k = 21
    codes = np.random.default_rng(w).integers(0, 4, fused.TILE + k + w + 40, dtype=np.uint8)
    chars = torch.from_numpy(pack_2bit(codes))
    (kind, can, rot), tables = convert.hasher_tensors(smt.NtHasher(k), "cpu")
    args = (chars, codes.size, k, w, tables, rot, can)
    if not ok:
        with pytest.raises(ValueError, match="passes"):
            fused.minimizer_tiles(*args, passes=passes)
        return
    got = fused.minimizer_tiles(*args, passes=passes)
    want = fused.minimizer_tiles(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("k,w", [(200_001, 11), (21, 61_441)])
def test_beyond_gate_raises_on_cpu(k, w):
    words = torch.zeros(1 << 16, dtype=torch.uint8)
    with pytest.raises(NotImplementedError, match="ROADMAP A12"):
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
        spans.sketch_long(words, 1 << 32, 21, 11, smt.NtHasher(21))


def test_bad_arguments_raise():
    table = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(TypeError):
        fused.fused_sketch(torch.zeros(8, dtype=torch.int32), 30, 5, 7, table, 23, False)
    with pytest.raises(ValueError):  # canonical needs odd l
        fused.fused_sketch(torch.zeros(8, dtype=torch.uint8), 30, 6, 7, table, 23, True)
    with pytest.raises(ValueError):
        fused.fused_sketch(torch.zeros(8, dtype=torch.uint8, device="meta"), 30, 5, 7,
                           table, 23, False)
    # the graph capture's arguments: the length read on the card, the total too
    tables = torch.zeros(2, 4, dtype=torch.int64)
    with pytest.raises(ValueError, match="on the card"):
        fused.minimizer_tiles(torch.zeros(8, dtype=torch.uint8), 30, 5, 7, tables, 23, False,
                              meta=torch.zeros(2, dtype=torch.int32))
    counts = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="on the card"):
        fused.tile_append(torch.zeros(fused.TILE, dtype=torch.int32), counts,
                          torch.zeros(2, dtype=torch.int32), None)


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
