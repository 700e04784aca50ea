"""Sequences split into spans: the port's `fused.sketch_long` on CPU tensors
(the kernels' plain versions) == the JAX package's `fused.sketch_long` (its
Pallas kernel in interpret mode, C=1024, the span sizes of
tests/test_drivers.py) == the NumPy oracle; the launch offset near 2^32;
the port's copy of the seam merge; super-k-mers with an ambiguity plane
against the JAX package's `backend.sketch`; and the u32 limits.

Integer outputs: tolerance 0. On the card the same driver runs the kernels
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import numpy as np
import pytest
import torch

import simd_minimizers_tpu_torch as smt
from simd_minimizers_tpu.hashers import NtHasher
from simd_minimizers_tpu.ops import backend as jbackend
from simd_minimizers_tpu.ops import fused as jfused
from simd_minimizers_tpu.ops import oracle
from simd_minimizers_tpu.parallel import multihost as jmultihost
from simd_minimizers_tpu.utils.bits import SKIPPED
from simd_minimizers_tpu_torch import convert
from simd_minimizers_tpu_torch.ops import backend, fused, pipeline
from simd_minimizers_tpu_torch.parallel import multihost

C = 1024
SKM = pipeline.MODE_SUPERKMERS
GEOMETRIES = [(5, 7, 12_000), (21, 11, 12_000), (21, 257, 20_000)]  # k, w, span chars


def _planes(x):
    """numpy uint32 planes of a result (tensor, array, or a tuple of them)."""
    xs = x if isinstance(x, tuple) else (x,)
    return [t.numpy().view(np.uint32) if isinstance(t, torch.Tensor) else t for t in xs]


def _assert_equal(got, want):
    for g, p in zip(_planes(got), _planes(want), strict=True):
        np.testing.assert_array_equal(g, p)


def _inputs(n, seed, bytes_in):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, n, dtype=np.uint8)
    mask = rng.random(n) < 0.01
    mask[n // 2 - 40:n // 2 + 40] = True  # a run of Ns across a seam or two
    chars = (convert.code_bytes(codes, "cpu") if bytes_in
             else convert.packed_words(smt.PackedSeqVec.from_codes(codes), "cpu"))
    return codes, mask, chars


@pytest.mark.parametrize("k,w,span", GEOMETRIES)
@pytest.mark.parametrize("mode", pipeline.MODES)
@pytest.mark.parametrize("masked", [False, True])
def test_sketch_long_vs_jax(k, w, span, mode, masked):
    """Every mode with and without a mask, on 2-bit packed input and on
    code bytes, across several seams (with Ns at one)."""
    n = 3 * span + 1234
    canonical = (k + w) % 2 == 0
    for bytes_in in (False, True):
        codes, mask, chars = _inputs(n, k * w + masked, bytes_in)
        plane = convert.ambiguity_plane(mask, n, "cpu") if masked else None
        before = dict(fused.LAUNCHES)
        got = fused.sketch_long(chars, n, k, w, smt.NtHasher(k, canonical=canonical), mode, plane,
                                byte_codes=bytes_in, span_chars=span)
        assert fused.LAUNCHES == before  # CPU tensors launch nothing
        want = jfused.sketch_long(codes, k, w, NtHasher(k, canonical=canonical), mode=mode,
                                  ambiguous_np=mask.astype(np.uint8) if masked else None, C=C,
                                  span_chars=span, interpret=True, dna=True)
        _assert_equal(got, want)
        if mode != SKM or not masked:
            sel = oracle.selected_stream(codes, k, w, NtHasher(k, canonical=canonical),
                                         ambiguous=mask if masked else None)
            if mode == SKM:
                ref = oracle.collect_and_dedup_with_index(sel)
            elif mode in pipeline.SYNCMER_MODES:
                ref = oracle.collect_syncmers(sel, w, mode == pipeline.MODE_OPEN_SYNCMERS)
            else:
                ref = oracle.collect_and_dedup(sel, skip_sentinel=masked)
            _assert_equal(got, ref)


@pytest.mark.parametrize("span", [700, 4096 + 30, 9000, 40_000])
def test_span_split_does_not_change_the_result(span):
    """Spans start at multiples of TILE windows; any span size (one launch
    included) gives the one-launch result."""
    k, w = 21, 11
    n = 30_000
    codes, mask, chars = _inputs(n, span, False)
    h = smt.NtHasher(k, canonical=True)
    plane = convert.ambiguity_plane(mask, n, "cpu")
    bounds = fused.span_bounds(n, k + w - 1, span)
    assert all(s % fused.TILE == 0 for s, _ in bounds)
    assert bounds[-1][0] + bounds[-1][1] == n and all(m <= max(span, 4096 + 30) for _, m in bounds)
    (kind, canonical, rot), tables = convert.hasher_tensors(h, "cpu")
    for mode in (pipeline.MODE_MINIMIZERS, SKM):
        got = fused.sketch_long(chars, n, k, w, h, mode, plane, span_chars=span)
        _assert_equal(got, fused.fused_sketch(chars, n, k, w, tables, rot, canonical, mode, plane))


@pytest.mark.parametrize("offset", [(1 << 31) + 12_345, (1 << 32) - 10**5])
@pytest.mark.parametrize("mode", [pipeline.MODE_MINIMIZERS, SKM, pipeline.MODE_CLOSED_SYNCMERS])
def test_offset_vs_jax(offset, mode):
    """The plain versions add the u32 offset to every value, as the JAX
    kernel's offset bits do."""
    k, w = 21, 11
    codes = np.random.default_rng(offset % 1000).integers(0, 4, 20_000, dtype=np.uint8)
    h = smt.NtHasher(k, canonical=True)
    (kind, canonical, rot), tables = convert.hasher_tensors(h, "cpu")
    chars = convert.code_bytes(codes, "cpu")
    got = fused.fused_sketch(chars, codes.size, k, w, tables, rot, canonical, mode,
                             offset=offset, byte_codes=True)
    want = jfused.fused_sketch(codes, k, w, NtHasher(k, canonical=True), mode=mode, C=C,
                               offset=offset, interpret=True, dna=True)
    _assert_equal(got, want)
    assert int(_planes(got)[0].max()) >= 1 << 31
    _assert_equal(pipeline.run_pipeline(chars, codes.size, k, w, tables, rot, canonical, mode,
                                        offset=offset, byte_codes=True), want)
    scratch, counts = fused.minimizer_tiles(chars, codes.size, k, w, tables, rot, canonical,
                                            mode, offset=offset, byte_codes=True)
    first = scratch.view(-1, counts.numel(), fused.TILE)[..., 0, 0]
    np.testing.assert_array_equal(first.numpy().view(np.uint32),
                                  [p[0] for p in _planes(want)])


@pytest.mark.parametrize("masked", [False, True])
def test_merge_and_seam_vs_jax(masked):
    """The port's copy of the seam merge (numpy parts and tensor parts)
    against the JAX package's, on shards cut at arbitrary windows."""
    k, w = 7, 5
    rng = np.random.default_rng(77 + masked)
    codes = rng.integers(0, 4, 5000, dtype=np.uint8)
    mask = (rng.random(5000) < 0.03).astype(np.uint8) if masked else None
    h, jh = smt.NtHasher(k, canonical=True), NtHasher(k, canonical=True)
    sel = oracle.selected_stream(codes, k, w, jh, ambiguous=mask)
    starts = [0, 1000, 1001, 2500, 4000]
    ends = starts[1:] + [sel.size]
    parts, idxs = [], []
    for s, e in zip(starts, ends):
        kept = np.ones(e - s, bool)
        kept[1:] = sel[s + 1:e] != sel[s:e - 1]
        if masked:
            kept &= sel[s:e] != SKIPPED
        parts.append(sel[s:e][kept])
        idxs.append((np.flatnonzero(kept) + s).astype(np.uint32))
    for win in (0, 999, 1000, 2499, sel.size - 1):
        assert multihost.seam_window_sel(codes, k, w, h, win, mask) == \
            jmultihost.seam_window_sel(codes, k, w, jh, win, mask)
    want = jmultihost.merge_adjacent_shards(parts, starts, codes, k, w, jh, mask, aux=idxs)
    _assert_equal(multihost.merge_adjacent_shards(parts, starts, codes, k, w, h, mask, aux=idxs),
                  want)
    as_tensors = [torch.from_numpy(p.view(np.int32)) for p in parts]
    _assert_equal(multihost.merge_adjacent_shards(as_tensors, starts, codes, k, w, h, mask),
                  want[0])


def test_superkmers_with_plane_vs_jax_backend():
    """backend.sketch with super-k-mers and a mask: the JAX package runs it
    below its builder, and the port now does too (packed and code bytes)."""
    rng = np.random.default_rng(1)
    codes = rng.integers(0, 4, 20_000, dtype=np.uint8)
    mask = rng.random(20_000) < 0.01
    for k, w, canonical in ((5, 7, True), (21, 11, False)):
        want = jbackend.sketch(codes, k, w, NtHasher(k, canonical=canonical), mode=SKM,
                               ambiguous_np=mask.astype(np.uint8))
        h = smt.NtHasher(k, canonical=canonical)
        plane = convert.ambiguity_plane(mask, codes.size, "cpu")
        words = convert.packed_words(smt.PackedSeqVec.from_codes(codes), "cpu")
        _assert_equal(backend.sketch(words, codes.size, k, w, h, SKM, plane), want)
        (kind, can, rot), tables = convert.hasher_tensors(h, "cpu")
        _assert_equal(fused.fused_sketch(convert.code_bytes(codes, "cpu"), codes.size, k, w,
                                         tables, rot, can, SKM, plane, byte_codes=True), want)


def test_u32_limits_raise():
    """Positions are u32: 2^32 chars raise the JAX package's AssertionError
    before anything is allocated or uploaded; one launch takes < 2^31."""
    h = smt.NtHasher(21, canonical=True)
    words = torch.zeros(8, dtype=torch.uint8)
    with pytest.raises(AssertionError, match="2\\^32"):
        fused.sketch_long(words, 1 << 32, 21, 11, h)
    with pytest.raises(AssertionError, match="2\\^32"):
        backend.sketch(words, 1 << 32, 21, 11, h)
    huge = smt.PackedSeq(np.broadcast_to(np.zeros(1, np.uint8), (1 << 30,)), 0, 1 << 32)
    with pytest.raises(AssertionError, match="2\\^32"):
        smt.canonical_minimizers(21, 11).run(huge, device="cpu")
    recs = [np.broadcast_to(np.zeros(1, np.uint8), (1 << 32,))]
    with pytest.raises(AssertionError, match="2\\^32"):
        fused.sketch_records(recs, 21, 11, h, device="cpu")
    (kind, can, rot), tables = convert.hasher_tensors(h, "cpu")
    with pytest.raises(AssertionError, match="2\\^31"):
        fused.minimizer_tiles(words, 1 << 31, 21, 11, tables, rot, can)
    with pytest.raises(ValueError, match="u32"):
        fused.minimizer_tiles(words, 30, 21, 11, tables, rot, can, offset=1 << 32)


def test_builder_routes_long_sequences(monkeypatch):
    """Builder.run sends n >= 2^30 chars to sketch_long (the threshold is
    lowered here), positions identical to the one-launch path."""
    seq = smt.PackedSeqVec.random(50_000, np.random.default_rng(5))
    mask = np.random.default_rng(6).random(50_000) < 0.005
    b = smt.canonical_minimizers(21, 11)
    want = b.run(seq, ambiguous=mask, device="cpu").positions
    calls = []
    real = fused.sketch_long

    def spy(*args, **kw):
        calls.append(args[1])
        return real(*args, **{**kw, "span_chars": 12_000})

    monkeypatch.setattr(backend, "LONG_SEQUENCE_CHARS", 40_000)
    monkeypatch.setattr(fused, "sketch_long", spy)
    got = b.run(seq, ambiguous=mask, device="cpu")
    assert calls == [50_000]
    np.testing.assert_array_equal(got.positions, want)
    np.testing.assert_array_equal(got.positions, b.run_scalar(seq, ambiguous=mask).positions)
