"""The port's `ShortSeqSketcher` on the CPU (the kernels' plain versions, no
graph) == the JAX package's `ShortSeqSketcher(..., interpret=True)` == the
NumPy oracle: `sketch`, the pipelined `sketch_many`, super-k-mers, the
`max_chars` refusal and the empty result below one window. The captured
graph itself runs on a card (tests/test_torch_cuda.py, chip_smoke.py).
Integer outputs: tolerance 0.
"""

import numpy as np
import pytest

from simd_minimizers_tpu.hashers import NtHasher
from simd_minimizers_tpu.ops import oracle
from simd_minimizers_tpu.ops.device_sketcher import ShortSeqSketcher as JaxSketcher
from simd_minimizers_tpu_torch import convert
from simd_minimizers_tpu_torch.ops import fused, pipeline
from simd_minimizers_tpu_torch.ops.device_sketcher import ShortSeqSketcher


def _want(s, k, w, h, mode=pipeline.MODE_MINIMIZERS):
    if s.size < k + w - 1:
        empty = np.zeros(0, np.uint32)
        return (empty, empty) if mode == pipeline.MODE_SUPERKMERS else empty
    sel = oracle.selected_stream(s, k, w, h)
    if mode == pipeline.MODE_SUPERKMERS:
        return oracle.collect_and_dedup_with_index(sel)
    if mode in pipeline.SYNCMER_MODES:
        return oracle.collect_syncmers(sel, w, mode == pipeline.MODE_OPEN_SYNCMERS)
    return oracle.collect_and_dedup(sel)


def test_matches_jax_and_oracle():
    """test_drivers.py's case: canonical k=21 w=11, lengths 30 to 8192,
    one at a time and pipelined."""
    rng = np.random.default_rng(0xD5)
    k, w = 21, 11
    h = NtHasher(k, canonical=True)
    sk = ShortSeqSketcher(k, w, convert.hasher_from(h), device="cpu")
    ref = JaxSketcher(k, w, h, interpret=True)
    assert sk.max_chars == ref.max_chars == 8192 + k + w - 2
    seqs = [rng.integers(0, 4, n, dtype=np.uint8) for n in (30, 31, 64, 1024, 8192)]
    before = dict(fused.LAUNCHES)
    for s in seqs:
        got = sk.sketch(s)
        assert got.dtype == np.uint32
        np.testing.assert_array_equal(got, ref.sketch(s))
        np.testing.assert_array_equal(got, _want(s, k, w, h))
    for got, s in zip(sk.sketch_many(seqs), seqs, strict=True):
        np.testing.assert_array_equal(got, _want(s, k, w, h))
    assert fused.LAUNCHES == before  # the CPU runs the plain versions


def test_superkmers():
    rng = np.random.default_rng(0xD6)
    k, w = 5, 7
    h = NtHasher(k, canonical=True)
    sk = ShortSeqSketcher(k, w, convert.hasher_from(h), mode=pipeline.MODE_SUPERKMERS,
                          device="cpu")
    codes = rng.integers(0, 4, 2000, dtype=np.uint8)
    got = sk.sketch(codes)
    want = JaxSketcher(k, w, h, mode="superkmers", interpret=True).sketch(codes)
    for g, p, o in zip(got, want, _want(codes, k, w, h, pipeline.MODE_SUPERKMERS), strict=True):
        np.testing.assert_array_equal(g, p)
        np.testing.assert_array_equal(g, o)


@pytest.mark.parametrize("mode", [pipeline.MODE_CLOSED_SYNCMERS, pipeline.MODE_OPEN_SYNCMERS])
def test_syncmers_and_offset(mode):
    """Syncmers, and the offset added to every value (u32 wrap)."""
    k, w = 21, 11
    h = NtHasher(k)
    sk = ShortSeqSketcher(k, w, convert.hasher_from(h), mode=mode, device="cpu")
    codes = np.random.default_rng(8).integers(0, 4, 5000, dtype=np.uint8)
    want = _want(codes, k, w, h, mode)
    np.testing.assert_array_equal(sk.sketch(codes), want)
    offset = (1 << 32) - 100
    got = sk.harvest(sk.launch(codes, offset=offset))
    np.testing.assert_array_equal(got, (want.astype(np.uint64) + offset).astype(np.uint32))


def test_max_chars_and_short_inputs():
    """Inputs past max_chars raise the JAX package's AssertionError; below
    one window the result is empty (a pair for super-k-mers)."""
    h = convert.hasher_from(NtHasher(21, canonical=True))
    for mode in (pipeline.MODE_MINIMIZERS, pipeline.MODE_SUPERKMERS):
        sk = ShortSeqSketcher(21, 11, h, mode=mode, C=128, device="cpu")
        assert sk.max_chars == 8 * 128 + 30
        with pytest.raises(AssertionError, match="handles up to"):
            sk.launch(np.zeros(sk.max_chars + 1, np.uint8))
        assert sk.launch(np.zeros(30, np.uint8)) is None
        got = sk.sketch(np.zeros(0, np.uint8))
        if mode == pipeline.MODE_SUPERKMERS:
            assert len(got) == 2 and all(g.size == 0 and g.dtype == np.uint32 for g in got)
        else:
            assert got.size == 0 and got.dtype == np.uint32
        codes = np.random.default_rng(1).integers(0, 4, sk.max_chars, dtype=np.uint8)
        for g, p in zip(sk.sketch(codes) if mode == pipeline.MODE_SUPERKMERS
                        else (sk.sketch(codes),),
                        _want(codes, 21, 11, h, mode) if mode == pipeline.MODE_SUPERKMERS
                        else (_want(codes, 21, 11, h, mode),), strict=True):
            np.testing.assert_array_equal(g, p)


def test_measure_floor_needs_a_card():
    sk = ShortSeqSketcher(5, 7, convert.hasher_from(NtHasher(5)), device="cpu")
    with pytest.raises(RuntimeError, match="measures the card"):
        sk.measure_floor(np.zeros(100, np.uint8))
    with pytest.raises(ValueError):
        ShortSeqSketcher(5, 7, convert.hasher_from(NtHasher(6)), device="cpu")
